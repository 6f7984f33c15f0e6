"""One intra-op thread for torch in the port's CPU tests.

pytest-xdist runs the tests in several worker processes at once, and
torch would start one intra-op thread a core in each of them.  On a busy
machine the plain versions' many small tensor operations then wait on
one another's threads: the canonical decode of all 65,536 16-bit peeks
of one table (huffdec_kernel._decode_token) took 0.9 s on 8 threads of
an 8-core machine beside five busy workers, and 0.017 s on one thread.
Every port test file that runs torch on the CPU imports this module,
which sets one thread for its process.  The card tests
(tests/test_torch_kernels*.py) keep torch's default."""

import torch

torch.set_num_threads(1)
