"""PyTorch port, interleaved encode at 4:2:2 and 4:4:0: the bytes equal the
JAX package's encoder on the CPU (4:2:0 and the refusals:
test_torch_interleaved_encode.py)."""

import pytest

from .test_torch_interleaved_encode import CASES, check_bytes

SAMPLINGS = {"422": ((2, 1), (1, 1), (1, 1)),
             "440": ((1, 2), (1, 1), (1, 1))}


@pytest.mark.parametrize("samp", list(SAMPLINGS))
@pytest.mark.parametrize("name,quality,rst",
                         [c for c in CASES if c[1:] != (75, -1)
                          or c[0] != "odd_311x233"])
def test_interleaved_bytes_match_jax(samp, name, quality, rst):
    check_bytes(SAMPLINGS[samp], name, quality, rst)
