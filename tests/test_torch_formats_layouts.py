"""PyTorch port, encode of the component counts and samplings beyond
4:4:4 to 4:2:0, on the CPU: the bytes equal the JAX package's,
tolerance 0 — RGB at comp_count=1 (channel 0, unconverted, as the JAX
package encodes it), greyscale at comp_count=3 (chroma 128), 4:1:1 in
non-interleaved and interleaved scans, an interleaved scan with
subsampled chroma ((2, 2), (2, 1), (2, 1): 8 blocks an MCU)."""

import pytest

from .test_torch_formats_encode import encode_both, jenc  # noqa: F401
from tests import torch_threads  # noqa: F401

S411 = ((4, 1), (1, 1), (1, 1))

CASES = {"rgb_comp1": ("rgb", ((1, 1),), False),
         "grey_comp3": ("u8", ((1, 1),) * 3, False),
         "planar_411": ("rgb", S411, False),
         "il_411": ("rgb", S411, True),
         "il_2221": ("rgb", ((2, 2), (2, 1), (2, 1)), True)}


@pytest.mark.parametrize("case", list(CASES))
def test_layout_bytes_match_jax(jenc, case):  # noqa: F811
    kind, samp, il = CASES[case]
    want, got = encode_both(jenc, kind, samp, il, seed=len(case))
    assert got == want
