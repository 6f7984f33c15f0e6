"""PyTorch port, encode of the planar input formats (P444, P422 and
P420 at libyuv plane sizes, each at its own sampling, one at an odd
size) and of RGBA at 4 components in non-interleaved and interleaved
scans, on the CPU: the bytes equal the JAX package's, tolerance 0."""

import pytest

from .test_torch_formats_encode import encode_both, jenc  # noqa: F401
from tests import torch_threads  # noqa: F401


@pytest.mark.parametrize("kind,hw", [("p444", (48, 64)), ("p422", (48, 64)),
                                     ("p420", (37, 45))])
def test_planar_input_bytes_match_jax(jenc, kind, hw):  # noqa: F811
    want, got = encode_both(jenc, kind, hw=hw, seed=7)
    assert got == want


@pytest.mark.parametrize("interleaved", [False, True])
def test_four_components_bytes_match_jax(jenc, interleaved):  # noqa: F811
    """RGBA at 4 components: the 4th the raw alpha, in its own scan or
    interleaved (4 blocks an MCU)."""
    want, got = encode_both(jenc, "rgba", interleaved=interleaved, seed=8)
    assert got == want
