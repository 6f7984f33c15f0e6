"""PyTorch port, decode of a 4:4:4 stream (the fused dpost route for RGB
and RGBA, the IDCT planes and the postprocessor for every other output)
and of a planar 4:2:0 one to every output format and pseudo request on
the CPU: the arrays equal the JAX package's, tolerance 0 and the same
shape."""

import numpy as np
import pytest

from tests import format_cases as fc

from .test_torch_formats_decode import REQUESTS, decode_both, make_stream
from tests import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def streams():
    return {"rgb444": make_stream("rgb", seed=6),
            "planar_420": make_stream("rgb", ((2, 2), (1, 1), (1, 1)),
                                      seed=10)}


@pytest.mark.parametrize("name", REQUESTS)
def test_444_output_matches_jax(streams, name):
    want, got = decode_both(streams["rgb444"], name)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("name", fc.OUTPUTS + ["STD", "NATIVE"])
def test_planar_420_output_matches_jax(streams, name):
    want, got = decode_both(streams["planar_420"], name,
                            cs="YCBCR_BT601_256LVLS" if name == "STD"
                            else "RGB")
    assert got.shape == want.shape and np.array_equal(got, want)
