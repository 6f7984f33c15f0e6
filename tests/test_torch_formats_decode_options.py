"""PyTorch port, decode of interleaved 4:2:2 and PIL greyscale streams
to the output formats, and the decoder's row alignment, flip and channel
remap options, on the CPU: the arrays equal the JAX package's, tolerance
0 and the same shape (padded rows are (H, row stride) bytes, as
there)."""

import io

import numpy as np
import pytest

from tests import format_cases as fc

from .test_torch_formats_decode import decode_both, make_stream
from tests import torch_threads  # noqa: F401

STREAMS = {"il_422": ("rgb", ((2, 1), (1, 1), (1, 1)), True)}


@pytest.fixture(scope="module")
def streams():
    out = {k: make_stream(*v, seed=len(k)) for k, v in STREAMS.items()}
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(fc.gradient(40, 56, 1, seed=3)[..., 0]).save(
        buf, "JPEG", quality=80)
    out["pil_grey"] = buf.getvalue()
    return out


@pytest.mark.parametrize("name", fc.OUTPUTS + ["STD", "NATIVE"])
@pytest.mark.parametrize("stream", ["il_422", "pil_grey"])
def test_subsampled_output_matches_jax(streams, stream, name):
    want, got = decode_both(streams[stream], name,
                            cs="YCBCR_BT601_256LVLS" if name == "STD"
                            else "RGB")
    assert got.shape == want.shape and np.array_equal(got, want)


#: (options, output) cases: row alignment pads the packed formats' rows
#: (not the planar ones), a flip reverses the rows of (H, W[, C]) images
#: (not flat buffers), a remap rebuilds (H, W, C) images only
OPTION_CASES = {
    "align16_rgb": ([("dec_opt_alignment_bytes", "16")], "P444_U8_P012"),
    "align64_grey": ([("dec_opt_alignment_bytes", "64")], "U8"),
    "align64_uyvy": ([("dec_opt_alignment_bytes", "64")], "P422_U8_P1020"),
    "align64_planar": ([("dec_opt_alignment_bytes", "64")],
                       "P420_U8_P0P1P2"),
    "flip_rgba": ([("dec_opt_flipped", "true")], "P4444_U8_P0123"),
    "flip_planar": ([("dec_opt_flipped", "true")], "P420_U8_P0P1P2"),
    "remap_rgb": ([("dec_opt_channel_remap", "2F0Z")], "P444_U8_P012"),
    "remap_grey": ([("dec_opt_channel_remap", "0F")], "U8"),
    "all_rgb": ([("dec_opt_flipped", "true"),
                 ("dec_opt_channel_remap", "10"),
                 ("dec_opt_alignment_bytes", "32")], "P444_U8_P012"),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_output_options_match_jax(streams, case):
    options, name = OPTION_CASES[case]
    want, got = decode_both(streams["il_422"], name, options)
    assert got.shape == want.shape and np.array_equal(got, want)
