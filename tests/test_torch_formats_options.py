"""PyTorch port, the encoder's flip and channel-remap options on the
CPU: the bytes equal the JAX package's with the same options set on
both sessions, tolerance 0 — a flipped RGB frame, a remap with all-ones
and all-zeros channels, a flipped greyscale (H, W) frame, a flat UYVY
buffer with flip set (never flipped: the JAX package flips 2-D and 3-D
arrays only) and a 4-character remap of an RGB frame (whose 4th channel
a 3-component encode does not read; the JAX package's CPU route takes it,
its TPU preprocessor kernel would not: ROADMAP queue 3)."""

import pytest

from .test_torch_formats_encode import encode_both, jenc  # noqa: F401
from tests import torch_threads  # noqa: F401

CASES = {
    "flip_rgb": ("rgb", [("enc_opt_flipped", "true")]),
    "remap_fz": ("rgb", [("enc_opt_channel_remap", "F1Z")]),
    "flip_grey": ("u8", [("enc_opt_flipped", "true")]),
    "flip_flat_uyvy": ("uyvy", [("enc_opt_flipped", "true")]),
    "remap_four_of_rgb": ("rgb", [("enc_opt_flipped", "true"),
                                  ("enc_opt_channel_remap", "210F")]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_option_bytes_match_jax(jenc, case):  # noqa: F811
    kind, options = CASES[case]
    want, got = encode_both(jenc, kind, options=options, seed=len(case))
    assert got == want
