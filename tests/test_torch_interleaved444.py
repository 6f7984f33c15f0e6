"""PyTorch port, interleaved 4:4:4 encode (the JAX package's interleaved
megakernel mode, entropy_fused_u8_il): the bytes equal the JAX package's
encoder on the CPU, and the port's stream decodes to the JAX package's
pixels (the plain coder against the megakernel in interpret mode:
test_torch_entropy_modes.py; on the card: test_torch_kernels.py)."""

import numpy as np
import pytest

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt

from .test_torch_encode import _gradient
from .test_torch_interleaved_decode import check_decode
from tests import torch_threads  # noqa: F401


def _noise(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _params(mod, quality, rst):
    return mod.Parameters(quality=quality, restart_interval=rst,
                          interleaved=True)


#: (frame, quality, restart interval): auto is 8 // 3 = 2 MCUs a segment;
#: 41x67 has 6 x 9 = 54 MCUs a component, odd-sized edges, and at an
#: interval of 4 a ragged last segment (the JAX megakernel refuses it,
#: mega_il_supported; the port does not)
CASES = {
    "gradient_48x64_q75": (lambda: _gradient(48, 64, 11), 75, -1),
    "odd_41x67_q90_rst4": (lambda: _gradient(41, 67, 12), 90, 4),
    "noise_64x64_q75": (lambda: _noise(64, 64, 13), 75, -1),
    "noise_40x48_q100_rst2": (lambda: _noise(40, 48, 14), 100, 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_interleaved_444_bytes_match_jax(name):
    make, quality, rst = CASES[name]
    frame = make()
    ref = bytes(gj.Encoder().encode(frame, _params(gj, quality, rst)))
    got = gt.Encoder(device="cpu").encode(frame, _params(gt, quality, rst))
    assert got[:2] == b"\xff\xd8" and got[-2:] == b"\xff\xd9"
    assert got == ref


def test_port_444_stream_decodes_like_jax():
    """The port's interleaved 4:4:4 stream decodes to the JAX package's
    pixels and coefficients on both decoders."""
    data = gt.Encoder(device="cpu").encode(_gradient(41, 67, 16),
                                           _params(gt, 85, 3))
    check_decode(data)
