"""PyTorch port, whole encode: byte-identical to the JAX package's encoder
on the CPU (on the card: test_torch_kernels.py)."""

import io

import numpy as np
import pytest
import torch

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt


def _gradient(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([(xx * 255 // w), (yy * 255 // h),
                  ((xx + yy) * 255 // (w + h))], -1)
    return np.clip(f + rng.integers(-12, 12, f.shape), 0, 255) \
        .astype(np.uint8)


FRAMES = {
    "gradient_320x240": lambda: _gradient(240, 320, 0),
    "odd_311x233": lambda: _gradient(233, 311, 1),
    "noise_64x64": lambda: np.random.default_rng(2).integers(
        0, 256, (64, 64, 3), dtype=np.uint8),
    "grey": lambda: np.full((48, 80, 3), 128, np.uint8),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_encode_bytes_match_jax(name):
    frame = FRAMES[name]()
    ref = gj.Encoder().encode(
        frame, gj.Parameters(quality=75, restart_interval=gj.RESTART_AUTO))
    got = gt.Encoder(device="cpu").encode(
        frame, gt.Parameters(quality=75, restart_interval=gt.RESTART_AUTO))
    assert got == ref
    assert got[:2] == b"\xff\xd8" and got[-2:] == b"\xff\xd9"


def test_encode_decodes_with_pil():
    from PIL import Image

    frame = _gradient(120, 160, 4)
    out = gt.Encoder(device="cpu").encode(
        torch.from_numpy(frame), gt.Parameters(quality=90))
    arr = np.asarray(Image.open(io.BytesIO(out)).convert("RGB"))
    mse = np.mean((frame.astype(float) - arr.astype(float)) ** 2)
    assert 10 * np.log10(255 ** 2 / mse) > 30
