"""PyTorch port, parallel/ (encode layouts): BatchEncoder on CPU meshes
in planar 4:2:0, interleaved 4:2:0 and with Annex-K tables at seg 2, and
a 16K-wide frame (128 x 15360) striped 8 ways, each stream byte for byte
gpujpeg_tpu.Encoder().encode's."""

import numpy as np
import pytest

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.parallel import batch as tbatch, mesh as tmesh

from .test_torch_parallel import S420, _frames, _jax_encodes, _params, _pi


@pytest.mark.parametrize("layout", [
    dict(samp=S420, rst=4), dict(il=True, samp=S420, rst=4),
    dict(tables="annexk"), dict(tables="annexk", il=True, samp=S420,
                                rst=2)],
    ids=["planar_420", "il_420", "annexk_444", "annexk_il_420"])
def test_batch_encode_layouts_seg2(layout):
    """Planar 4:2:0, interleaved 4:2:0 and Annex-K tables at data 2 x
    seg 2: the JAX Encoder's bytes."""
    frames = _frames(2, 64, 64)
    got = tbatch.BatchEncoder(
        tmesh.make_mesh(4, data=2, seg=2, device="cpu"),
        _params(gt, **layout), _pi(gt, 64, 64)).encode_batch(frames)
    assert got == _jax_encodes(frames, layout, (64, 64))


def test_16k_width_sharded_equals_single():
    """A 16K-WIDTH frame (15360 px rows, 1920 luma blocks a row) striped
    8 ways at restart 16, as tests/test_parallel.py's case: the JAX
    Encoder's bytes."""
    H, W = 128, 15360
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([(xx * 255 // W), (yy * 255 // H),
                    ((xx + yy) * 255 // (W + H))], -1).astype(np.uint8)
    kw = dict(quality=75, rst=16)
    got = tbatch.BatchEncoder(
        tmesh.make_mesh(8, data=1, seg=8, device="cpu"), _params(gt, **kw),
        _pi(gt, H, W)).encode_batch(img[None])[0]
    assert got == _jax_encodes(img[None], kw, (H, W))[0]
