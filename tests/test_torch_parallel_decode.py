"""PyTorch port, parallel/ (decode): ShardedDecoder on CPU meshes
against gpujpeg_tpu.Decoder().decode, and its refusals against the JAX
class's on the 8-device virtual CPU mesh of conftest.py.  Streams written
by the JAX package; frames of at most 64 x 64.  BatchDecoder is in
test_torch_parallel_batchdec.py."""

import numpy as np
import pytest

import gpujpeg_tpu as gj
from gpujpeg_tpu.models.decoder import CapacityError as JCapacityError
from gpujpeg_tpu.parallel import batch as jbatch, mesh as jmesh

from gpujpeg_tpu_torch.models.decoder import CapacityError
from gpujpeg_tpu_torch.parallel import batch as tbatch, mesh as tmesh

from .test_encode import smooth_image
from .test_torch_parallel import S420, _params, _pi
from tests import torch_threads  # noqa: F401


#: one session of each JAX class for the file: a session keeps its
#: compiled programs, so each geometry compiles once
_JAX = {}


def _jax(cls):
    if cls not in _JAX:
        _JAX[cls] = getattr(gj, cls)()
    return _JAX[cls]


def _jax_stream(img, **kw):
    h, w = img.shape[:2]
    return bytes(_jax("Encoder").encode(img, _params(gj, **kw),
                                        _pi(gj, h, w)))


def _jax_decode(data):
    return np.asarray(_jax("Decoder").decode(data))


@pytest.mark.parametrize("samp", [None, S420], ids=["planar_444",
                                                    "planar_420"])
def test_sharded_decoder_matches_jax(samp):
    """Four stripes of one frame's segment rows, each decoded through a
    stripe-local plan, concatenate to the JAX Decoder's pixels, for a
    second stream of the same geometry too."""
    rng = np.random.default_rng(21)
    h, w = 64, 48 if samp is None else 64
    kw = dict(rst=2, samp=samp)
    streams = [_jax_stream(rng.integers(0, 256, (h, w, 3), np.uint8)
                           if samp is None else smooth_image(rng, h, w, 3),
                           **kw) for _ in range(2)]
    sd = tbatch.ShardedDecoder(tmesh.make_mesh(4, data=1, seg=4,
                                               device="cpu"), streams[0])
    assert sd.geo_l.param_image.height == h // 4
    for data in streams:
        got = sd.decode(data)
        assert got.shape == (h, w, 3)
        assert np.array_equal(got, _jax_decode(data))


def test_sharded_decoder_refusals_match_jax():
    """An interleaved stream is refused at construction, and a denser
    stream by pack, on both sides, with the JAX classes' exception
    types."""
    rng = np.random.default_rng(22)
    il = _jax_stream(smooth_image(rng, 64, 64, 3), rst=2, il=True,
                     samp=S420)
    jm = jmesh.make_mesh(2, data=1, seg=2)
    tm = tmesh.make_mesh(2, data=1, seg=2, device="cpu")
    with pytest.raises(ValueError, match="non-interleaved"):
        jbatch.ShardedDecoder(jm, il)
    with pytest.raises(ValueError, match="non-interleaved"):
        tbatch.ShardedDecoder(tm, il)
    smooth = _jax_stream(smooth_image(rng, 64, 48, 3), quality=50, rst=2)
    dense = _jax_stream(rng.integers(0, 256, (64, 48, 3), np.uint8),
                        quality=95, rst=2)
    with pytest.raises((JCapacityError, ValueError)) as want:
        jbatch.ShardedDecoder(jm, smooth).pack(dense)
    with pytest.raises((CapacityError, ValueError)) as got:
        tbatch.ShardedDecoder(tm, smooth).pack(dense)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
