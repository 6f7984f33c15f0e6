"""PyTorch port, parallel/ (encode): BatchEncoder on CPU meshes
(make_mesh(..., device="cpu"), every place the CPU) against the JAX
package's sessions on the 8-device virtual CPU mesh of conftest.py.

Streams are byte for byte gpujpeg_tpu.Encoder().encode's at data 4 x seg
2 and data 1 x seg 8, and gpujpeg_tpu.parallel.BatchEncoder's in one case
of each; the two cases where the JAX BatchEncoder's bytes are not its
Encoder's (ROADMAP queue 3 Q11: a flat planar frame cut into equal byte
chunks at seg > 1; Q12: no segment-info headers) are held to the JAX
BatchEncoder's.  The stripe geometry helpers equal the JAX functions over
a grid.  Frames of at most 64 x 64; the layouts and the 16K-width stripe
case are in test_torch_parallel_layouts.py."""

import numpy as np
import pytest

import gpujpeg_tpu as gj
from gpujpeg_tpu.parallel import batch as jbatch, mesh as jmesh
from gpujpeg_tpu.types import image_size_bytes as j_image_size_bytes
from gpujpeg_tpu.models.encoder import adjust_params as j_adjust_params
from gpujpeg_tpu.utils.geometry import get_geometry as j_get_geometry

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.models.encoder import adjust_params
from gpujpeg_tpu_torch.parallel import batch as tbatch, mesh as tmesh
from gpujpeg_tpu_torch.utils.geometry import get_geometry

from .test_torch_encode import _gradient

S420 = ((2, 2), (1, 1), (1, 1))


def _pi(mod, h, w, pf="P444_U8_P012", cs="RGB"):
    return mod.ImageParameters(width=w, height=h,
                               color_space=mod.ColorSpace[cs],
                               pixel_format=mod.PixelFormat[pf])


def _params(mod, quality=85, rst=8, il=False, samp=None, tables="tuned",
            **kw):
    p = mod.Parameters(quality=quality, restart_interval=rst,
                       interleaved=il, huffman_tables=tables, **kw)
    return p.chroma_subsampled(samp) if samp else p


def _frames(n, h=64, w=64):
    return np.stack([_gradient(h, w, 40 + i) for i in range(n)])


def _jax_encodes(frames, kw, pi_args=()):
    enc = gj.Encoder()
    return [bytes(enc.encode(f, _params(gj, **kw), _pi(gj, *pi_args)))
            for f in frames]


@pytest.fixture(scope="module")
def jax_data4_seg2():
    """The JAX BatchEncoder's streams of 4 frames at data 4 x seg 2."""
    frames = _frames(4)
    be = jbatch.BatchEncoder(jmesh.make_mesh(8, data=4, seg=2),
                             _params(gj), _pi(gj, 64, 64))
    return frames, [bytes(s) for s in be.encode_batch(frames)]


@pytest.mark.parametrize("layout", [
    dict(), dict(samp=S420), dict(il=True, samp=S420), dict(il=True),
    dict(samp=((2, 1), (1, 1), (1, 1)), il=True)],
    ids=["planar_444", "planar_420", "il_420", "il_444", "il_422"])
def test_stripe_geometry_matches_jax(layout):
    """stripe_alignment, shardable and feasible_seg_shards equal the JAX
    functions over sizes, restart intervals and shard counts."""
    n = 0
    for h, w in ((64, 64), (48, 80), (128, 15360), (96, 40), (57, 71)):
        for rst in (0, 1, 2, 3, 4, 8, 16):
            kw = dict(layout, rst=rst)
            p_t = adjust_params(_params(gt, **kw), _pi(gt, h, w))
            p_j = j_adjust_params(_params(gj, **kw), _pi(gj, h, w))
            geo_t = get_geometry(p_t, _pi(gt, h, w))
            geo_j = j_get_geometry(p_j, _pi(gj, h, w))
            assert tbatch.stripe_alignment(geo_t) == \
                jbatch.stripe_alignment(geo_j)
            for s in (1, 2, 3, 4, 8):
                assert tbatch.shardable(geo_t, s) == \
                    jbatch.shardable(geo_j, s)
                assert tbatch.feasible_seg_shards(geo_t, s) == \
                    jbatch.feasible_seg_shards(geo_j, s)
                n += tbatch.shardable(geo_t, s)
    assert n > 10


def test_batch_encode_data4_seg2(jax_data4_seg2):
    """4 frames over 'data', 2 stripes a frame over 'seg': each stream is
    the JAX Encoder's and the JAX BatchEncoder's."""
    frames, want = jax_data4_seg2
    be = tbatch.BatchEncoder(tmesh.make_mesh(8, data=4, seg=2,
                                             device="cpu"),
                             _params(gt), _pi(gt, 64, 64))
    assert be.geo_local.param_image.height == 32
    got = be.encode_batch(frames)
    assert got == want
    assert got == _jax_encodes(frames, {}, (64, 64))


def test_batch_encode_data1_seg8():
    """Pure segment sharding, 8 stripes of one row of segments: the JAX
    Encoder's and the JAX BatchEncoder's bytes."""
    frames = _frames(1)
    got = tbatch.BatchEncoder(
        tmesh.make_mesh(8, data=1, seg=8, device="cpu"), _params(gt),
        _pi(gt, 64, 64)).encode_batch(frames)
    want = jbatch.BatchEncoder(jmesh.make_mesh(8, data=1, seg=8),
                               _params(gj), _pi(gj, 64, 64)
                               ).encode_batch(frames)
    assert got == [bytes(s) for s in want]
    assert got == _jax_encodes(frames, {}, (64, 64))


@pytest.mark.parametrize("il", [False, True])
def test_restart0_seg1_equals_encode(il):
    """At restart interval 0 (no stripes) each frame's scan tokens are
    queued on its place (no device rows) and packed on the host, as
    Encoder.encode packs them: the JAX Encoder's bytes, planar and
    interleaved."""
    frames = _frames(2, 32, 48)
    kw = dict(rst=0, il=il)
    be = tbatch.BatchEncoder(
        tmesh.make_mesh(2, data=2, seg=1, device="cpu"), _params(gt, **kw),
        _pi(gt, 32, 48))
    queued = be.fn(list(frames))
    assert all(set(res) == {"tokens", "done"}
               for parts in queued for _dev, res in parts)
    assert be._streams(queued) == _jax_encodes(frames, kw, (32, 48))


def test_refusals_match_jax():
    """A geometry that does not stripe into whole segments, and a batch
    the 'data' extent does not divide, raise ValueError on both sides."""
    with pytest.raises(ValueError, match="row-shardable"):
        jbatch.BatchEncoder(jmesh.make_mesh(8, data=1, seg=8),
                            _params(gj, samp=S420), _pi(gj, 64, 64))
    with pytest.raises(ValueError, match="row-shardable"):
        tbatch.BatchEncoder(tmesh.make_mesh(8, data=1, seg=8, device="cpu"),
                            _params(gt, samp=S420), _pi(gt, 64, 64))
    be = tbatch.BatchEncoder(tmesh.make_mesh(4, data=4, seg=1, device="cpu"),
                             _params(gt), _pi(gt, 64, 64))
    with pytest.raises(ValueError, match="not divisible"):
        be.encode_batch(_frames(3))


def test_q11_flat_planar_seg2():
    """Q11: a flat P420 frame at seg 2 is cut into two equal byte chunks
    (the JAX in_specs P("data", "seg") on a flat buffer), not into
    stripes of each plane, so its stream is not Encoder.encode's.  The
    port writes the JAX BatchEncoder's bytes; a UYVY frame, whose rows
    are its bytes in order, stripes rightly and equals encode."""
    rng = np.random.default_rng(7)
    n = j_image_size_bytes(64, 64, gj.PixelFormat.P420_U8_P0P1P2)
    frames = rng.integers(0, 256, (2, n), np.uint8)
    args = (64, 64, "P420_U8_P0P1P2", "YCBCR_BT601")
    kw = dict(quality=75, rst=4)
    want = jbatch.BatchEncoder(jmesh.make_mesh(4, data=2, seg=2),
                               _params(gj, **kw), _pi(gj, *args)
                               ).encode_batch(frames)
    got = tbatch.BatchEncoder(tmesh.make_mesh(4, data=2, seg=2,
                                              device="cpu"),
                              _params(gt, **kw), _pi(gt, *args)
                              ).encode_batch(frames)
    assert got == [bytes(s) for s in want]
    enc = gt.Encoder(device="cpu")
    assert all(g != enc.encode(f, _params(gt, **kw), _pi(gt, *args))
               for g, f in zip(got, frames))
    n = j_image_size_bytes(64, 32, gj.PixelFormat.P422_U8_P1020)
    uyvy = rng.integers(0, 256, (2, n), np.uint8)
    args = (32, 64, "P422_U8_P1020", "YCBCR_BT601")
    got = tbatch.BatchEncoder(tmesh.make_mesh(4, data=2, seg=2,
                                              device="cpu"),
                              _params(gt, **kw), _pi(gt, *args)
                              ).encode_batch(uyvy)
    assert got == [enc.encode(f, _params(gt, **kw), _pi(gt, *args))
                   for f in uyvy]


def test_q12_segment_info(jax_data4_seg2):
    """Q12: the stitch writes no segment-info headers, on both sides:
    with segment_info=True the port's BatchEncoder writes the JAX
    BatchEncoder's bytes, which lack Encoder.encode's APP13 headers."""
    frames, want = jax_data4_seg2
    be = tbatch.BatchEncoder(tmesh.make_mesh(8, data=4, seg=2,
                                             device="cpu"),
                             _params(gt, segment_info=True),
                             _pi(gt, 64, 64))
    got = be.encode_batch(frames)
    assert got == want
    assert all(b"\xff\xed" not in s for s in got)
    single = gt.Encoder(device="cpu").encode(
        frames[0], _params(gt, segment_info=True), _pi(gt, 64, 64))
    assert b"\xff\xed" in single and single != got[0]


def test_mesh_places():
    """A mesh's places are distinct entries even where they share a
    torch device; the descriptors name their axes."""
    m = tmesh.make_mesh(8, data=4, seg=2, device="cpu")
    assert m.shape == {"data": 4, "seg": 2}
    assert m.axis_names == ("data", "seg")
    flat = list(m.devices.reshape(-1))
    assert len(set(flat)) == 8
    assert {d.device.type for d in flat} == {"cpu"}
    assert tmesh.frame_sharding(m).spec == ("data",)
    assert tmesh.replicated(m).spec == ()
    assert tmesh.make_mesh(4, seg=2, device="cpu").shape == {"data": 2,
                                                             "seg": 2}
