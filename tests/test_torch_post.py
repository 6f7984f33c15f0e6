"""PyTorch port, the interleaved decode tail: the plain postprocessor
(ops/sample.postprocess: nearest chroma upsampling, colour, the interleaved
store) against the JAX package's Pallas postprocessor in interpret mode and
its XLA postprocessor; the plain IDCT to planes against the planes of the
JAX package's interleaved tail (_make_idct_post_fn_t_il).  The CUDA
kernels are held against the plain versions in test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gpujpeg_tpu as gj
from gpujpeg_tpu.models import decoder as jdec
from gpujpeg_tpu.ops import prepost_kernel as jpre
from gpujpeg_tpu.ops import sample as jsample

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.models import decoder as tdec
from gpujpeg_tpu_torch.ops import prepost_kernel as tpre
from gpujpeg_tpu_torch.ops import sample as tsample

from .test_torch_encode import _gradient
from tests import torch_threads  # noqa: F401

SAMP = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
        "440": ((1, 2), (1, 1), (1, 1)), "444": ((1, 1), (1, 1), (1, 1))}


def _geos(samp, h, w):
    """The JAX and the port geometry of one interleaved frame, and the
    RGB output of each."""
    frame = np.zeros((h, w, 3), np.uint8)
    geos = []
    for mod, enc in ((gj, gj.Encoder()), (gt, gt.Encoder(device="cpu"))):
        p = mod.Parameters(quality=75, restart_interval=-1,
                           interleaved=True).chroma_subsampled(SAMP[samp])
        geo = enc.resolve(frame, p, None)
        geos.append((geo, geo.param_image.with_(
            color_space=mod.ColorSpace.RGB)))
    return geos


def _planes(rng, geo):
    return [rng.integers(0, 256, (c.data_height, c.data_width),
                         dtype=np.uint8) for c in geo.components]


def _pack(p):
    """(h, w) u8 -> the JAX kernels' (h, w/4) u32 packed words."""
    return jnp.asarray(p.reshape(p.shape[0], -1, 4).view("<u4")[..., 0])


@pytest.mark.parametrize("samp", list(SAMP))
def test_post_plain_matches_pallas_interpret(rng, samp):
    """At a size the Pallas postprocessor takes (W % 16 dx == 0, H % 8 ==
    0): the plain version equals it and the XLA postprocessor."""
    (jg, jpi), (tg, tpi) = _geos(samp, 56, 128)
    planes = _planes(rng, tg)
    got = tpre.postprocess_packed([torch.from_numpy(p) for p in planes], tg,
                                  tpi)
    ref_k = jpre.postprocess_packed([_pack(p) for p in planes], jg, jpi,
                                    interpret=True)
    assert ref_k is not None
    ref_x = jax.jit(lambda ps: jsample.postprocess(ps, jg, jpi))(
        tuple(jnp.asarray(p) for p in planes))
    assert np.array_equal(got.numpy(), np.asarray(ref_k))
    assert np.array_equal(got.numpy(), np.asarray(ref_x))


@pytest.mark.parametrize("samp", list(SAMP))
@pytest.mark.parametrize("hw", [(233, 311), (49, 130)])
def test_post_plain_matches_xla_odd_sizes(rng, samp, hw):
    """Odd heights and widths, which the Pallas postprocessor refuses: the
    plain version equals the JAX package's XLA postprocessor (its CPU
    oracle, sample._upsample_to)."""
    (jg, jpi), (tg, tpi) = _geos(samp, *hw)
    planes = _planes(rng, tg)
    got = tpre.postprocess_packed([torch.from_numpy(p) for p in planes], tg,
                                  tpi)
    ref = jsample.postprocess([jnp.asarray(p) for p in planes], jg, jpi)
    assert got.shape == (*hw, 3)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_upsample_rule_matches_pallas_rule():
    """The port's row of output row y, y // ceil(H / height) (the CPU
    oracle's repeat), is the Pallas kernel's min(y // dy, height - 1) for
    every height up to 300 at dy in {1, 2}; columns likewise."""
    for dy in (1, 2):
        for H in range(1, 301):
            height = -(-H // dy)
            fy = -(-H // height)
            y = np.arange(H)
            assert np.array_equal(y // fy, np.minimum(y // dy, height - 1))


def test_upsample_factors():
    _, (geo, pi) = _geos("420", 233, 311)
    assert tsample.upsample_factors(geo, pi) == [(1, 1), (2, 2), (2, 2)]
    _, (geo, pi) = _geos("440", 233, 311)
    assert tsample.upsample_factors(geo, pi) == [(1, 1), (2, 1), (2, 1)]


def _port(frame, samp, quality, rst):
    return gt.Encoder(device="cpu").encode(frame, gt.Parameters(
        quality=quality, restart_interval=rst,
        interleaved=True).chroma_subsampled(SAMP[samp]))


@pytest.mark.parametrize("samp,quality,rst", [("420", 90, 2),
                                              ("440", 75, -1),
                                              ("422", 75, 3),
                                              ("444", 75, -1)])
def test_idct_planes_plain_matches_jax_tail(monkeypatch, samp, quality,
                                            rst):
    """Each component's plane from the plain IDCT equals the plane the JAX
    package's interleaved tail computes (a float32 jnp.dot at HIGHEST,
    then its pack and relayout), and the port's back half returns the
    tail's image."""
    data = _port(_gradient(41, 67, 2), samp, quality, rst)
    dec = gt.Decoder(device="cpu")
    hf = dec.prepare(data)
    coefs_t, _ea, _ec = dec.coefficients_t(hf)
    p = hf.plan
    geo = p.geo
    jgeo = gj.Encoder().resolve(np.zeros((41, 67, 3), np.uint8),
                                gj.Parameters(quality=quality,
                                              restart_interval=rst,
                                              interleaved=True)
                                .chroma_subsampled(SAMP[samp]), None)
    nseg, rst_m, bpm = (geo.segment_count, geo.segment_mcu_count,
                        geo.blocks_per_mcu)
    by_slot = coefs_t.reshape(64, nseg, rst_m, bpm)
    cts = tuple(jnp.asarray(by_slot[:, :, :, off:off + n].reshape(64, -1)
                            .numpy())
                for off, n in jdec._il_comp_slots(jgeo))
    seen = []

    def capture(p32s, geo_, pi, interpret=False):
        seen.extend(np.asarray(x) for x in p32s)
        return None                       # the tail goes on in XLA

    monkeypatch.setattr(jdec.prepost_kernel, "postprocess_packed", capture)
    fn = jdec._make_idct_post_fn_t_il(jgeo).__wrapped__
    ref_img = fn(cts, jnp.asarray(p.qtabs.numpy()))
    assert len(seen) == 3
    planes = tpre.idct_planes(coefs_t, p.qtabs, geo)
    assert len(planes) == 3
    for c, p32, got in zip(geo.components, seen, planes):
        ref = p32.view(np.uint8).reshape(c.data_height, c.data_width)
        assert np.array_equal(got.numpy(), ref), c.index
    img = tdec.Decoder.back_half(coefs_t, p, hf.out_pi)
    assert np.array_equal(img.numpy(), np.asarray(ref_img))
