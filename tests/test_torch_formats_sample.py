"""PyTorch port, the pre- and postprocessor's plain versions
(gpujpeg_tpu_torch.ops.sample) against the JAX package's
(gpujpeg_tpu.ops.sample) for every pixel format, component count and
the samplings the codec uses, on the CPU (eager jnp calls: no
compilation).  Tolerance 0: the same planes, channels and raw bytes, of
the same shapes; where the JAX functions raise, the port raises the same
exception type.  The CUDA pre and post kernels are held against these
plain versions in test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpujpeg_tpu as gj
from gpujpeg_tpu.ops import sample as jsample
from gpujpeg_tpu.utils.geometry import get_geometry as jget_geometry

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import prepost_kernel as tpre
from gpujpeg_tpu_torch.ops import sample as tsample
from gpujpeg_tpu_torch.utils.geometry import get_geometry as tget_geometry

from tests import format_cases as fc

#: ragged MCUs and odd chroma plane sizes; an even width for UYVY
HW = (37, 46)

#: (sampling) of the component layouts, by name
SAMPS = {"grey": ((1, 1),), "444": ((1, 1),) * 3,
         "420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
         "411": ((4, 1), (1, 1), (1, 1)), "2221": ((2, 2), (2, 1), (2, 1)),
         "four": ((1, 1),) * 4, "two": ((1, 1), (1, 1))}


def _geos(samp, pf, h, w, pad=0, cs="RGB"):
    """(JAX geometry, port geometry) of a sampling and an image."""
    out = []
    for mod, get in ((gj, jget_geometry), (gt, tget_geometry)):
        out.append(get(fc.params(mod, samp, rst=4),
                       fc.image_params(mod, pf, h, w, pad, cs)))
    return out


@pytest.mark.parametrize("kind", list(fc.INPUTS))
def test_unpack_to_channels_matches_jax(kind):
    h, w = HW
    raw, pf, pad = fc.raw_input(kind, h, w, seed=1)
    ref = np.asarray(jsample.unpack_to_channels(
        jnp.asarray(raw), fc.image_params(gj, pf, h, w, pad)))
    got = tsample.unpack_to_channels(
        torch.from_numpy(raw), fc.image_params(gt, pf, h, w, pad)).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("kind,samp", [
    (k, s) for k in fc.INPUTS for s in ("grey", "444", "420", "four")]
    + [("rgb", "411"), ("rgb", "2221"), ("uyvy", "422"), ("p420", "two"),
       ("rgb", "two")])
@pytest.mark.parametrize("cs", ["RGB", "YCBCR_BT709"])
def test_preprocess_matches_jax(kind, samp, cs):
    """Planes of every input kind at 1 to 4 components: chroma filled with
    128 past the input's channels, colour only for components 0-2 of 3
    or more, the raw channel otherwise."""
    h, w = HW
    raw, pf, pad = fc.raw_input(kind, h, w, seed=2)
    jgeo, tgeo = _geos(SAMPS[samp], pf, h, w, pad, cs)
    ref = jsample.preprocess(jnp.asarray(raw), jgeo, jgeo.param_image)
    got = tpre.preprocess_packed(torch.from_numpy(raw), tgeo,
                                 tgeo.param_image)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == torch.uint8
        assert a.shape == b.shape and np.array_equal(a.numpy(),
                                                     np.asarray(b))


@pytest.mark.parametrize("pf", fc.OUTPUTS)
@pytest.mark.parametrize("samp", ["grey", "444", "420", "422", "411",
                                  "2221", "four"])
@pytest.mark.parametrize("cs", ["RGB", "YCBCR_BT601"])
def test_postprocess_matches_jax(pf, samp, cs):
    """The raw output of every format from 1, 3 and 4 planes: grey filled
    to three channels with 128 unless the output is U8, the 4th channel
    raw beside the converted three, RGBA alpha 255 from 3 components,
    UYVY, the planar formats at libyuv sizes; the same shape and
    bytes."""
    h, w = HW
    jgeo, tgeo = _geos(SAMPS[samp], pf, h, w, cs=cs)
    rng = np.random.default_rng(len(samp) + len(pf))
    planes = [rng.integers(0, 256, (c.data_height, c.data_width),
                           dtype=np.uint8) for c in tgeo.components]
    ref = np.asarray(jsample.postprocess(
        [jnp.asarray(p.astype(np.int32)) for p in planes], jgeo,
        jgeo.param_image))
    got = tpre.postprocess_packed([torch.from_numpy(p) for p in planes],
                                  tgeo, tgeo.param_image).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    shape, _, _ = tpre.post_target(tgeo, tgeo.param_image)
    assert tuple(shape) == ref.shape


@pytest.mark.parametrize("pf", fc.OUTPUTS)
def test_pack_channels_matches_jax(pf):
    h, w = HW
    for nch in (1, 3, 4):
        chans = np.random.default_rng(nch).integers(0, 256, (h, w, nch),
                                                    dtype=np.int32)
        if nch < 3 and pf not in ("U8",):
            continue
        ref = np.asarray(jsample.pack_channels(
            jnp.asarray(chans), fc.image_params(gj, pf, h, w)))
        got = tsample.pack_channels(torch.from_numpy(chans),
                                    fc.image_params(gt, pf, h, w)).numpy()
        assert got.shape == ref.shape and np.array_equal(got, ref)


def _raises(fn):
    try:
        fn()
    except Exception as e:       # noqa: BLE001 - the type is compared
        return type(e)
    return None


def test_refusals_match_jax():
    """Where the JAX functions raise, the port raises the same type: UYVY
    input of odd width (TypeError, a reshape), width_padding on a planar
    format (ValueError), UYVY output of odd width (ValueError, a stack of
    unequal halves)."""
    h, w = HW[0], HW[1] - 1
    raw, pf, _ = fc.raw_input("uyvy", *HW, seed=3)
    odd = raw[:h * w * 2]
    for mod, sample, arr in ((gj, jsample, jnp.asarray(odd)),
                             (gt, tsample, torch.from_numpy(odd))):
        assert _raises(lambda: sample.unpack_to_channels(
            arr, fc.image_params(mod, pf, h, w))) is TypeError
    pgeo = _geos(SAMPS["444"], "P444_U8_P012", h, w)[1]
    assert _raises(lambda: tpre.preprocess_packed(
        torch.from_numpy(odd), pgeo,
        fc.image_params(gt, pf, h, w))) is TypeError
    planar, ppf, _ = fc.raw_input("p420", h, w, seed=4)
    for mod, sample, arr in ((gj, jsample, jnp.asarray(planar)),
                             (gt, tsample, torch.from_numpy(planar))):
        assert _raises(lambda: sample.unpack_to_channels(
            arr, fc.image_params(mod, ppf, h, w, 4))) is ValueError
    assert _raises(lambda: tpre.preprocess_packed(
        torch.from_numpy(planar), pgeo,
        fc.image_params(gt, ppf, h, w, 4))) is ValueError
    chans = np.zeros((h, w, 3), np.int32)
    for mod, sample, arr in ((gj, jsample, jnp.asarray(chans)),
                             (gt, tsample, torch.from_numpy(chans))):
        assert _raises(lambda: sample.pack_channels(
            arr, fc.image_params(mod, pf, h, w))) is ValueError
    ogeo = _geos(SAMPS["444"], pf, h, w)[1]
    assert _raises(lambda: tpre.post_target(ogeo, ogeo.param_image)) \
        is ValueError
