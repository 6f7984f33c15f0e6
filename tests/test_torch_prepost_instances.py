"""PyTorch port, the instance choosers of the pre- and postprocessor
kernels (ops/prepost_kernel.pre_instance, post_instance) on the CPU.

Each kernel (csrc/pre_rgb_to_planes.cu, csrc/post_rgb.cu) holds a generic
instance (a pixel a thread, any layout), the RGB vector instance of an
earlier design, and vector instances of every other input or output kind
(16 pixels a thread, 16-byte vectors).  The chooser is pure Python, so
these tests check, on any machine, that the vector instance is picked
exactly where it applies: every input kind and output format; 1, 3 and 4
components; 4:4:4, 4:2:2, 4:2:0 and 4:1:1; W % 16 in {0, 1, 15} and the
widths whose rows still hold whole vectors; padded rows; tensors off
16-byte alignment.  The card tests (test_torch_kernels.py) run the
chosen instances against the plain versions.  Imports no JAX."""

import re

import numpy as np
import pytest
import torch

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import _kernels
from gpujpeg_tpu_torch.ops import prepost_kernel as tpre
from gpujpeg_tpu_torch.utils.geometry import get_geometry

from tests import format_cases as fc

H = 24

S = {"grey": ((1, 1),), "two": ((1, 1), (1, 1)), "444": ((1, 1),) * 3,
     "420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
     "411": ((4, 1), (1, 1), (1, 1)), "2221": ((2, 2), (2, 1), (2, 1)),
     "mixed": ((2, 2), (2, 1), (1, 1)), "four": ((1, 1),) * 4,
     "four_420": ((2, 2), (1, 1), (1, 1), (2, 2))}


def _aligned(n, skew=0):
    """n bytes starting `skew` bytes past a 64-byte boundary."""
    base = torch.zeros(n + 128, dtype=torch.uint8)
    first = (-base.data_ptr()) % 64 + skew
    return base[first:first + n]


def _raw(kind, w, pitch=None, skew=0):
    """(raw tensor, pixel format, width_padding) of an input kind at H x w;
    a flat packed input's rows padded to `pitch` bytes when given."""
    raw, pf, pad = fc.raw_input(kind, H, w, seed=w)
    if pitch is not None:
        rows = raw.reshape(H, -1)[:, :w * fc.UNIT[pf]]
        pad = pitch - rows.shape[1]
        raw = np.concatenate([rows, np.zeros((H, pad), np.uint8)], 1)
        raw = raw.reshape(-1)
    t = _aligned(raw.size, skew).view(raw.shape)
    t.copy_(torch.from_numpy(raw))
    return t, pf, pad


def _pre_pick(kind, samp, w, il=False, pitch=None, skew=0, plane_skew=0):
    raw, pf, pad = _raw(kind, w, pitch, skew)
    pi = fc.image_params(gt, pf, H, w, pad)
    geo = gt.Encoder(device="cpu").resolve(
        raw.numpy(), fc.params(gt, S.get(samp), il), pi)
    sizes = [c.data_height * c.data_width for c in geo.components]
    buf = _aligned(sum(sizes), plane_skew)
    planes = [p.view(c.data_height, c.data_width) for c, p in
              zip(geo.components, torch.split(buf, sizes))]
    inst = tpre.pre_instance(raw, planes, tpre.pre_geometry(geo),
                             tpre.pre_source(raw, geo, pi))
    return tpre.INSTANCES[inst]


#: (input kind, sampling (None: the format's own), width, interleaved,
#: flat rows padded to this pitch, image skew, plane skew) -> instance
PRE_CASES = [
    # greyscale, 2-D and flat: one 16-byte load a group
    (("u8", None, 64), "u8_dx1"), (("u8_flat", None, 64), "u8_dx1"),
    (("u8", None, 65), "generic"), (("u8", None, 79), "generic"),
    (("u8_flat", None, 65, False, 80), "u8_dx1"),     # tail, padded rows
    (("u8_flat", None, 79, False, 80), "u8_dx1"),
    (("u8", "444", 64), "u8_dx1"), (("u8", "420", 64), "u8_dx2"),
    # RGB: the earlier vector instance where it applies, else the new one
    (("rgb", None, 64), "rgb_vector"), (("rgb", "420", 64), "rgb_vector"),
    (("rgb", "2221", 64, True), "rgb_vector"),
    (("rgb", "411", 64), "rgb_dx4"), (("rgb", "411", 64, True), "rgb_dx4"),
    (("rgb", "grey", 64), "rgb_dx1"), (("rgb", "420", 79), "generic"),
    (("rgb_pad", None, 64), "generic"),                # pitch 197
    (("rgb_pad", "420", 79, False, 240), "rgb_dx2"),   # flat, tail
    (("rgb_pad", None, 65, False, 208), "rgb_dx1"),
    # RGBA: four 16-byte loads a group
    (("rgba", None, 64), "rgba_dx1"), (("rgba", "420", 64), "rgba_dx2"),
    (("rgba", "four_420", 64), "rgba_dx2"),
    (("rgba", "411", 64, True), "rgba_dx4"), (("rgba", "two", 64), "rgba_dx1"),
    (("rgba", "444", 64), "rgba_dx1"),
    (("rgba", None, 68), "rgba_dx1"),                  # pitch 272, tail
    (("rgba", None, 65), "generic"), (("rgba", None, 79), "generic"),
    (("rgba_pad", None, 64), "generic"),               # pitch 259
    # UYVY: 32 bytes a group
    (("uyvy", None, 64), "uyvy_dx2"), (("uyvy", "420", 64), "uyvy_dx2"),
    (("uyvy", "444", 64), "uyvy_dx1"), (("uyvy", "411", 64), "uyvy_dx4"),
    (("uyvy", None, 72), "uyvy_dx2"),                  # pitch 144, tail
    (("uyvy", None, 66), "generic"),
    (("uyvy_pad", None, 64), "generic"),               # pitch 132
    (("uyvy_pad", None, 64, True, 144), "uyvy_dx2"),
    # planar: 16 luma bytes and 16 or 8 of each chroma row
    (("p444", None, 64), "planar_dx1"), (("p444", "411", 64), "planar_dx4"),
    (("p444", "411", 64, True), "planar_dx4"),
    (("p422", None, 64), "planar_half_dx2"),
    (("p422", None, 64, True), "planar_half_dx2"),
    (("p420", None, 64), "planar_half_dx2"),
    (("p420", "444", 64), "planar_half_dx1"),
    (("p420", "grey", 64), "planar_half_dx1"),
    (("p420", None, 65), "generic"), (("p420", None, 79), "generic"),
    (("p420", None, 72), "generic"),       # chroma rows of 36 bytes
    (("p444", None, 65), "generic"),
    # chroma planes of two decimations, tensors off alignment
    (("rgba", "mixed", 64), "generic"), (("uyvy", "mixed", 64), "generic"),
    (("rgba", None, 64, False, None, 4), "generic"),
    (("u8", None, 64, False, None, 1), "generic"),
    (("p420", None, 64, False, None, 8), "generic"),
    (("rgba", None, 64, False, None, 0, 4), "generic"),
    (("rgba", None, 64, False, None, 0, 8), "rgba_dx1"),
]


@pytest.mark.parametrize("case,want", PRE_CASES,
                         ids=["-".join(map(str, c)) for c, _ in PRE_CASES])
def test_pre_instance_choice(case, want):
    assert _pre_pick(*case) == want


def _post_pick(pf, samp, w, h=H, plane_skew=0, out_skew=0):
    pi = fc.image_params(gt, pf, h, w)
    geo = get_geometry(fc.params(gt, S[samp], rst=8), pi)
    shape, g, dst = tpre.post_target(geo, pi)
    planes = []
    for c in geo.components:
        n = c.data_height * c.data_width
        planes.append(_aligned(n, plane_skew).view(c.data_height,
                                                   c.data_width))
    out = _aligned(int(np.prod(shape)), out_skew).view(shape)
    return tpre.INSTANCES[tpre.post_instance(planes, g, dst, out, w)]


#: (output format, sampling, width, height, plane skew, output skew) ->
#: instance
POST_CASES = [
    # U8: one 16-byte store a group
    (("U8", "grey", 64), "u8_dx1"), (("U8", "444", 64), "u8_dx1"),
    (("U8", "420", 64), "u8_dx2"), (("U8", "four", 64), "u8_dx1"),
    (("U8", "grey", 65), "generic"), (("U8", "grey", 79), "generic"),
    (("U8", "grey", 72), "generic"),
    # RGB: the earlier instance where it applies, else the new one
    (("P444_U8_P012", "444", 64), "rgb_vector"),
    (("P444_U8_P012", "420", 65), "rgb_vector"),
    (("P444_U8_P012", "grey", 64), "rgb_dx1"),
    (("P444_U8_P012", "four", 64), "rgb_dx1"),
    (("P444_U8_P012", "411", 64), "rgb_dx4"),
    (("P444_U8_P012", "grey", 65), "generic"),
    # RGBA: four 16-byte stores a group
    (("P4444_U8_P0123", "444", 64), "rgba_dx1"),
    (("P4444_U8_P0123", "420", 64), "rgba_dx2"),
    (("P4444_U8_P0123", "four", 64), "rgba_dx1"),
    (("P4444_U8_P0123", "four_420", 64), "rgba_dx2"),
    (("P4444_U8_P0123", "grey", 64), "rgba_dx1"),
    (("P4444_U8_P0123", "411", 64), "rgba_dx4"),
    (("P4444_U8_P0123", "444", 68), "rgba_dx1"),   # tail, whole rows
    (("P4444_U8_P0123", "444", 65), "generic"),
    (("P4444_U8_P0123", "444", 79), "generic"),
    (("P4444_U8_P0123", "444", 66), "generic"),
    # UYVY: two 16-byte stores a group
    (("P422_U8_P1020", "422", 64), "uyvy_dx2"),
    (("P422_U8_P1020", "420", 64), "uyvy_dx2"),
    (("P422_U8_P1020", "444", 64), "uyvy_dx1"),
    (("P422_U8_P1020", "grey", 64), "uyvy_dx1"),
    (("P422_U8_P1020", "422", 72), "uyvy_dx2"),    # tail
    (("P422_U8_P1020", "422", 68), "generic"),
    # planar: a thread makes 16 samples of one output plane
    (("P444_U8_P0P1P2", "444", 64), "planar_dx1"),
    (("P444_U8_P0P1P2", "420", 64), "planar_dx2"),
    (("P444_U8_P0P1P2", "grey", 64), "planar_dx1"),
    (("P422_U8_P0P1P2", "422", 64), "planar_half_dx2"),
    (("P420_U8_P0P1P2", "420", 64), "planar_half_dx2"),
    (("P420_U8_P0P1P2", "420", 64, 25), "planar_half_dx2"),
    (("P420_U8_P0P1P2", "411", 64), "planar_half_dx4"),
    (("P420_U8_P0P1P2", "four", 64), "planar_half_dx1"),
    (("P420_U8_P0P1P2", "420", 72), "generic"),    # chroma rows of 36
    (("P420_U8_P0P1P2", "420", 65), "generic"),
    (("P420_U8_P0P1P2", "420", 79), "generic"),
    (("P444_U8_P0P1P2", "444", 48, 23), "planar_dx1"),
    (("P444_U8_P0P1P2", "444", 40), "generic"),
    # two components, two chroma decimations, tensors off alignment
    (("P4444_U8_P0123", "two", 64), "generic"),
    (("P4444_U8_P0123", "mixed", 64), "generic"),
    (("P4444_U8_P0123", "444", 64, H, 4), "generic"),
    (("P4444_U8_P0123", "444", 64, H, 8), "rgba_dx1"),
    (("P4444_U8_P0123", "444", 64, H, 0, 8), "generic"),
    (("U8", "grey", 64, H, 0, 1), "generic"),
]


@pytest.mark.parametrize("case,want", POST_CASES,
                         ids=["-".join(map(str, c)) for c, _ in POST_CASES])
def test_post_instance_choice(case, want):
    assert _post_pick(*case) == want


def _enum(path, name):
    """The enumerator names of `enum name { ... }` in a kernel source."""
    src = open(_kernels.source_path(path)).read()
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    return re.findall(r"k\w+", body)


def _snake(camel):
    return re.sub(r"(?<!^)(?=[A-Z])", "_", camel).lower()


@pytest.mark.parametrize("kernel,enum,prefix", [
    ("pre_rgb_to_planes", "VecSource", "kVec"),
    ("post_rgb", "VecTarget", "kOut")])
def test_instance_ids_match_sources(kernel, enum, prefix):
    """The wrapper's kinds are each CUDA source's, in its order; the ids
    2 + 3 kind + log2(step) cover its kVecSteps steps 1, 2, 4."""
    names = _enum(kernel, enum)
    assert names[-1] in ("kVecSources", "kVecTargets")
    assert tuple(_snake(n[len(prefix):]) for n in names[:-1]) == \
        tpre.VECTOR_KINDS
    src = open(_kernels.source_path(kernel)).read()
    assert re.search(r"constexpr int kVecSteps = 3;", src)
    assert tpre.INSTANCES[:2] == ("generic", "rgb_vector")
    assert tpre.INSTANCES[2 + 3 * 2 + 1] == "rgba_dx2"
    assert len(tpre.INSTANCES) == 2 + 3 * len(tpre.VECTOR_KINDS)


def test_launch_counts_instances(monkeypatch):
    """launch counts a kernel and, when named, its instance;
    reset_launches clears both."""
    monkeypatch.setattr(_kernels, "_call", lambda *a: None)
    _kernels.reset_launches()
    _kernels.launch("post_rgb", instance="u8_dx1")
    _kernels.launch("post_rgb", instance="u8_dx1")
    _kernels.launch("pre_rgb_to_planes", instance="generic")
    _kernels.launch("fdct_quant")
    assert _kernels.LAUNCHES["post_rgb"] == 2
    assert _kernels.INSTANCES == {"post_rgb/u8_dx1": 2,
                                  "pre_rgb_to_planes/generic": 1}
    _kernels.reset_launches()
    assert not _kernels.INSTANCES and not any(_kernels.LAUNCHES.values())
