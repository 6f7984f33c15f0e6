"""Raw images of every input pixel format, made from a seed with numpy, and
the encode parameters of the format tests: tests/test_torch_formats*.py
hold the port against the JAX package with them on the CPU,
tests/test_torch_kernels.py holds the kernels against their plain
versions with them on the card.  Imports neither JAX nor the port: a
case names its pixel format, and each test builds its own package's
ImageParameters (image_params)."""

import numpy as np

#: bytes a pixel of the packed formats (types.pixel_format_unit_size)
UNIT = {"U8": 1, "P444_U8_P012": 3, "P4444_U8_P0123": 4,
        "P422_U8_P1020": 2}

#: (sh, sv) of each plane of the planar formats (libyuv plane sizes)
PLANAR = {"P444_U8_P0P1P2": ((1, 1), (1, 1), (1, 1)),
          "P422_U8_P0P1P2": ((2, 1), (1, 1), (1, 1)),
          "P420_U8_P0P1P2": ((2, 2), (1, 1), (1, 1))}

#: input kind -> (pixel format, layout, row padding in bytes); layout is
#: "2d" (H, W), "3d" (H, W, C) or "flat"
INPUTS = {
    "u8": ("U8", "2d", 0),
    "u8_flat": ("U8", "flat", 0),
    "rgb": ("P444_U8_P012", "3d", 0),
    "rgb_pad": ("P444_U8_P012", "flat", 5),
    "rgba": ("P4444_U8_P0123", "3d", 0),
    "rgba_pad": ("P4444_U8_P0123", "flat", 3),
    "uyvy": ("P422_U8_P1020", "flat", 0),
    "uyvy_pad": ("P422_U8_P1020", "flat", 4),
    "p444": ("P444_U8_P0P1P2", "flat", 0),
    "p422": ("P422_U8_P0P1P2", "flat", 0),
    "p420": ("P420_U8_P0P1P2", "flat", 0),
}

#: the seven output pixel formats
OUTPUTS = ["U8", "P444_U8_P012", "P4444_U8_P0123", "P422_U8_P1020",
           "P444_U8_P0P1P2", "P422_U8_P0P1P2", "P420_U8_P0P1P2"]


def gradient(h, w, c, seed, amp=20):
    """(h, w, c) uint8: smooth ramps in each channel plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ramps = [xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (w + h),
             (xx * 3 + yy * 5) % 256]
    f = np.stack([ramps[k % 4] for k in range(c)], -1)
    return np.clip(f + rng.integers(-amp, amp, f.shape), 0, 255) \
        .astype(np.uint8)


def plane_sizes(pf, w, h):
    """(height, width) of each plane of a planar format."""
    samp = PLANAR[pf]
    mh = max(s[0] for s in samp)
    mv = max(s[1] for s in samp)
    return [((h * sv + mv - 1) // mv, (w * sh + mh - 1) // mh)
            for sh, sv in samp]


def raw_input(kind, h, w, seed):
    """(raw uint8 array, pixel format name, width_padding) of an input
    kind at h x w."""
    pf, layout, pad = INPUTS[kind]
    if pf in PLANAR:
        parts = [gradient(ph, pw, 1, seed + k)[..., 0].reshape(-1)
                 for k, (ph, pw) in enumerate(plane_sizes(pf, w, h))]
        return np.concatenate(parts), pf, 0
    if pf == "P422_U8_P1020":
        # u y0 v y1 a pixel pair
        px = gradient(h, w, 3, seed)
        b = np.stack([px[:, ::2, 1], px[:, ::2, 0], px[:, ::2, 2],
                      px[:, 1::2, 0]], -1).reshape(h, 2 * w)
    else:
        b = gradient(h, w, UNIT[pf], seed).reshape(h, w * UNIT[pf])
    if layout == "2d":
        return b, pf, 0
    if layout == "3d":
        return b.reshape(h, w, UNIT[pf]), pf, 0
    pad_bytes = np.random.default_rng(seed + 99).integers(
        0, 256, (h, pad), dtype=np.uint8)
    return np.concatenate([b, pad_bytes], 1).reshape(-1), pf, pad


def image_params(mod, pf, h, w, pad=0, cs="RGB"):
    """mod.ImageParameters of a raw input (mod: either package)."""
    return mod.ImageParameters(width=w, height=h,
                               color_space=mod.ColorSpace[cs],
                               pixel_format=mod.PixelFormat[pf],
                               width_padding=pad)


def params(mod, samp=None, interleaved=False, quality=75, rst=None):
    """mod.Parameters with an optional sampling (its length is the
    component count), the auto restart interval unless rst is given."""
    p = mod.Parameters(quality=quality, interleaved=interleaved,
                       restart_interval=mod.RESTART_AUTO if rst is None
                       else rst)
    return p.chroma_subsampled(samp) if samp else p
