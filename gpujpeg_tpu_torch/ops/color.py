"""Integer color-space transforms on int32 tensors.

Bit-exact re-implementation of the reference's 8-bit fixed-point transform
(src/gpujpeg_colorspace.h:64-101), ported from gpujpeg_tpu.ops.color:

    to:   r = c * 256 / 255            (C integer division)
          out = clamp(((M @ r + 128) >> 8) + base)
    from: r = (c - base) * 256 / 255   (C trunc-toward-zero division!)
          out = clamp((M @ r + 128) >> 8)

Composite conversions route via RGB, exactly like the template
specializations at gpujpeg_colorspace.h:353-427.  ``>>`` on a negative
int32 tensor is an arithmetic shift in PyTorch, as it is in the reference
and in the CUDA kernel (csrc/pre_rgb_to_planes.cu), which takes its
matrices from ``kernel_params`` below.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..types import ColorSpace

# integer matrices from gpujpeg_colorspace.h (row-major 3x3) and bases
_TO_RGB = {  # color space -> (matrix, base) for the "from" direction
    ColorSpace.YCBCR_BT601: ([298, 0, 409, 298, -100, -208, 298, 516, 0], (16, 128, 128)),
    ColorSpace.YCBCR_BT601_256LVLS: ([256, 0, 359, 256, -88, -183, 256, 454, 0], (0, 128, 128)),
    ColorSpace.YCBCR_BT709: ([298, 0, 459, 298, -55, -136, 298, 541, 0], (16, 128, 128)),
    ColorSpace.YUV: ([256, 0, 292, 256, -101, -149, 256, 520, 0], (0, 128, 128)),
}
_FROM_RGB = {  # color space -> (matrix, base) for the "to" direction
    ColorSpace.YCBCR_BT601: ([66, 129, 25, -38, -74, 112, 112, -94, -18], (16, 128, 128)),
    ColorSpace.YCBCR_BT601_256LVLS: ([77, 150, 29, -43, -85, 128, 128, -107, -21], (0, 128, 128)),
    ColorSpace.YCBCR_BT709: ([47, 157, 16, -26, -87, 112, 112, -102, -10], (16, 128, 128)),
    ColorSpace.YUV: ([77, 150, 29, -38, -74, 112, 157, -132, -26], (0, 128, 128)),
}


def _scale_255_to_256(c: torch.Tensor) -> torch.Tensor:
    """c * 256 / 255 with C truncation for int c in (-255, 256): 256c =
    255c + c, so the quotient is c + [c >= 255] (for negative c the
    magnitude truncates to |c|)."""
    return c + (c >= 255).to(c.dtype)


def transform_steps(src: ColorSpace,
                    dst: ColorSpace) -> List[Tuple[str, ColorSpace]]:
    """Sequence of ('from'|'to', colorspace) primitive steps for src->dst."""
    if src == dst or src == ColorSpace.NONE or dst == ColorSpace.NONE:
        return []
    steps: List[Tuple[str, ColorSpace]] = []
    if src != ColorSpace.RGB:
        steps.append(("from", src))
    if dst != ColorSpace.RGB:
        steps.append(("to", dst))
    return steps


def convert_channels(c0, c1, c2, src: ColorSpace, dst: ColorSpace):
    """Transform three integer channel tensors elementwise from `src` to
    `dst` (gpujpeg_tpu.ops.color.convert_channels).

    Returns (c0', c1', c2') int32 in [0, 255]."""
    ch = (c0.to(torch.int32), c1.to(torch.int32), c2.to(torch.int32))
    for direction, cs in transform_steps(src, dst):
        if direction == "from":
            mat, base = _TO_RGB[cs]
            m = np.asarray(mat, dtype=np.int64).reshape(3, 3)
            r = tuple(_scale_255_to_256(ch[i] - int(base[i]))
                      for i in range(3))
            ch = tuple(torch.clamp(
                (r[0] * int(m[i][0]) + r[1] * int(m[i][1])
                 + r[2] * int(m[i][2]) + 128) >> 8, 0, 255)
                for i in range(3))
        else:
            mat, base = _FROM_RGB[cs]
            m = np.asarray(mat, dtype=np.int64).reshape(3, 3)
            r = tuple(_scale_255_to_256(ch[i]) for i in range(3))
            ch = tuple(torch.clamp(
                ((r[0] * int(m[i][0]) + r[1] * int(m[i][1])
                  + r[2] * int(m[i][2]) + 128) >> 8) + int(base[i]),
                0, 255) for i in range(3))
    return ch


def kernel_params(src: ColorSpace, dst: ColorSpace) -> np.ndarray:
    """The transform as the CUDA preprocessor takes it: int32[26] =
    from-matrix[9], from-base[3], to-matrix[9], to-base[3], use_from,
    use_to (each step is skipped when its flag is 0)."""
    p = np.zeros(26, np.int32)
    for direction, cs in transform_steps(src, dst):
        if direction == "from":
            mat, base = _TO_RGB[cs]
            p[0:9], p[9:12], p[24] = mat, base, 1
        else:
            mat, base = _FROM_RGB[cs]
            p[12:21], p[21:24], p[25] = mat, base, 1
    return p
