"""Synthetic `.tst` test-image generator.

Filename grammar (src/utils/image_delegate.c:341-465):
    <W>x<H>[.c_<CS>][.p_<PF>][.<pattern>].tst
patterns: gradient (default), blank[_<val>], noise, random[_<seed>]
(`random` uses a deterministic LCG, image_delegate.c:560-582, default
seed 12345).

The port's copy of gpujpeg_tpu.io.tst.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..types import (ColorSpace, ImageParameters, PixelFormat,
                     image_size_bytes)
from . import formats


def parse_tst_filename(filename: str) -> Tuple[ImageParameters, dict]:
    name = os.path.basename(filename)
    stem = name[:-4] if name.lower().endswith(".tst") else name
    parts = stem.split(".")
    dims = parts[0]
    if "x" not in dims:
        raise ValueError("tst filename must start with <W>x<H>")
    w_s, h_s = dims.split("x", 1)
    pi = ImageParameters(width=int(w_s), height=int(h_s),
                         color_space=ColorSpace.RGB,
                         pixel_format=PixelFormat.P444_U8_P012)
    tst = {"pattern": "gradient", "blank_val": 0, "seed": 12345}
    for item in parts[1:]:
        if item.startswith("c_"):
            cs = formats.color_space_by_name(item[2:])
            if cs is None:
                raise ValueError(f"unknown color space {item[2:]!r}")
            pi = pi.with_(color_space=cs)
        elif item.startswith("p_"):
            pf = formats.pixel_format_by_name(item[2:])
            if pf is None:
                raise ValueError(f"unknown pixel format {item[2:]!r}")
            pi = pi.with_(pixel_format=pf)
        elif item == "noise":
            tst["pattern"] = "noise"
        elif item.startswith("random"):
            tst["pattern"] = "random"
            if item.startswith("random_"):
                tst["seed"] = int(item[len("random_"):])
        elif item.startswith("blank"):
            tst["pattern"] = "blank"
            if "_" in item:
                tst["blank_val"] = int(item.split("_", 1)[1], 0)
        elif item == "gradient":
            tst["pattern"] = "gradient"
        else:
            raise ValueError(f"unknown test image option {item!r}")
    return pi, tst


def lcg_bytes(n: int, seed: int) -> np.ndarray:
    """The reference's LCG pattern, vectorized: state = (A*state + C) % M,
    byte = state % 256 (image_delegate.c:560-582)."""
    A, C, M = 1664525, 1013904223, 2147483647
    # Power the LCG into a vector recurrence:
    #   state_k = A^k*s0 + C*(A^(k-1)+...+1)  (mod M)
    # Computed in chunks with per-chunk jump-ahead to stay vectorized.
    out = np.empty(n, dtype=np.uint8)
    chunk = 1 << 16
    # precompute A^i and prefix sums S_i = sum_{j<i} A^j mod M for one chunk
    apow = np.empty(chunk + 1, dtype=np.int64)
    asum = np.empty(chunk + 1, dtype=np.int64)
    apow[0], asum[0] = 1, 0
    a, s = 1, 0
    for i in range(1, chunk + 1):
        s = (s + a) % M
        a = (a * A) % M
        apow[i], asum[i] = a, s
    state = seed % M
    pos = 0
    while pos < n:
        m = min(chunk, n - pos)
        states = (apow[1:m + 1] * state + C * asum[1:m + 1]) % M
        out[pos:pos + m] = (states % 256).astype(np.uint8)
        state = int(states[-1])
        pos += m
    return out


def generate(filename: str) -> Tuple[np.ndarray, ImageParameters]:
    """Generate the flat image buffer for a .tst filename."""
    pi, tst = parse_tst_filename(filename)
    size = image_size_bytes(pi.width, pi.height, pi.pixel_format)
    if tst["pattern"] == "gradient":
        # per-line fill with i*255/height (image_delegate.c:596-604)
        line = size // pi.height if pi.height else 0
        vals = (np.arange(pi.height, dtype=np.int64) * 255
                // max(pi.height, 1)).astype(np.uint8)
        data = np.repeat(vals, line)
        if len(data) < size:
            data = np.concatenate(
                [data, np.zeros(size - len(data), np.uint8)])
        data = data[:size]
    elif tst["pattern"] == "blank":
        data = np.full(size, tst["blank_val"] & 0xFF, np.uint8)
    elif tst["pattern"] == "noise":
        data = np.random.default_rng().integers(
            0, 256, size=size, dtype=np.uint8)
    else:  # random (deterministic)
        from .. import native

        if native.available():
            data = native.lcg_fill(size, tst["seed"])
        else:
            data = lcg_bytes(size, tst["seed"])
    return data, pi
