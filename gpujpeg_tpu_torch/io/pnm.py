"""PNM (PBM/PGM/PPM) and PAM readers/writers (numpy, 8-bit).

Behavioral equivalent of the reference's src/utils/pam.c: P5/P6 (binary
PGM/PPM) and P7 (PAM) with maxval 255; writer emits the minimal header.

The port's copy of gpujpeg_tpu.io.pnm.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..types import ColorSpace, ImageParameters, PixelFormat


def _read_token(buf: bytes, pos: int) -> Tuple[bytes, int]:
    """Next whitespace-delimited token, skipping '#' comments."""
    n = len(buf)
    while pos < n:
        c = buf[pos:pos + 1]
        if c == b"#":
            while pos < n and buf[pos:pos + 1] != b"\n":
                pos += 1
        elif c.isspace():
            pos += 1
        else:
            break
    start = pos
    while pos < n and not buf[pos:pos + 1].isspace():
        pos += 1
    return buf[start:pos], pos


def load_pnm(data: bytes):
    """Parse PGM/PPM/PAM bytes -> (array, ImageParameters).

    Returns (H, W) uint8 for grayscale, (H, W, C) for color.
    """
    magic, pos = _read_token(data, 0)
    if magic == b"P7":
        # PAM: header lines until ENDHDR
        header = {}
        end = data.index(b"ENDHDR\n") + len(b"ENDHDR\n")
        for line in data[2:end].split(b"\n"):
            parts = line.strip().split()
            if len(parts) >= 2:
                header[parts[0].decode()] = parts[1].decode()
        w = int(header["WIDTH"])
        h = int(header["HEIGHT"])
        depth = int(header["DEPTH"])
        maxval = int(header.get("MAXVAL", 255))
        if maxval != 255:
            raise ValueError("only maxval 255 PAM supported")
        arr = np.frombuffer(data, np.uint8, count=w * h * depth, offset=end)
        arr = arr.reshape(h, w, depth) if depth > 1 else arr.reshape(h, w)
    elif magic in (b"P5", b"P6"):
        tok_w, pos = _read_token(data, pos)
        tok_h, pos = _read_token(data, pos)
        tok_max, pos = _read_token(data, pos)
        w, h, maxval = int(tok_w), int(tok_h), int(tok_max)
        if maxval != 255:
            raise ValueError("only maxval 255 PNM supported")
        pos += 1  # single whitespace after maxval
        depth = 3 if magic == b"P6" else 1
        arr = np.frombuffer(data, np.uint8, count=w * h * depth, offset=pos)
        arr = arr.reshape(h, w, 3) if depth == 3 else arr.reshape(h, w)
    else:
        raise ValueError(f"unsupported PNM magic {magic!r}")

    depth = 1 if arr.ndim == 2 else arr.shape[2]
    pf = {1: PixelFormat.U8, 3: PixelFormat.P444_U8_P012,
          4: PixelFormat.P4444_U8_P0123}.get(depth)
    if pf is None:
        raise ValueError(f"unsupported PNM depth {depth}")
    cs = (ColorSpace.YCBCR_BT601_256LVLS if depth == 1 else ColorSpace.RGB)
    pi = ImageParameters(width=w, height=h, color_space=cs, pixel_format=pf)
    return arr, pi


def save_pnm(pi: ImageParameters, arr: np.ndarray, pam: bool = False) -> bytes:
    """Serialize to PGM/PPM (or PAM when pam=True / 4 channels)."""
    depth = 1 if arr.ndim == 2 else arr.shape[2]
    h, w = arr.shape[:2]
    if pam or depth == 4:
        tupl = {1: "GRAYSCALE", 3: "RGB", 4: "RGB_ALPHA"}[depth]
        header = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\n"
                  f"MAXVAL 255\nTUPLTYPE {tupl}\nENDHDR\n").encode()
    else:
        magic = "P6" if depth == 3 else "P5"
        header = f"{magic}\n{w} {h}\n255\n".encode()
    return header + np.ascontiguousarray(arr).tobytes()
