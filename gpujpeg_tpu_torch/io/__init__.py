"""Host image file I/O: PNM/PAM, Y4M, BMP/PNG/TGA/GIF, raw, .tst generator
(numpy; the port's copy of gpujpeg_tpu.io, with the same names, bytes
and exception types)."""

from . import formats, image, pnm, tst, y4m  # noqa: F401
from .image import calculate_size, load, probe, save  # noqa: F401
