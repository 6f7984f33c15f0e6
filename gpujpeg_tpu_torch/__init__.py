"""gpujpeg_tpu_torch: the PyTorch/CUDA port of gpujpeg_tpu.

A baseline-JPEG encoder and decoder whose device stages are hand-written
CUDA kernels for Hopper (csrc/), each with a plain PyTorch version beside
it that the CPU runs.  The JAX package gpujpeg_tpu is the reference: the
port imports nothing from it, writes the same bytes and decodes the same
pixels.
"""

__version__ = "0.1.0"

from .types import (  # noqa: F401
    ColorSpace,
    CorruptStreamError,
    HeaderType,
    ImageInfo,
    ImageParameters,
    Parameters,
    PixelFormat,
    RESTART_AUTO,
    RESTART_NONE,
    SamplingFactor,
    default_image_parameters,
    default_parameters,
    from_reference,
)

from .models.decoder import Decoder  # noqa: F401
from .models.encoder import Encoder  # noqa: F401
