"""Device selection and process-wide numeric settings.

The counterpart of gpujpeg_tpu.jaxinit: where the JAX package configures its
compilation cache, the port picks the torch device and keeps float32 products
in full float32.  The forward DCT must match the JAX package bit for bit, so
TF32 (about three decimal digits) is never allowed in a product.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one.  No CUDA and no explicit device raises; nothing falls
    back to the CPU on its own."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gpujpeg_tpu_torch runs on CUDA and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
