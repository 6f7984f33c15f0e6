"""Forward DCT + quantization in plain PyTorch (gpujpeg_tpu.ops.dct).

An 8x8 block flattened to 64 samples times the (64, 64) matrix Mq of
tables.fdct_fused_matrix gives the quantized zig-zag coefficients: the 2D
DCT, the zig-zag order and the quantizer reciprocals are folded into Mq, and
the -128 level shift into an additive bias.

Summation order is part of the result.  The JAX package's float32 product on
the CPU equals, bit for bit, a sequential fused multiply-add chain

    acc = 0;  for k in 0..63:  acc = fma(x[k], Mq[k, z], acc)
    coef = round_half_even(acc + bias[z])     (a separate float32 add)

and any other order (split sums, TF32, a library GEMM) changes about 2 in
10,000 quantized coefficients.  Every DCT of the port uses this chain: the
CUDA kernel (csrc/fdct_quant.cu) with fmaf, and this module by emulating
each fma as a float64 product and sum of float32 operands rounded back to
float32, which is the same on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import tables


def plane_to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H/8 * W/8, 64) row-major blocks in raster order."""
    H, W = plane.shape
    x = plane.reshape(H // 8, 8, W // 8, 8).permute(0, 2, 1, 3)
    return x.reshape(-1, 64)


def fdct_quantize(plane: torch.Tensor, qtab_zz: np.ndarray) -> torch.Tensor:
    """Forward DCT + quantize one component plane.

    plane: (data_h, data_w) integer samples in [0, 255]
    returns: (nblocks, 64) int16 quantized coefficients in zig-zag order,
    blocks in raster order.
    """
    Mq, bias = tables.fdct_fused_matrix(np.asarray(qtab_zz))
    dev = plane.device
    m64 = torch.from_numpy(Mq).to(dev, torch.float64)       # exact f32 values
    x = plane_to_blocks(plane).to(torch.float64)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=dev)
    for k in range(64):
        acc = (acc.to(torch.float64) + x[:, k:k + 1] * m64[k]).to(
            torch.float32)
    y = acc + torch.from_numpy(bias).to(dev)
    # round half to even, as rintf and jnp.round
    return torch.round(y).to(torch.int16)
