"""Forward DCT + quantization, and dequantization + inverse DCT, in plain
PyTorch (gpujpeg_tpu.ops.dct).

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
CUDA kernels (csrc/fdct_quant.cu, csrc/dpost_rgb.cu) with fmaf, and this
module by emulating each fma as a float64 product and sum of float32
operands rounded back to float32, which is the same on every device.  The
inverse transform (``dequantize_idct``) is the same chain over the
dequantized coefficients:

    y = coef * q                                  (float32, exact)
    acc = 0;  for k in 0..63:  acc = fma(y[k], N[k, s], acc)
    sample = clip(round_half_even(acc + 128), 0, 255)   (separate add)
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


def blocks_to_plane(blocks: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(H/8 * W/8, 64) row-major blocks in raster order -> (H, W)."""
    x = blocks.reshape(H // 8, W // 8, 8, 8).permute(0, 2, 1, 3)
    return x.reshape(H, W)


def _fma_chain(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """acc[:, z] = fma(x[:, 63], m[63, z], ... fma(x[:, 0], m[0, z], 0)),
    each fma in float64 rounded to float32; x is float64 holding float32
    values, m a (64, 64) float32 matrix."""
    m64 = torch.from_numpy(np.asarray(m, np.float32)).to(x.device,
                                                         torch.float64)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(64):
        acc = (acc.to(torch.float64) + x[:, k:k + 1] * m64[k]).to(
            torch.float32)
    return acc


def dequantize_idct(coefs: torch.Tensor, qtab_zz, H: int,
                    W: int) -> torch.Tensor:
    """Dequantize + inverse DCT (gpujpeg_tpu.ops.dct.dequantize_idct_traced):
    (H/8 * W/8, 64) zig-zag coefficients in raster block order -> (H, W)
    int32 samples in [0, 255]."""
    q = torch.as_tensor(qtab_zz, dtype=torch.float32, device=coefs.device)
    y = coefs.to(torch.float32) * q[None, :]
    acc = _fma_chain(y.to(torch.float64), tables.idct2d_matrix_zz())
    x = torch.clamp(torch.round(acc + 128.0), 0, 255).to(torch.int32)
    return blocks_to_plane(x, H, W)


def fdct_quantize(plane: torch.Tensor, qtab_zz: np.ndarray) -> torch.Tensor:
    """Forward DCT + quantize one component plane.

    plane: (data_h, data_w) integer samples in [0, 255]
    returns: (nblocks, 64) int16 quantized coefficients in zig-zag order,
    blocks in raster order.
    """
    Mq, bias = tables.fdct_fused_matrix(np.asarray(qtab_zz))
    acc = _fma_chain(plane_to_blocks(plane).to(torch.float64), Mq)
    y = acc + torch.from_numpy(bias).to(plane.device)
    # round half to even, as rintf and jnp.round
    return torch.round(y).to(torch.int16)
