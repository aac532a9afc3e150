"""Plain-torch oracles for the kernels' *functions* (dense products on
masked weights): tests sweep shapes/dtypes and hold the block-sparse
paths to these."""
from __future__ import annotations

import torch


def expand_tile_mask(tile_mask, block, K: int, N: int) -> torch.Tensor:
    bk, bn = block
    tile_mask = torch.as_tensor(tile_mask)
    nKb, nNb = tile_mask.shape
    m = tile_mask[:, None, :, None].to(torch.float32).expand(
        nKb, bk, nNb, bn).reshape(nKb * bk, nNb * bn)
    return m[:K, :N]


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32) @ b.to(torch.float32)


def block_sparse_matmul_ref(x: torch.Tensor, w: torch.Tensor, tile_mask,
                            block) -> torch.Tensor:
    """x: (M, K) @ (w ⊙ expand(tile_mask)): (K, N) -> (M, N), f32 accumulation."""
    m = expand_tile_mask(tile_mask, block, w.shape[0], w.shape[1]).to(
        device=w.device, dtype=w.dtype)
    return _dot_f32(x, w * m).to(x.dtype)


def int_matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product ``a (…, K) @ b (K, N)`` of int8-range codes.
    On CUDA the product runs in f64 at every K (PyTorch has no integer
    matmul there; f64 holds ``K·128² ≪ 2^53`` exactly, and no TF32 setting
    touches it). On the CPU, while ``K·128² < 2^24`` every partial sum is an
    integer that f32 holds exactly (−128 codes included), so the product
    runs as an f32 matmul; deeper products use the int32 matmul."""
    if a.is_cuda:
        return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)
    k = a.shape[-1]
    if k * 128 * 128 < 2 ** 24:
        return (a.to(torch.float32) @ b.to(torch.float32)).to(torch.int32)
    return a.to(torch.int32) @ b.to(torch.int32)


def int8_matmul_ref(x_codes: torch.Tensor, w_codes: torch.Tensor, scale) -> torch.Tensor:
    """int8 codes GEMM with int32 accumulation and dequant epilogue.

    Bit-exact contract: out = (x_codes · w_codes) * scale computed in int32.
    ``scale`` is a scalar or a per-cout ``(N,)`` row broadcast over rows.
    """
    acc = int_matmul_exact(x_codes, w_codes)
    return acc.to(torch.float32) * scale


def int8_conv_ref(x_codes: torch.Tensor, w_codes: torch.Tensor,
                  scale, stride: int = 1, padding: str = "SAME",
                  bias=None, relu: bool = False) -> torch.Tensor:
    """Fixed-point conv oracle: im2col the int8 activation codes, int32-
    accumulate against the HWIO int8 weight codes, dequant through the
    per-cout ``scale`` row, then bias/ReLU — the exact arithmetic the
    quantized block-sparse kernels must reproduce bitwise."""
    from .conv_lowering import im2col_patches

    kx, ky, cin, cout = w_codes.shape
    p = im2col_patches(x_codes, kx, ky, stride, padding)
    B, Ho, Wo = p.shape[:3]
    out = int8_matmul_ref(p.reshape(B * Ho * Wo, kx * ky * cin),
                          w_codes.reshape(kx * ky * cin, cout), scale)
    if bias is not None:
        out = out + torch.as_tensor(bias, dtype=torch.float32,
                                    device=out.device)
    if relu:
        out = torch.clamp(out, min=0.0)
    return out.reshape(B, Ho, Wo, cout)


def masked_dense_matmul_ref(x: torch.Tensor, w: torch.Tensor, mask) -> torch.Tensor:
    mask = torch.as_tensor(mask, device=w.device)
    return _dot_f32(x, w * mask.to(w.dtype)).to(x.dtype)
