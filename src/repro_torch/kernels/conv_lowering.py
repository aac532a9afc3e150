"""Im2col lowering: an NHWC conv as a ``(M, kx·ky·cin) @ (kx·ky·cin, cout)``
GEMM, so conv layers can dispatch through the block-sparse matmul kernel.

Layout contract: patches are flattened ``(kx, ky, cin)``-major-to-minor,
matching ``w.reshape(kx*ky*cin, cout)`` for HWIO weights — the order the
:mod:`repro_torch.sparse.conv_plan` layouts build their K axis from.
Padding semantics are XLA's ("SAME": out = ceil(in/s), low pad =
total // 2, the extra row/col goes high; "VALID": no pad).
``torch.nn.functional.conv2d(padding=...)`` pads symmetrically and is
*not* this for stride 2 — every caller here pads explicitly.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def conv_out_size(n: int, k: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-n // stride)
    if padding == "VALID":
        if n < k:
            raise ValueError(
                f"VALID conv has no output: input size {n} is smaller than "
                f"kernel size {k}")
        return (n - k) // stride + 1
    raise ValueError(f"padding must be SAME or VALID, got {padding!r}")


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA 'SAME' split: low = total // 2 (the extra row/col goes high)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def pad_nhwc(x: torch.Tensor, ph: Tuple[int, int], pw: Tuple[int, int],
             pc: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Zero-pad the H, W and C axes of an NHWC tensor by (low, high) each."""
    if not any(ph + pw + pc):
        return x
    return F.pad(x, (pc[0], pc[1], pw[0], pw[1], ph[0], ph[1]))


def im2col_patches(
    x: torch.Tensor,            # (B, H, W, C)
    kx: int,
    ky: int,
    stride: int = 1,
    padding: str = "SAME",
) -> torch.Tensor:
    """-> (B, Ho, Wo, kx, ky, C): the kernel window under every output pixel,
    built from kx*ky strided slices of the padded input."""
    B, H, W, C = x.shape
    if padding == "VALID" and (H < kx or W < ky):
        raise ValueError(
            f"VALID conv has no output: input (B, H, W, C)={(B, H, W, C)} is "
            f"smaller than the (kx, ky)={(kx, ky)} kernel window")
    if padding == "SAME":
        x = pad_nhwc(x, same_pads(H, kx, stride), same_pads(W, ky, stride))
    Ho = conv_out_size(H, kx, stride, padding)
    Wo = conv_out_size(W, ky, stride, padding)
    slices = [
        x[:, i:i + (Ho - 1) * stride + 1:stride,
          j:j + (Wo - 1) * stride + 1:stride, :]
        for i in range(kx) for j in range(ky)
    ]
    p = torch.stack(slices, dim=3)            # (B, Ho, Wo, kx*ky, C)
    return p.reshape(B, Ho, Wo, kx, ky, C)


def conv_via_matmul(
    x: torch.Tensor,            # (B, H, W, Cin)
    w: torch.Tensor,            # (kx, ky, Cin, Cout) HWIO
    stride: int = 1,
    padding: str = "SAME",
    matmul: Optional[Callable] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Conv as im2col + GEMM. ``matmul(p2d, w2d)`` defaults to a dense f32-
    accumulating product (the lowering oracle); pass a bound block-sparse
    kernel to execute pruning.

    ``out_dtype`` sets the default oracle's output dtype (default: ``x``'s
    dtype)."""
    kx, ky, cin, cout = w.shape
    p = im2col_patches(x, kx, ky, stride, padding)
    B, Ho, Wo = p.shape[:3]
    p2d = p.reshape(B * Ho * Wo, kx * ky * cin)
    w2d = w.reshape(kx * ky * cin, cout)
    if matmul is None:
        matmul = lambda a, b: (a.to(torch.float32) @ b.to(torch.float32)).to(
            a.dtype if out_dtype is None else out_dtype)
    return matmul(p2d, w2d).reshape(B, Ho, Wo, cout)
