"""int8 fixed-point matmul (the DSP48E1 Q-format arithmetic, GPU edition):
int8 × int8 → int32 accumulation, per-cout dequant epilogue.

The paper's accelerator multiplies Q3.4 activations by Q2.5 coefficients in
the DSP slices; here the same integer arithmetic runs in the hand-written
CUDA kernel ``csrc/int8_matmul.cu`` on the tensor cores (int8 ``mma.sync``).
Accumulation is exact (int32) and the flush is one int → f32 conversion and
one f32 multiply, so the result is bit-identical to ``ref.int8_matmul_ref``
— tests assert equality, not closeness.

``scale`` is the dequant row the flush multiplies the int32 accumulator by:
a per-cout ``(N,)`` vector, or the scalar ``(1,)`` broadcast to every
column (what ``ops.fixed_point_matmul`` passes).

Two implementations of the one function live here:

- :func:`int8_matmul` — the wrapper. For a CUDA tensor it launches the
  kernel (or raises); for a CPU tensor, and only then, it runs the plain
  version.
- :func:`int8_matmul_plain` — the same function in plain PyTorch
  (``ref.int_matmul_exact``, then ``.float() * scale``): the CPU path and
  the yardstick the kernel is held to on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import int_matmul_exact

# the largest caller tiles (bm, bn) the C interface takes: the JAX wrapper's
# tile-alignment contract (M % bm, N % bn). The kernel picks its own output
# tile (kernel_tile).
KERNEL_MAX_BM = 128
KERNEL_MAX_BN = 128

_launches = 0


def launch_count() -> int:
    """CUDA launches of :func:`int8_matmul`'s kernel since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _check(x_codes, w_codes, scale, bm, bk, bn):
    """Validate as the JAX wrapper does; -> (M, K, N, scale as an (N,) f32
    row on x's device)."""
    if x_codes.dtype != torch.int8 or w_codes.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 codes, got {x_codes.dtype} "
                        f"@ {w_codes.dtype}")
    if x_codes.dim() != 2 or w_codes.dim() != 2 or x_codes.shape[1] != w_codes.shape[0]:
        raise ValueError(f"shapes do not chain: {tuple(x_codes.shape)} @ "
                         f"{tuple(w_codes.shape)}")
    M, K = x_codes.shape
    N = w_codes.shape[1]
    if M % bm or K % bk or N % bn:
        raise ValueError(f"shapes must be tile-aligned: ({M}, {K}) @ ({K}, {N}) "
                         f"with bm={bm}, bk={bk}, bn={bn}")
    if tuple(scale.shape) == (1,):
        scale = scale.expand(N)             # scalar: one scale, every cout
    if tuple(scale.shape) != (N,):
        raise ValueError(f"scale must be (1,) or ({N},), got {tuple(scale.shape)}")
    return M, K, N, scale.to(device=x_codes.device, dtype=torch.float32).contiguous()


def int8_matmul_plain(
    x_codes: torch.Tensor,      # (M, K) int8
    w_codes: torch.Tensor,      # (K, N) int8
    scale: torch.Tensor,        # (N,) f32 per-cout dequant row, or (1,) scalar
    *,
    bm: int = 128,
    bk: int = 128,
    bn: int = 128,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`int8_matmul`: the exact int32
    product, converted to f32 and multiplied by the broadcast scale row."""
    _, _, _, scale = _check(x_codes, w_codes, scale, bm, bk, bn)
    return int_matmul_exact(x_codes, w_codes).to(torch.float32) * scale


def int8_matmul(
    x_codes: torch.Tensor,      # (M, K) int8
    w_codes: torch.Tensor,      # (K, N) int8
    scale: torch.Tensor,        # (N,) f32 per-cout dequant row, or (1,) scalar
    *,
    bm: int = 128,
    bk: int = 128,
    bn: int = 128,
) -> torch.Tensor:
    """-> (M, N) f32. ``M``, ``K``, ``N`` must be multiples of ``bm``,
    ``bk``, ``bn`` (the JAX wrapper's tile alignment). The kernel does not
    take them as its tile: it picks its own from M, N and the card's SM
    count (:func:`kernel_tile`) and walks K inside the block. A CUDA
    ``x_codes`` launches the CUDA kernel on the current stream (no
    synchronize) or raises; a CPU ``x_codes`` runs :func:`int8_matmul_plain`."""
    if not x_codes.is_cuda:
        return int8_matmul_plain(x_codes, w_codes, scale, bm=bm, bk=bk, bn=bn)
    global _launches
    M, K, N, scale = _check(x_codes, w_codes, scale, bm, bk, bn)
    if bm > KERNEL_MAX_BM or bn > KERNEL_MAX_BN:
        raise ValueError(f"int8_matmul kernel takes bm <= {KERNEL_MAX_BM} and "
                         f"bn <= {KERNEL_MAX_BN}, got bm={bm}, bn={bn}")
    dev = x_codes.device
    if w_codes.device != dev:
        raise ValueError(f"w_codes is on {w_codes.device}, x_codes on {dev}")
    x_codes, w_codes = x_codes.contiguous(), w_codes.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.hapm_int8_matmul(x_codes.data_ptr(), w_codes.data_ptr(),
                                   scale.data_ptr(), out.data_ptr(), M, K, N, bm,
                                   bn, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "int8_matmul")
    _launches += 1
    return out


def kernel_tile(M: int, N: int, device=None) -> tuple:
    """``(rows, columns, blocks)``: the output tile of one block and the
    block count the kernel launches for an ``(M, N)`` output on ``device``
    (default: the current CUDA device): the first of 128 x 128, 64 x 128 and
    64 x 64 that gives a block for every SM, else 64 x 64. Needs the built
    library and a CUDA device."""
    lib = _build.load()
    tile = (ctypes.c_int * 3)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = lib.hapm_int8_matmul_tile(M, N, tile)
    if err != 0:
        raise RuntimeError(f"int8_matmul: tile query failed with cudaError {err}")
    return tuple(tile)
