"""Schedule-derived pruning groups (the heart of HAPM).

The paper's Algorithm-2 schedule dispatches, at each ``(f_block, g)`` step,
the ``N_CU`` kernels ``k[:, :, g, f_block*N_CU : (f_block+1)*N_CU]`` to the
CU-matrices in lock-step. The DSB can skip that step only when the *whole*
slab is zero — so that slab is the pruning group (``fpga_conv_groups``).

On a tiled matmul kernel the temporal unit of work is one ``(bk, bn)``
weight tile (``tpu_tile_groups`` — the name is kept from the JAX package so
a reader finds the counterpart). Both produce the same :class:`GroupSpec`,
consumed by the single HAPM implementation in :mod:`repro_torch.core.hapm`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _pad_last(w: torch.Tensor, *hi: int) -> torch.Tensor:
    """Zero-pad the trailing ``len(hi)`` dims on their high side;
    ``hi`` is given in dim order (outermost of the padded dims first)."""
    if not any(hi):
        return w
    pads = []
    for h in reversed(hi):
        pads += [0, int(h)]
    return F.pad(w, pads)


def _as_tensor(group_mask, like: torch.Tensor = None) -> torch.Tensor:
    device = None if like is None else like.device
    if isinstance(group_mask, torch.Tensor):
        return group_mask if device is None else group_mask.to(device)
    return torch.as_tensor(np.asarray(group_mask), device=device)


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Partition of one weight array into hardware-schedule groups.

    The partition is expressed as a padded reshape: the weight is (zero-)
    padded to ``padded_shape``, reshaped to interleave group axes, and
    reduced over the per-group axes. ``num_groups`` groups, each of (at most)
    ``group_size`` weights.
    """

    shape: Tuple[int, ...]             # original weight shape
    kind: str                          # "fpga_conv" | "tpu_tile" | "flat"
    num_groups: int
    group_size: int
    # implementation detail used by score/expand:
    _meta: tuple = ()

    # -- API ---------------------------------------------------------------
    def group_scores(self, w: torch.Tensor) -> torch.Tensor:
        """Sum of |w| per group -> (num_groups,). Paper's scoring (Alg. 3 l.7)."""
        raise NotImplementedError

    def expand(self, group_mask) -> torch.Tensor:
        """(num_groups,) {0,1} -> element mask of ``self.shape``."""
        raise NotImplementedError

    def group_elem_counts(self) -> np.ndarray:
        """Actual number of weight elements per group (edge groups may be smaller)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# FPGA conv groups (paper Algorithm 2 / section III)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FpgaConvGroupSpec(GroupSpec):
    """Weight layout (kx, ky, cin, cout); group = (g, f_block):
    all kx*ky spatial taps of N_CU consecutive output filters for one input
    channel. Group ids are ordered (cin-major, then f_block).
    """

    @property
    def n_cu(self) -> int:
        return self._meta[0]

    @property
    def n_fblocks(self) -> int:
        return self._meta[1]

    def _slabs(self, w: torch.Tensor) -> torch.Tensor:
        kx, ky, cin, cout = self.shape
        n_cu, n_fb = self._meta
        w = _pad_last(w, n_fb * n_cu - cout)
        # -> (cin, n_fb, kx*ky*n_cu)
        w = w.reshape(kx * ky, cin, n_fb, n_cu)
        return w.permute(1, 2, 0, 3).reshape(cin, n_fb, kx * ky * n_cu)

    def group_scores(self, w: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.abs(self._slabs(w)), dim=-1).reshape(-1)

    def expand(self, group_mask) -> torch.Tensor:
        kx, ky, cin, cout = self.shape
        n_cu, n_fb = self._meta
        gm = _as_tensor(group_mask).reshape(cin, n_fb)
        m = gm[None, None, :, :, None].expand(kx, ky, cin, n_fb, n_cu)
        m = m.reshape(kx, ky, cin, n_fb * n_cu)[..., :cout]
        return m.to(torch.float32)

    def group_elem_counts(self) -> np.ndarray:
        kx, ky, cin, cout = self.shape
        n_cu, n_fb = self._meta
        counts = np.full((cin, n_fb), kx * ky * n_cu, np.int64)
        rem = cout - (n_fb - 1) * n_cu
        counts[:, -1] = kx * ky * rem
        return counts.reshape(-1)


def fpga_conv_groups(weight_shape: Sequence[int], n_cu: int) -> FpgaConvGroupSpec:
    kx, ky, cin, cout = weight_shape
    n_fb = -(-cout // n_cu)  # ceil
    return FpgaConvGroupSpec(
        shape=tuple(int(d) for d in weight_shape),
        kind="fpga_conv",
        num_groups=cin * n_fb,
        group_size=kx * ky * n_cu,
        _meta=(n_cu, n_fb),
    )


# ---------------------------------------------------------------------------
# Tile groups (one kernel weight tile per group)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TpuTileGroupSpec(GroupSpec):
    """Weight layout (..., K, N); group = one (bk, bn) tile of the trailing
    2-D matmul operand, replicated over leading axes. Tile order is
    (leading..., ki, ni) row-major, matching ``sparse.block_mask`` and the
    block-sparse kernel's grid.
    """

    @property
    def block(self) -> Tuple[int, int]:
        return self._meta[0]

    @property
    def tiles(self) -> Tuple[int, ...]:
        """(leading..., nKb, nNb)."""
        return self._meta[1]

    def _tiled_abs(self, w: torch.Tensor) -> torch.Tensor:
        (bk, bn), tile_shape = self._meta
        *lead, K, N = self.shape
        nKb, nNb = tile_shape[-2], tile_shape[-1]
        w = _pad_last(w, nKb * bk - K, nNb * bn - N)
        w = w.reshape(*lead, nKb, bk, nNb, bn)
        return torch.sum(torch.abs(w), dim=(-3, -1))  # (*lead, nKb, nNb)

    def group_scores(self, w: torch.Tensor) -> torch.Tensor:
        return self._tiled_abs(w).reshape(-1)

    def tile_mask(self, group_mask):
        """(num_groups,) -> (*lead, nKb, nNb) tile mask (kernel-facing)."""
        return group_mask.reshape(self.tiles)

    def expand(self, group_mask) -> torch.Tensor:
        (bk, bn), tile_shape = self._meta
        *lead, K, N = self.shape
        nKb, nNb = tile_shape[-2], tile_shape[-1]
        gm = _as_tensor(group_mask).reshape(*lead, nKb, nNb)
        m = gm[..., :, None, :, None].expand(
            *lead, nKb, bk, nNb, bn).reshape(*lead, nKb * bk, nNb * bn)
        return m[..., :K, :N].to(torch.float32)

    def group_elem_counts(self) -> np.ndarray:
        (bk, bn), tile_shape = self._meta
        *lead, K, N = self.shape
        nKb, nNb = tile_shape[-2], tile_shape[-1]
        kc = np.full(nKb, bk, np.int64)
        kc[-1] = K - (nKb - 1) * bk
        nc = np.full(nNb, bn, np.int64)
        nc[-1] = N - (nNb - 1) * bn
        per2d = np.outer(kc, nc).reshape(-1)
        n_lead = int(np.prod(lead)) if lead else 1
        return np.tile(per2d, n_lead)


def tpu_tile_groups(weight_shape: Sequence[int], block: Tuple[int, int] = (128, 128)) -> TpuTileGroupSpec:
    *lead, K, N = weight_shape
    bk, bn = block
    nKb, nNb = -(-K // bk), -(-N // bn)
    n_lead = int(np.prod(lead)) if lead else 1
    return TpuTileGroupSpec(
        shape=tuple(int(d) for d in weight_shape),
        kind="tpu_tile",
        num_groups=n_lead * nKb * nNb,
        group_size=bk * bn,
        _meta=((bk, bn), (*lead, nKb, nNb)),
    )


# ---------------------------------------------------------------------------
# Flat groups (degenerate: each weight its own group == unstructured)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatGroupSpec(GroupSpec):
    def group_scores(self, w: torch.Tensor) -> torch.Tensor:
        return torch.abs(w).reshape(-1)

    def expand(self, group_mask) -> torch.Tensor:
        return _as_tensor(group_mask).reshape(self.shape).to(torch.float32)

    def group_elem_counts(self) -> np.ndarray:
        return np.ones(self.num_groups, np.int64)


def flat_groups(weight_shape: Sequence[int]) -> FlatGroupSpec:
    n = int(np.prod(weight_shape))
    return FlatGroupSpec(shape=tuple(int(d) for d in weight_shape),
                         kind="flat", num_groups=n, group_size=1)


# ---------------------------------------------------------------------------
# Masked-weight application (never materializes the element mask)
# ---------------------------------------------------------------------------

def apply_group_mask(spec: GroupSpec, w: torch.Tensor, group_mask) -> torch.Tensor:
    """w ⊙ expand(group_mask) computed via tiled reshape-broadcast: the mask
    stays (num_groups,)-sized in memory.
    """
    group_mask = _as_tensor(group_mask, like=w)
    if isinstance(spec, TpuTileGroupSpec):
        (bk, bn), tile_shape = spec._meta
        *lead, K, N = spec.shape
        nKb, nNb = tile_shape[-2], tile_shape[-1]
        gm = group_mask.reshape(*lead, nKb, 1, nNb, 1).to(w.dtype)
        if nKb * bk == K and nNb * bn == N:   # fast path: pure reshape
            wt = w.reshape(*lead, nKb, bk, nNb, bn)
            return (wt * gm).reshape(spec.shape)
        wp = _pad_last(w, nKb * bk - K, nNb * bn - N)
        wt = wp.reshape(*lead, nKb, bk, nNb, bn) * gm
        return wt.reshape(*lead, nKb * bk, nNb * bn)[..., :K, :N]
    if isinstance(spec, FpgaConvGroupSpec):
        kx, ky, cin, cout = spec.shape
        n_cu, n_fb = spec._meta
        gm = group_mask.reshape(cin, n_fb)
        wp = _pad_last(w, n_fb * n_cu - cout)
        wt = wp.reshape(kx, ky, cin, n_fb, n_cu) * gm[None, None, :, :, None].to(w.dtype)
        return wt.reshape(kx, ky, cin, n_fb * n_cu)[..., :cout]
    return w * spec.expand(group_mask).to(w.dtype)
