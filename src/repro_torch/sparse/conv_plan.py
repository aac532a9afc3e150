"""HAPM group masks -> BlockSparsePlan over the im2col weight matrix.

This is where the paper's schedule groups meet the kernel grid: a conv is
lowered to ``patches @ W`` (:mod:`repro_torch.kernels.conv_lowering`) and the
weight matrix is packed onto a tile grid aligned with the pruning groups,
so every pruned group is a *dead tile* the kernel's dispatch plan never
visits — compute and loads both skipped, exactly the FPGA DSB's skipped
(f_block, g) schedule steps hoisted to dispatch time.

Three layouts:

- :class:`FpgaConvGemmLayout` (from ``FpgaConvGroupSpec``): K is channel-
  major — input channel ``g`` owns rows ``[g*bk, g*bk + kx*ky)`` of one
  K-tile (``bk = kx*ky`` rounded up to a multiple of 8); N gives each
  ``f_block`` its own 128-lane tile. Tiles are therefore *exactly* the
  paper's (g, f_block) groups: live grid steps == live groups.
- :class:`PackedFpgaConvGemmLayout` (``conv_gemm_layout(spec,
  packed=True)``): each K-tile packs ``bk // ceil8(kx·ky)`` input channels
  (one 8-aligned row *slot* per channel) and each N-tile packs
  ``bn // n_cu`` f_blocks. A tile is live iff *any* covered (g, f_block)
  group is live; pruned groups inside a live tile are zero slabs in the
  packed (masked) weight, so the GEMM stays exact. Paper-granularity
  accounting survives through :meth:`ConvGemmLayout.tile_occupancy`.
- :class:`TileConvGemmLayout` (from ``TpuTileGroupSpec`` over the 2-D
  ``(kx*ky*cin, cout)`` matrix): groups already are kernel tiles; packing
  is plain zero-padding to the tile multiples.

All layouts pack zeros into the padding, so packed GEMM == conv for any
operand values; dead-tile skipping is additionally exact because pruned
groups are zero slabs in the masked weight.

:func:`make_sparse_conv` binds a layout to the kernels. Weight packing is
hoisted to *bind time* — pass ``weight=`` (and optionally a folded-BN
``bias=`` / ``relu=`` epilogue, fused into the kernel's flush step) and the
returned closure only pads the activation (or packs im2col patches) per
call.

Tables, plans, byte counts and fingerprints here equal the JAX package's
on the same inputs: the host-side half is the same numpy code.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from ..core.groups import (FpgaConvGroupSpec, GroupSpec, TpuTileGroupSpec,
                           apply_group_mask)
from ..core.masks import keystr, to_numpy, tree_flatten_with_path
from .block_mask import BlockSparsePlan, plan_from_tile_mask


def _pad(x: torch.Tensor, pads) -> torch.Tensor:
    """Zero-pad with numpy-style ``((lo, hi), ...)`` per dim (or one
    ``(lo, hi)`` for a 1-D tensor)."""
    if pads and not isinstance(pads[0], (tuple, list)):
        pads = (pads,)
    assert len(pads) == x.dim(), (pads, tuple(x.shape))
    if not any(lo or hi for lo, hi in pads):
        return x
    flat = []
    for lo, hi in reversed(pads):
        flat += [int(lo), int(hi)]
    return F.pad(x, flat)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def mask_fingerprint(group_masks) -> str:
    """Stable hex digest of a per-layer group-mask collection — the
    sparsity-pattern component of the serving exec-cache key
    (:mod:`repro.launch.exec_cache`). Two mask sets fingerprint equal iff
    every layer has the same live/pruned pattern; any HAPM epoch that
    prunes (or revives) a group changes the digest, which is what
    invalidates cached binds.

    Accepts either a ``{path-tuple: mask}`` dict (e.g.
    ``SparseConvExec.group_masks_np``) or an arbitrary pytree of masks
    (e.g. ``HAPMState.group_masks``); entries are digested in sorted path
    order so dict insertion order is irrelevant. Masks are binarized
    (``> 0``) before hashing — only the live/pruned pattern matters, not
    score values.
    """
    import hashlib

    if isinstance(group_masks, dict) and all(
            isinstance(k, tuple) for k in group_masks):
        items = sorted(("/".join(map(str, k)), v)
                       for k, v in group_masks.items())
    else:
        items = sorted((keystr(path), leaf)
                       for path, leaf in tree_flatten_with_path(group_masks))
    h = hashlib.sha1()
    for name, mask in items:
        m = to_numpy(mask)
        h.update(name.encode())
        h.update(str(m.size).encode())
        h.update(np.packbits(m > 0).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class ConvGemmLayout:
    """Packing of one conv weight onto the block-sparse kernel's tile grid."""

    spec: GroupSpec
    block: Tuple[int, int]          # (bk, bn) kernel tile
    tiles: Tuple[int, int]          # (nKb, nNb)

    @property
    def k_packed(self) -> int:
        return self.tiles[0] * self.block[0]

    @property
    def n_packed(self) -> int:
        return self.tiles[1] * self.block[1]

    @property
    def output_lanes(self) -> int:
        """Lanes of each bn-lane output column that ``unpack_output`` can
        read; the lanes past them are padding in every column, so the
        output gradient the backward packs is zero there."""
        return self.block[1]

    # -- API (implemented by subclasses) -----------------------------------
    def tile_mask(self, group_mask) -> np.ndarray:
        """(num_groups,) {0,1} -> (nKb, nNb) bool, host-side."""
        raise NotImplementedError

    def implicit_geometry(self) -> Optional[dict]:
        """Window geometry of the K axis for the implicit-im2col kernel, or
        ``None`` when this layout's K packing isn't channel-major (the
        in-kernel gather contract: K-tile ``t`` covers input channels
        ``[t*cpk, (t+1)*cpk)``, channel slot ``c`` owns rows ``[c*slot,
        c*slot + kx*ky)`` = the (dy, dx) taps in row-major tap order).
        Keys: ``kx, ky, cpk, slot``."""
        return None

    def implicit_index_table(self, group_mask):
        """Offset-augmented dispatch table for the implicit kernel.

        Returns ``(entries, cnt, taps)``: ``entries[j, s] = (k_tile,
        cin_start, cin_count)`` for live step ``s`` of output tile column
        ``j`` (the kernel's BlockSpec consumes column 0; the cin slice is
        what that K-tile id *means* against the NHWC activation), and
        ``taps[t] = (row_slot, dy, dx)`` maps in-tile row ``c*slot +
        row_slot`` to input pixel ``(ho*stride + dy, wo*stride + dx)`` of
        channel ``cin_start + c`` — the gather contract, and the bridge
        back to the materialized im2col rows (property-tested in
        ``tests/test_implicit_conv.py``)."""
        geo = self.implicit_geometry()
        if geo is None:
            raise ValueError(
                f"{type(self).__name__} packs K in a non-channel-major "
                "order — no implicit-im2col table (use the materializing "
                "path)")
        plan = self.plan(group_mask)
        cin = self.spec.shape[2]
        cpk = geo["cpk"]
        nNb, max_nnz = plan.idx.shape
        entries = np.zeros((nNb, max_nnz, 3), np.int32)
        for j in range(nNb):
            for s in range(int(plan.cnt[j])):
                t = int(plan.idx[j, s])
                c0 = t * cpk
                entries[j, s] = (t, c0, max(0, min(cpk, cin - c0)))
        taps = np.asarray([[dy * geo["ky"] + dx, dy, dx]
                           for dy in range(geo["kx"])
                           for dx in range(geo["ky"])], np.int32)
        return entries, plan.cnt.copy(), taps

    def tile_occupancy(self, group_mask) -> Tuple[np.ndarray, np.ndarray]:
        """(live, total) schedule groups covered per tile, (nKb, nNb) ints.

        ``live.sum()`` is the paper-granularity live-step count (== the
        cycle model's DSB steps) regardless of how many groups share a
        tile; for the one-group-per-tile layouts it degenerates to the
        tile mask itself.
        """
        tm = self.tile_mask(group_mask)
        return tm.astype(np.int64), np.ones_like(tm, np.int64)

    def mac_accounting(self, group_mask) -> Tuple[int, int]:
        """(live weight elements, dispatched-tile MAC area) for this layer —
        the single source for padded-MAC utilization (``SparseConvExec`` and
        ``accel.simulator`` aggregate these over the network)."""
        live_tiles = int(self.tile_mask(group_mask).sum())
        gm = np.asarray(group_mask).reshape(-1) > 0
        live_elems = int((gm * self.spec.group_elem_counts()).sum())
        return live_elems, live_tiles * self.block[0] * self.block[1]

    def mac_utilization(self, group_mask) -> float:
        """Live weight elements / MAC area of the *dispatched* tiles — how
        much of the padded tile grid the kernel visits is real work."""
        live_elems, area = self.mac_accounting(group_mask)
        return live_elems / area if area else 0.0

    def plan(self, group_mask) -> BlockSparsePlan:
        return plan_from_tile_mask(self.tile_mask(group_mask), self.block)

    def pack_weight(self, w: torch.Tensor) -> torch.Tensor:
        """(kx, ky, cin, cout) -> (k_packed, n_packed)."""
        raise NotImplementedError

    def pack_bias(self, b: torch.Tensor) -> torch.Tensor:
        """(cout,) -> (n_packed,), lanes aligned with ``pack_weight``."""
        raise NotImplementedError

    def pack_patches(self, patches: torch.Tensor) -> torch.Tensor:
        """(..., kx, ky, cin) im2col patches -> (M, k_packed)."""
        raise NotImplementedError

    def unpack_output(self, out2d: torch.Tensor, lead_shape) -> torch.Tensor:
        """(M, n_packed) -> (*lead_shape, cout)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FpgaConvGemmLayout(ConvGemmLayout):
    def _dims(self):
        kx, ky, cin, cout = self.spec.shape
        return kx, ky, cin, cout, self.spec.n_cu, self.spec.n_fblocks

    @property
    def output_lanes(self) -> int:
        return self.spec.n_cu

    def implicit_geometry(self) -> Optional[dict]:
        kx, ky = self.spec.shape[:2]
        # one channel per K-tile: the whole bk is that channel's slot
        return {"kx": kx, "ky": ky, "cpk": 1, "slot": self.block[0]}

    def tile_mask(self, group_mask) -> np.ndarray:
        kx, ky, cin, cout, n_cu, n_fb = self._dims()
        return np.asarray(group_mask).reshape(cin, n_fb) > 0

    def pack_weight(self, w: torch.Tensor) -> torch.Tensor:
        kx, ky, cin, cout, n_cu, n_fb = self._dims()
        bk, bn = self.block
        kxky = kx * ky
        w2 = w.reshape(kxky, cin, cout).permute(1, 0, 2)
        w2 = _pad(w2, ((0, 0), (0, bk - kxky), (0, n_fb * n_cu - cout)))
        w2 = w2.reshape(cin, bk, n_fb, n_cu)
        w2 = _pad(w2, ((0, 0), (0, 0), (0, 0), (0, bn - n_cu)))
        return w2.reshape(cin * bk, n_fb * bn)

    def pack_bias(self, b: torch.Tensor) -> torch.Tensor:
        kx, ky, cin, cout, n_cu, n_fb = self._dims()
        _, bn = self.block
        b2 = _pad(b, (0, n_fb * n_cu - cout)).reshape(n_fb, n_cu)
        return _pad(b2, ((0, 0), (0, bn - n_cu))).reshape(n_fb * bn)

    def pack_patches(self, patches: torch.Tensor) -> torch.Tensor:
        kx, ky, cin, cout, n_cu, n_fb = self._dims()
        bk, _ = self.block
        kxky = kx * ky
        p = patches.reshape(-1, kxky, cin)
        p = p.permute(0, 2, 1)                   # channel-major K
        p = _pad(p, ((0, 0), (0, 0), (0, bk - kxky)))
        return p.reshape(-1, cin * bk)

    def unpack_output(self, out2d: torch.Tensor, lead_shape) -> torch.Tensor:
        kx, ky, cin, cout, n_cu, n_fb = self._dims()
        _, bn = self.block
        o = out2d.reshape(-1, n_fb, bn)[:, :, :n_cu]
        return o.reshape(-1, n_fb * n_cu)[:, :cout].reshape(*lead_shape, cout)


@dataclasses.dataclass(frozen=True)
class PackedFpgaConvGemmLayout(ConvGemmLayout):
    """Multi-group tiles: ``cpk = bk // ceil8(kx·ky)`` input channels per
    K-tile (channel ``g`` -> tile ``g // cpk``, row slot ``g % cpk``) and
    ``fpn = bn // n_cu`` f_blocks per N-tile (f_block ``f`` -> tile
    ``f // fpn``, lane slot ``f % fpn``). A tile is live iff any covered
    group is — pruned groups inside live tiles are zeros in the packed
    masked weight, so the GEMM stays exact while the grid shrinks by up to
    ``cpk·fpn`` over the one-group-per-tile layout."""

    def _packing(self):
        kx, ky, cin, cout = self.spec.shape
        n_cu, n_fb = self.spec.n_cu, self.spec.n_fblocks
        bk, bn = self.block
        kxky = kx * ky
        slot = _ceil_to(kxky, 8)
        return kxky, cin, cout, n_cu, n_fb, slot, bk // slot, bn // n_cu

    @property
    def output_lanes(self) -> int:
        return self.block[1] // self.spec.n_cu * self.spec.n_cu

    def implicit_geometry(self) -> Optional[dict]:
        kxky, cin, cout, n_cu, n_fb, slot, cpk, fpn = self._packing()
        kx, ky = self.spec.shape[:2]
        return {"kx": kx, "ky": ky, "cpk": cpk, "slot": slot}

    def _group_grid(self, group_mask) -> np.ndarray:
        """(num_groups,) -> (nKb, cpk, nNb, fpn) bool, padded with False."""
        kxky, cin, cout, n_cu, n_fb, slot, cpk, fpn = self._packing()
        nKb, nNb = self.tiles
        g = np.asarray(group_mask).reshape(cin, n_fb) > 0
        g = np.pad(g, ((0, nKb * cpk - cin), (0, nNb * fpn - n_fb)))
        return g.reshape(nKb, cpk, nNb, fpn)

    def tile_mask(self, group_mask) -> np.ndarray:
        return self._group_grid(group_mask).any(axis=(1, 3))

    def tile_occupancy(self, group_mask) -> Tuple[np.ndarray, np.ndarray]:
        live = self._group_grid(group_mask).sum(axis=(1, 3))
        total = self._group_grid(np.ones(self.spec.num_groups)).sum(axis=(1, 3))
        return live.astype(np.int64), total.astype(np.int64)

    def pack_weight(self, w: torch.Tensor) -> torch.Tensor:
        kxky, cin, cout, n_cu, n_fb, slot, cpk, fpn = self._packing()
        nKb, nNb = self.tiles
        bk, bn = self.block
        w2 = w.reshape(kxky, cin, cout).permute(1, 0, 2)
        w2 = _pad(w2, ((0, nKb * cpk - cin), (0, slot - kxky),
                          (0, n_fb * n_cu - cout)))
        w2 = w2.reshape(nKb, cpk * slot, n_fb, n_cu)
        w2 = _pad(w2, ((0, 0), (0, bk - cpk * slot),
                          (0, nNb * fpn - n_fb), (0, 0)))
        w2 = w2.reshape(nKb, bk, nNb, fpn * n_cu)
        w2 = _pad(w2, ((0, 0), (0, 0), (0, 0), (0, bn - fpn * n_cu)))
        return w2.reshape(nKb * bk, nNb * bn)

    def pack_bias(self, b: torch.Tensor) -> torch.Tensor:
        kxky, cin, cout, n_cu, n_fb, slot, cpk, fpn = self._packing()
        nNb = self.tiles[1]
        bn = self.block[1]
        b2 = _pad(b, (0, nNb * fpn * n_cu - cout)).reshape(nNb, fpn * n_cu)
        return _pad(b2, ((0, 0), (0, bn - fpn * n_cu))).reshape(nNb * bn)

    def pack_patches(self, patches: torch.Tensor) -> torch.Tensor:
        kxky, cin, cout, n_cu, n_fb, slot, cpk, fpn = self._packing()
        nKb = self.tiles[0]
        bk = self.block[0]
        p = patches.reshape(-1, kxky, cin)
        p = p.permute(0, 2, 1)                   # channel-major K
        p = _pad(p, ((0, 0), (0, nKb * cpk - cin), (0, slot - kxky)))
        p = p.reshape(-1, nKb, cpk * slot)
        p = _pad(p, ((0, 0), (0, 0), (0, bk - cpk * slot)))
        return p.reshape(-1, nKb * bk)

    def unpack_output(self, out2d: torch.Tensor, lead_shape) -> torch.Tensor:
        kxky, cin, cout, n_cu, n_fb, slot, cpk, fpn = self._packing()
        nNb = self.tiles[1]
        bn = self.block[1]
        o = out2d.reshape(-1, nNb, bn)[:, :, :fpn * n_cu]
        o = o.reshape(-1, nNb * fpn, n_cu)[:, :n_fb, :]
        return o.reshape(-1, n_fb * n_cu)[:, :cout].reshape(*lead_shape, cout)


@dataclasses.dataclass(frozen=True)
class TileConvGemmLayout(ConvGemmLayout):
    def tile_mask(self, group_mask) -> np.ndarray:
        return np.asarray(group_mask).reshape(self.tiles) > 0

    def pack_weight(self, w: torch.Tensor) -> torch.Tensor:
        K, N = self.spec.shape
        w2 = w.reshape(K, N)
        return _pad(w2, ((0, self.k_packed - K), (0, self.n_packed - N)))

    def pack_bias(self, b: torch.Tensor) -> torch.Tensor:
        _, N = self.spec.shape
        return _pad(b, (0, self.n_packed - N))

    def pack_patches(self, patches: torch.Tensor) -> torch.Tensor:
        K, _ = self.spec.shape
        p = patches.reshape(-1, K)
        return _pad(p, ((0, 0), (0, self.k_packed - K)))

    def unpack_output(self, out2d: torch.Tensor, lead_shape) -> torch.Tensor:
        _, N = self.spec.shape
        return out2d[:, :N].reshape(*lead_shape, N)


def conv_gemm_layout(spec: GroupSpec, *, bn: int = 128, packed: bool = False,
                     bk: int = 128) -> ConvGemmLayout:
    """Layout for a conv's im2col GEMM, tile grid aligned with ``spec``.

    ``packed=False`` (default): one (g, f_block) group per tile — exact
    schedule-step accounting, heavy lane padding. ``packed=True``: matrix-
    unit-shaped ``(bk, bn)`` tiles covering many groups — far fewer grid steps
    at the same pruning, accounting via :meth:`ConvGemmLayout.tile_occupancy`.
    """
    if isinstance(spec, FpgaConvGroupSpec):
        kx, ky, cin, cout = spec.shape
        if spec.n_cu > bn:
            raise ValueError(f"n_cu={spec.n_cu} exceeds the {bn}-lane tile")
        kxky = kx * ky
        if packed:
            slot = _ceil_to(kxky, 8)
            bk_eff = max(bk, slot)          # giant kernels: one channel/tile
            cpk, fpn = bk_eff // slot, bn // spec.n_cu
            return PackedFpgaConvGemmLayout(
                spec=spec, block=(bk_eff, bn),
                tiles=(-(-cin // cpk), -(-spec.n_fblocks // fpn)))
        bk_pg = max(8, _ceil_to(kxky, 8))
        return FpgaConvGemmLayout(spec=spec, block=(bk_pg, bn),
                                  tiles=(cin, spec.n_fblocks))
    if isinstance(spec, TpuTileGroupSpec):
        if len(spec.shape) != 2:
            raise ValueError("conv tile specs must cover the 2-D im2col "
                             f"matrix, got shape {spec.shape}")
        nKb, nNb = spec.tiles
        return TileConvGemmLayout(spec=spec, block=spec.block, tiles=(nKb, nNb))
    raise TypeError(f"no conv GEMM layout for {type(spec).__name__}")


def adaptive_bm(m_rows: int, cap: int = 128) -> int:
    """Materializing-path adaptive M-block: the whole (padded-to-8) row
    count when it fits under ``cap``, else ``cap`` — batch-1 tails stop
    padding a 16-row output up to a fixed 128."""
    return min(cap, _ceil_to(max(int(m_rows), 1), 8))


def conv_m_blocks(ho: int, wo: int, batch: int, *, bm="auto",
                  implicit: bool = False) -> Tuple[int, int]:
    """(number of M-blocks, effective bm) for one conv layer's grid —
    the single source for step/MAC accounting (``SparseConvExec``,
    ``accel.simulator``, benches). ``bm`` is an int (fixed, the PR-3
    contract) or ``"auto"`` (adaptive). The implicit kernel blocks on
    whole output rows per image; the materializing path on flat
    ``B·Ho·Wo`` rows."""
    from ..kernels.implicit_conv import choose_m_block

    cap = 128 if bm == "auto" else int(bm)
    if implicit:
        mb = choose_m_block(ho, wo, cap=cap)
        if mb is not None:
            return batch * mb.bpi, mb.bm
    bm_eff = adaptive_bm(batch * ho * wo, cap) if bm == "auto" else cap
    return -(-batch * ho * wo // bm_eff), bm_eff


def conv_hbm_bytes(layout: ConvGemmLayout, group_mask, batch: int, h: int,
                   w: int, stride: int = 1, padding: str = "SAME", *,
                   implicit: bool, bm="auto", dtype_bytes: int = 4,
                   operand_bytes: Optional[int] = None,
                   out_bytes: Optional[int] = None) -> int:
    """Analytic HBM bytes one forward of this conv layer moves — the
    data-movement contract the implicit kernel changes.

    Materializing: read the activation once (im2col), write the packed
    ``(M̂, k_packed)`` patch matrix, then stream one ``(bm, bk)`` patch
    tile + one ``(bk, bn)`` weight tile per live grid step and write the
    ``(M̂, n_packed)`` output. (A lower bound — the im2col/pack
    intermediates add more.)

    Implicit: stream one ``(rows, cols, cpk)`` activation *window* slab
    (what the kernel stages per live step — just the input pixels the
    M-block reads, not the whole padded image) + one weight tile per
    live grid step and write the output — the patch matrix never
    exists.

    ``operand_bytes`` prices the *operand* traffic (activations /
    patches / weights) separately from the f32 output write
    (``dtype_bytes``): pass ``1`` for the int8 Q2.5×Q3.4 execution —
    every per-step slab, patch tile and weight tile shrinks 4×, which is
    where quantized execution banks its bandwidth win. Default ``None``
    = same as ``dtype_bytes`` (the f32 contract).

    ``out_bytes`` prices the *output* write separately: pass ``1`` for
    the streamed contract (the requantizing epilogue emits int8 codes,
    so the flush writes 1 byte/value and the next layer's ingest — the
    operand side of *its* accounting — reads codes back). Default
    ``None`` = ``dtype_bytes`` (the f32 output write the PR-5 quantized
    contract still paid for).
    """
    from ..kernels.conv_lowering import conv_out_size
    from ..kernels.implicit_conv import choose_m_block, window_shape

    ob = dtype_bytes if operand_bytes is None else operand_bytes
    ob_out = dtype_bytes if out_bytes is None else out_bytes
    geo = layout.implicit_geometry()
    kx, ky, cin, cout = layout.spec.shape
    ho, wo = conv_out_size(h, kx, stride, padding), conv_out_size(w, ky, stride, padding)
    plan = layout.plan(group_mask)
    live = int(plan.cnt.sum())
    bk, bn = layout.block
    mb, bm_eff = conv_m_blocks(ho, wo, batch, bm=bm,
                               implicit=implicit and geo is not None)
    steps = mb * live
    w_bytes = steps * bk * bn * ob
    out_write = mb * bm_eff * layout.n_packed * ob_out
    mbk = (choose_m_block(ho, wo, cap=128 if bm == "auto" else int(bm))
           if implicit and geo is not None else None)
    if mbk is not None:
        rows, cols = window_shape(mbk, kx, ky, stride)
        slab = rows * cols * geo["cpk"] * ob
        return steps * slab + w_bytes + out_write
    x_bytes = batch * h * w * cin * ob
    patches = mb * bm_eff * layout.k_packed * ob               # write once
    patch_reads = steps * bm_eff * bk * ob                     # kernel loads
    return x_bytes + patches + patch_reads + w_bytes + out_write


def make_sparse_conv(layout: ConvGemmLayout, group_mask, *, bm="auto",
                     weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     relu: bool = False,
                     implicit: Optional[bool] = None,
                     quant=None,
                     out_quant=None,
                     activation_dsb: bool = False,
                     trainable: bool = False,
                     device=None):
    """Bind a block-sparse kernel to one conv layer's plan.

    Returns ``conv(x, w=None, stride=1, padding="SAME") -> (B, Ho, Wo, cout)``
    computing ``conv(x, w ⊙ expand(group_mask))`` — pruned groups are dead
    tiles the kernel never visits (and, for the packed layout, zero slabs
    inside live tiles). The plan is static: rebind after HAPM prunes more
    groups (an epoch-boundary event).

    ``implicit`` selects the kernel (default ``None`` = auto):
      - ``True`` / auto on the channel-major FPGA layouts: the
        **implicit-im2col** kernel (:mod:`repro_torch.kernels.implicit_conv`)
        gathers kernel windows from the padded NHWC activation itself — the
        ``(B·Ho·Wo, kx·ky·cin)`` patch matrix is never materialized. Falls
        back to the materializing path per call when no whole-row M-block
        fits, when the window would exceed the accounting budget
        :data:`implicit_conv.SLAB_VMEM_BUDGET`, or when it cannot fit a
        thread block's shared memory (:func:`implicit_conv.window_fits_card`).
      - ``False``: the materializing im2col + ``block_sparse_matmul``
        path — the parity oracle, and the only path for
        :class:`TileConvGemmLayout` (its K axis is tap-major).

    ``bm``: M-blocking. ``"auto"`` (default) adapts to the layer —
    whole-output-row blocks for the implicit kernel, ``ceil8(B·Ho·Wo)``
    capped at 128 for the materializing path; an int pins it. An int above
    128 raises ``ValueError`` here when the bind's device is CUDA (the
    kernels' cap); the CPU takes any.

    ``weight``: bind-time prepacking. The masked weight is packed **once**
    here and the closure only pads the activation (implicit) or packs
    im2col patches (materializing) per call. Without it the closure masks
    + packs ``w`` on every call (test path).
    ``bias`` / ``relu``: fused kernel epilogue (per-cout bias add and ReLU
    at the accumulator flush — folded-BN inference entirely in-kernel).

    ``quant`` (a :class:`repro_torch.core.quant.QuantSpec`): the masked
    weight is emitted as **int8 codes** at pack time (pruned groups stay
    exactly zero codes), the per-cout dequant scale row is packed onto the
    same N lanes as the bias, the closure quantizes each call's activation
    to int8 codes, and *both* kernels run int8-operand / int32-accumulate
    passes with the dequant → bias → ReLU epilogue fused at the flush.
    Output is f32. An activation that is *already* int8 codes skips the
    per-call quantize — the streamed layer-to-layer ingest.

    ``out_quant`` (a second :class:`QuantSpec`, requires ``quant``):
    requantize **in-epilogue** — the layer *emits* 1-byte codes the next
    layer's gather consumes directly. The closure then returns int8 codes;
    dequantize at the chain boundary with ``code / out_quant.act_scale``.

    ``activation_dsb`` (requires ``quant``): dual-sided sparsity — the
    implicit kernel skips the products of a live tile when its int8
    activation window is all-zero (bit-exact at every density).
    Best-effort: calls that fall back to the materializing path run
    without the skip, identically exact. ``conv.skip_counts(x, ...)`` runs
    the same bound kernel with the skip counter enabled and returns
    ``(y, stats)`` where ``stats`` is ``{"skipped_steps", "live_steps"}``
    (``None`` on the materializing fallback).

    ``trainable=True``: the closure takes the caller's weight per call
    (``conv(x, w, ...)``; nothing is prepacked, so mid-epoch updates are
    never stale) and is differentiable — a ``torch.autograd.Function`` per
    ``(kx, ky, stride, padding)``. The forward dispatches the same bound
    plan as inference (implicit kernel included) on a per-call packed f32
    weight. The backward runs the kernels too: dX is the **transposed-plan**
    block-sparse GEMM (:func:`block_sparse_matmul`) on the packed output
    gradient, then the transpose of ``im2col → pack_patches`` scatters the
    patch gradients back onto the activation; dW visits only the live tiles
    (:func:`repro_torch.kernels.ops.make_block_sparse_grad_weight`) and
    flows through the transpose of mask-and-pack, so pruned groups receive
    *exactly* zero gradient — HAPM's no-resurrection invariant holds by
    construction. Neither backward GEMM falls through to autograd of a
    plain version. Incompatible with the forward-only ``bias``/``relu``
    epilogue and ``quant`` paths (QAT trains through the f32 fake-quant
    view; this path runs the f32 kernels on whatever view the caller
    passes).

    ``device``: where the bind-time constants (packed weight, epilogue
    rows, dispatch table) live; default: ``weight``'s device, else the
    device of the first call's activation.

    ``conv.plan`` / ``conv.layout`` / ``conv.group_mask`` /
    ``conv.implicit`` / ``conv.quant`` / ``conv.trainable`` expose the
    dispatch accounting; ``conv.compact`` the compacted K operands of a
    prebound int8 bind without ``activation_dsb`` (``None`` elsewhere),
    which K2 runs wherever its window of all channels fits a block (a 1×1
    conv at stride s: on every s-th input pixel at stride 1).
    """
    from ..kernels import implicit_conv as IC
    from ..kernels import ops
    from ..kernels.conv_lowering import conv_out_size, im2col_patches

    if trainable and (quant is not None or bias is not None or relu):
        raise ValueError(
            "trainable sparse convs run the plain f32 kernels — the fused "
            "bias/ReLU epilogue and int8-code paths are inference-only "
            "(fold/quantize at inference bind time instead)")
    if out_quant is not None and quant is None:
        raise ValueError(
            "out_quant requantizes the int8 epilogue — it requires quant "
            "(int8-code operands) as well")
    if activation_dsb and quant is None:
        raise ValueError(
            "activation_dsb skips on exact int8 zero codes — it requires "
            "quant (int8-code operands); f32 zeros are a tolerance "
            "question the kernel refuses to answer")
    gm = to_numpy(group_mask)
    tm = layout.tile_mask(gm)
    plan = plan_from_tile_mask(tm, layout.block)
    geo = layout.implicit_geometry()
    if implicit and geo is None:
        raise ValueError(
            f"implicit=True needs a channel-major K layout; "
            f"{type(layout).__name__} has none — use implicit=False")
    use_implicit = (geo is not None) if implicit is None else bool(implicit)
    if activation_dsb and not use_implicit:
        raise ValueError(
            "activation_dsb lives in the implicit kernel's window gather "
            "— bind with implicit=True (needs a channel-major layout)")
    adaptive = bm == "auto"
    bm_cap = 128 if adaptive else int(bm)
    if device is None and weight is not None:
        device = weight.device
    if (device is not None and torch.device(device).type == "cuda"
            and bm_cap > IC.KERNEL_MAX_BM):
        # before anything lands on the card: the CUDA kernels take at most
        # KERNEL_MAX_BM rows per M-block (the CPU's plain versions any)
        raise ValueError(
            f"bm={bm_cap} exceeds the CUDA kernels' cap of bm <= "
            f"{IC.KERNEL_MAX_BM} rows per M-block — bind with bm='auto' or "
            f"an int <= {IC.KERNEL_MAX_BM}, or on the CPU")
    cout = layout.spec.shape[-1]

    def _f32(v):
        if isinstance(v, torch.Tensor):
            return v.detach().to(device=device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    packed_bias = None if bias is None else layout.pack_bias(_f32(bias))
    # the dequant row is a bind-time constant: it depends on the quant
    # spec's (static or calibrated) scales, never on a per-call weight
    packed_scale = (None if quant is None else layout.pack_bias(
        quant.dequant_row(cout, device).to(torch.float32)))
    # requantize row: one uniform output activation scale per cout lane
    # (padding lanes get scale 0 -> code 0, discarded by unpack_output)
    packed_out_scale = (None if out_quant is None else layout.pack_bias(
        torch.full((cout,), out_quant.act_scale, dtype=torch.float32,
                   device=device)))
    tables = ops.DeviceTables(idx=np.asarray(plan.idx, np.int32),
                              cnt=np.asarray(plan.cnt, np.int32),
                              bias=packed_bias, scale=packed_scale,
                              out_scale=packed_out_scale)
    live_per_block = int(plan.cnt.sum())
    # per M-block of a K2 launch: the K rows it multiplies, and those that
    # hold a real tap (the channels of each live K-tile below cin, kx*ky
    # rows each) — the recorder's K_ROWS / TAP_ROWS
    k_rows_per_block = live_per_block * layout.block[0]
    tap_rows_per_block = 0
    if geo is not None:
        kx, ky, cin = layout.spec.shape[:3]
        tap_rows_per_block = int(IC.column_tap_rows(plan.idx, plan.cnt, kx=kx, ky=ky,
                                                    cin=cin, cpk=geo["cpk"]).sum())
    mms: dict = {}        # materializing kernels, keyed by effective bm

    def _materializing(bm_eff):
        if bm_eff not in mms:
            mms[bm_eff] = ops.make_block_sparse_matmul(
                plan, tm, bm=bm_eff, bias=packed_bias, relu=relu,
                scale=packed_scale, out_scale=packed_out_scale)
        return mms[bm_eff]

    gm_tables = ops.DeviceTables(gm=np.asarray(gm, np.float32))

    def _masked(w):
        spec = layout.spec
        w2 = w.reshape(spec.shape) if tuple(w.shape) != spec.shape else w
        return apply_group_mask(spec, w2,
                                gm_tables.on(w.device)["gm"]).reshape(w.shape)

    def _pack_w(w):
        wm = _masked(w)
        if quant is None:
            return layout.pack_weight(wm)
        # int8 codes packed onto the tile grid: zero-masked groups emit
        # zero codes, padding stays zero codes — the GEMM is exact
        return layout.pack_weight(quant.weight_codes(wm))

    if weight is not None:
        w_packed = _pack_w(weight.detach().to(device)).contiguous()
        bound_hw = tuple(int(d) for d in weight.shape[:2])
    else:
        w_packed, bound_hw = None, None
    # K2 int8 on compacted K operands: each column's tap rows, gathered once
    # here (IC.compact_k); a bind with activation_dsb keeps the padded
    # tiles, whose skip is decided per K-tile window
    compact = None
    if w_packed is not None and quant is not None and use_implicit and not activation_dsb:
        compact = IC.compact_k(w_packed, plan.idx, plan.cnt, kx=kx, ky=ky, cin=cin,
                               cpk=geo["cpk"], slot=geo["slot"], block=layout.block)

    def _run(x, wp, kx, ky, stride, padding, count_skips=False, compact=None):
        """Forward with an already-packed weight ``wp`` (and its
        ``compact`` operands, if bound): the bound plan's implicit kernel
        when it fits, else the materializing path. With ``count_skips``
        returns ``(y, stats)`` — the kernel-side skip counter summed into
        ``{"skipped_steps", "live_steps"}``, ``None`` off the implicit
        path."""
        B, H, W, C = x.shape
        ho = conv_out_size(H, kx, stride, padding)
        wo = conv_out_size(W, ky, stride, padding)
        if wp.device != x.device:
            raise ValueError(
                f"activation on {x.device} but this conv was bound on "
                f"{wp.device} — bind and call on one device")
        if use_implicit:
            mbk = IC.choose_m_block(ho, wo, cap=bm_cap)
            if mbk is not None:
                cpk, slot = geo["cpk"], geo["slot"]
                if compact is not None and kx == ky == 1 and stride > 1:
                    # a 1x1 conv at stride s is the stride-1 conv of every
                    # s-th pixel (no padding either way): a window of all
                    # channels ~s*s times smaller
                    x, stride = x[:, ::stride, ::stride], 1
                rows, cols = IC.window_shape(mbk, kx, ky, stride)
                # the JAX package's accounting rule (two window buffers)...
                slab = 2 * rows * cols * cpk * x.element_size()
                # ...and the card's own: the window must fit a thread block
                if (slab <= IC.SLAB_VMEM_BUDGET
                        and IC.window_fits_card(rows, cols, cpk)):
                    nKb = layout.tiles[0]
                    if compact is not None and not IC.takes_compact_path(rows, cols,
                                                                         nKb * cpk):
                        compact = None
                    xp = IC.pad_input(x, kx, ky, stride, padding, mbk, nKb * cpk)
                    t = tables.on(x.device)
                    res = IC.implicit_block_sparse_conv(
                        xp, wp, t["idx"], t["cnt"], t["bias"], t["scale"],
                        t["out_scale"],
                        kx=kx, ky=ky, stride=stride, mb=mbk,
                        block=layout.block, cpk=cpk, slot=slot, relu=relu,
                        activation_dsb=activation_dsb,
                        count_skips=count_skips, compact=compact)
                    out2d, skips = res if count_skips else (res, None)
                    tracing.count(IC.K_ROWS, B * mbk.bpi * (
                        k_rows_per_block if compact is None else compact.k_rows))
                    tracing.count(IC.TAP_ROWS, B * mbk.bpi * tap_rows_per_block)
                    o = IC.crop_output(out2d, mbk, B, ho, wo)
                    y = layout.unpack_output(
                        o.reshape(B * ho * wo, -1), (B, ho, wo))
                    if count_skips:
                        live = B * mbk.bpi * live_per_block
                        return y, {"skipped_steps": int(skips.sum()),
                                   "live_steps": live}
                    return y
        patches = im2col_patches(x, kx, ky, stride, padding)
        bm_eff = adaptive_bm(B * ho * wo, bm_cap) if adaptive else bm_cap
        out2d = _materializing(bm_eff)(layout.pack_patches(patches), wp)
        y = layout.unpack_output(out2d, (B, ho, wo))
        return (y, None) if count_skips else y

    # -- trainable path: an autograd.Function per conv geometry ------------
    # The forward dispatches the same bound plan as inference (implicit
    # kernel included) but re-packs the caller's weight per call. Backward:
    #   dX: packed dY  --transposed-plan GEMM-->  packed dPatches
    #       --transpose of (im2col -> pack_patches)-->  dX   (tensor glue)
    #   dW: live tiles only (block_sparse_grad_weight), then the transpose
    #       of (mask -> pack_weight) — the group-mask multiply inside _pack_w
    #       zeroes pruned groups exactly, dead tiles were never computed.
    train_fns: dict = {}
    gemms: dict = {}      # the backward's two GEMMs, keyed by effective bm

    def _transpose(fn, primal, cotangent):
        """``vjp(fn, primal)(cotangent)`` for the linear glue (slices,
        reshapes, pads, the mask multiply) around the kernels."""
        with torch.enable_grad():
            p = primal.detach().requires_grad_(True)
            out, = torch.autograd.grad(fn(p), p, cotangent)
        return out

    def _train_fns(kx, ky, stride, padding):
        key = (kx, ky, stride, padding)
        if key in train_fns:
            return train_fns[key]

        def forward(x, w):
            return _run(x, _pack_w(w), kx, ky, stride, padding)

        def backward(x, w, g, want_dx, want_dw):
            B, ho, wo = g.shape[:3]
            m_rows = B * ho * wo
            # pack the output gradient onto the kernel's padded N lanes:
            # unpack_output is a pure slice/reshape, so its transpose is the
            # packing (zeros into the padded lanes)
            g2d = _transpose(lambda o2: layout.unpack_output(o2, (B, ho, wo)),
                             torch.zeros((m_rows, layout.n_packed),
                                         dtype=g.dtype, device=g.device), g)
            bm_eff = adaptive_bm(m_rows, bm_cap) if adaptive else bm_cap
            if bm_eff not in gemms:
                gemms[bm_eff] = ops._BoundBlockSparseMatmul(
                    plan, tm, bm_eff, g_lanes=layout.output_lanes)
            with torch.enable_grad():
                xg = x.detach().requires_grad_(want_dx)
                patches = layout.pack_patches(
                    im2col_patches(xg, kx, ky, stride, padding))
            # dP = dY @ Wp^T on the transposed plan, dWp on the live tiles
            dp, dwp = gemms[bm_eff].backward(patches.detach(), _pack_w(w),
                                             g2d, want_dx, want_dw)
            dx = dw = None
            if want_dx:      # the transpose of im2col -> pack_patches
                dx, = torch.autograd.grad(patches, xg, dp)
                dx = dx.to(x.dtype)
            if want_dw:      # the transpose of mask-and-pack
                dw = _transpose(_pack_w, w, dwp).to(w.dtype)
            return dx, dw

        train_fns[key] = (forward, backward)
        return train_fns[key]

    def _ingest(x):
        if quant is not None and x.dtype != torch.int8:
            return quant.act_codes(x)      # int8 Q3.4 (or calibrated) codes
        return x

    def conv(x, w=None, stride: int = 1, padding: str = "SAME"):
        if w is None:
            if w_packed is None:
                raise ValueError("no weight bound at build time — pass w or "
                                 "rebuild with make_sparse_conv(..., weight=w)")
            return _run(_ingest(x), w_packed, *bound_hw, stride, padding, compact=compact)
        if trainable:
            return ops.KernelVJP.apply(
                x, w, _train_fns(int(w.shape[0]), int(w.shape[1]), stride,
                                 padding))
        return _run(_ingest(x), _pack_w(w), int(w.shape[0]), int(w.shape[1]),
                    stride, padding)

    def skip_counts(x, stride: int = 1, padding: str = "SAME"):
        """Run the bound conv with the kernel-side skip counter on:
        ``(y, {"skipped_steps", "live_steps"})`` — ``y`` identical to
        ``conv(x, ...)`` (the counter is a second output, not a
        different kernel), stats ``None`` when the call fell back to the
        materializing path. Counts actual skips, so a bind without
        ``activation_dsb`` reports 0."""
        if w_packed is None:
            raise ValueError("no weight bound at build time — "
                             "skip_counts needs a prebound conv")
        return _run(_ingest(x), w_packed, *bound_hw, stride, padding,
                    count_skips=True, compact=compact)

    conv.plan = plan
    conv.layout = layout
    conv.group_mask = gm
    conv.prebound = weight is not None
    conv.implicit = use_implicit
    conv.bm = bm
    conv.quant = quant
    conv.out_quant = out_quant
    conv.activation_dsb = activation_dsb
    conv.compact = compact
    conv.trainable = trainable
    conv.skip_counts = skip_counts
    return conv
