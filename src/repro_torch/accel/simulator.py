"""Functional accelerator simulator: fixed-point inference + cycle counting.

Runs the (BN-folded, Q2.5/Q3.4-quantized) CNN exactly as the accelerator
computes it, and prices every conv layer with the Eq.-3 cycle model plus
DSB skips derived from the *actual* weight groups — reproducing the paper's
Table II / Fig. 6 measurement loop without silicon. The times and GOP/s it
reports are outputs of the cycle model for the FPGA boards, not times
measured on the device the simulator runs on.

Activation-side DSB (zero data columns) is measured from real activations
but disabled by default in the headline figure: the paper observes only a
0.79 % win for unpruned models, i.e. the coefficient-group bypass is the
operative mechanism. Whenever sample images are given the simulator still
prices the *dual-sided* (weight + activation) cycle count next to the
weight-only one (``cycles_dual`` / ``dual_dsb_cycle_ratio``), and with
``measure_dsb=True`` additionally runs a real
``ExecSpec(activation_dsb=True)`` bind through the implicit conv kernel's
skip counter so the predicted skip (``1 - data_col_nonzero_frac``) sits
next to the fraction of live grid steps the kernel actually elided.

Where it runs: the two accounting-only binds are host-side and need no
device; the activation capture, the ``measure_dsb`` bind and the accuracy
forward run on ``device`` — the GPU unless the caller passes
``device="cpu"`` (``models.cnn.resolve_device``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..core import quant as Q
from ..core.masks import tree_map
from ..models import cnn
from .config import AcceleratorConfig
from .cycle_model import NetworkCycles, network_cycles

PyTree = Any


@dataclasses.dataclass
class SimulationReport:
    cycles: NetworkCycles
    accel: AcceleratorConfig
    accuracy: Optional[float]
    mean_time_per_image_s: float
    gops: float                      # ops = 2*MACs (standard); paper counts ~1 OP/MAC
    gops_paper_convention: float
    group_sparsity_per_layer: dict
    data_col_nonzero_frac: dict
    # Executed dispatch accounting for the same group masks the cycle
    # model prices, via two accounting-only binds (bind_execution with
    # bind_kernels=False) reported through SparseConvExec.report: the one-
    # group-per-tile layout at fixed bm=128 (dead tiles == skipped
    # (g, f_block) schedule steps by construction) and the packed
    # (128, 128) layout at the production contract — implicit kernel,
    # adaptive bm — i.e. what the serving path actually dispatches (tiles
    # cover many groups, accounting via per-tile occupancy).
    # schedule_steps_* is the layout-independent paper granularity and
    # equals the cycle model's DSB step count.
    grid_steps_per_layer: dict = dataclasses.field(default_factory=dict)
    executed_grid_steps: int = 0
    dense_grid_steps: int = 0
    packed_executed_grid_steps: int = 0
    packed_dense_grid_steps: int = 0
    schedule_steps_live: int = 0
    schedule_steps_total: int = 0
    padded_mac_utilization: float = 0.0      # packed layout, dispatched tiles
    pergroup_mac_utilization: float = 0.0    # one-group-per-tile layout
    # HBM data-movement contract per image on the packed layout (the
    # canonical hbm_bytes_* fields of SparseConvExec.report):
    # materializing (im2col patch matrix in device memory, fixed bm=128)
    # vs implicit (in-kernel window gather from the NHWC activation,
    # adaptive bm), each priced with f32 operands AND with int8 Q2.5×Q3.4
    # operand codes (1-byte slabs/patches/weight tiles, f32 output writes)
    # — and streamed (1-byte operands AND 1-byte output writes: the
    # requantizing epilogue emits Q3.4 codes the next layer ingests).
    # Per-layer numbers sit in grid_steps_per_layer ("hbm_materialized"/
    # "hbm_implicit"/"hbm_implicit_int8"/"hbm_streamed_int8") next to the
    # grid steps; bm_effective_per_layer is the adaptive M-block.
    hbm_bytes_materialized: int = 0
    hbm_bytes_implicit: int = 0
    hbm_bytes_materialized_int8: int = 0
    hbm_bytes_implicit_int8: int = 0
    hbm_bytes_streamed_int8: int = 0
    bm_effective_per_layer: dict = dataclasses.field(default_factory=dict)
    # Dual-sided DSB: the cycle model re-priced with the *measured*
    # per-layer data-column fractions (None without sample images), plus
    # prediction-vs-measurement of the kernel's activation skip. The
    # prediction is 1 - data_col_nonzero_frac (CU_h-column granularity);
    # the measurement is the implicit kernel's own skip counter under an
    # activation_dsb bind — coarser (rows x cols x cpk window) by
    # construction, so measured <= predicted is the expected shape.
    cycles_dual: Optional[NetworkCycles] = None
    dsb_skip_frac_predicted: Optional[float] = None
    dsb_skip_frac_measured: Optional[float] = None
    dsb_skip_per_layer: dict = dataclasses.field(default_factory=dict)

    @property
    def hbm_bytes_ratio(self) -> float:
        return self.hbm_bytes_implicit / max(self.hbm_bytes_materialized, 1)

    @property
    def hbm_bytes_int8_ratio(self) -> float:
        """Quantized-over-f32 operand traffic on the implicit contract —
        what quartering the operand bytes buys on top of pruning."""
        return self.hbm_bytes_implicit_int8 / max(self.hbm_bytes_implicit, 1)

    @property
    def hbm_bytes_streamed_ratio(self) -> float:
        """End-to-end int8 streaming over the f32 implicit contract — what
        pricing the output write at 1 byte buys on top of int8 operands
        (≈0.25: every byte term scales by 1/4)."""
        return self.hbm_bytes_streamed_int8 / max(self.hbm_bytes_implicit, 1)

    @property
    def grid_step_ratio(self) -> float:
        return self.executed_grid_steps / max(self.dense_grid_steps, 1)

    @property
    def packed_grid_step_ratio(self) -> float:
        return self.packed_executed_grid_steps / max(self.packed_dense_grid_steps, 1)

    @property
    def dsb_cycle_ratio(self) -> float:
        return self.cycles.total_dsb / max(self.cycles.total_min, 1)

    @property
    def dual_dsb_cycle_ratio(self) -> Optional[float]:
        """Dual-sided (weight + measured activation) DSB cycles over the
        dense floor — sits next to the weight-only ``dsb_cycle_ratio``.
        None when no sample images were given."""
        if self.cycles_dual is None:
            return None
        return self.cycles_dual.total_dsb / max(self.cycles.total_min, 1)

    def row(self) -> dict:
        return {
            "dsb": self.accel.dsb,
            "fifo_depth": self.accel.fifo_depth,
            "freq_mhz": self.accel.freq_mhz,
            "dsps": self.accel.dsps,
            "accuracy": self.accuracy,
            "mean_time_per_image_ms": self.mean_time_per_image_s * 1e3,
            "gops": self.gops,
            "gops_paper_convention": self.gops_paper_convention,
            "executed_grid_steps": self.executed_grid_steps,
            "dense_grid_steps": self.dense_grid_steps,
            "grid_step_ratio": self.grid_step_ratio,
            "packed_executed_grid_steps": self.packed_executed_grid_steps,
            "packed_dense_grid_steps": self.packed_dense_grid_steps,
            "packed_grid_step_ratio": self.packed_grid_step_ratio,
            "schedule_steps_live": self.schedule_steps_live,
            "schedule_steps_total": self.schedule_steps_total,
            "padded_mac_utilization": self.padded_mac_utilization,
            "pergroup_mac_utilization": self.pergroup_mac_utilization,
            "dsb_cycle_ratio": self.dsb_cycle_ratio,
            "hbm_bytes_materialized": self.hbm_bytes_materialized,
            "hbm_bytes_implicit": self.hbm_bytes_implicit,
            "hbm_bytes_ratio": self.hbm_bytes_ratio,
            "hbm_bytes_materialized_int8": self.hbm_bytes_materialized_int8,
            "hbm_bytes_implicit_int8": self.hbm_bytes_implicit_int8,
            "hbm_bytes_int8_ratio": self.hbm_bytes_int8_ratio,
            "hbm_bytes_streamed_int8": self.hbm_bytes_streamed_int8,
            "hbm_bytes_streamed_ratio": self.hbm_bytes_streamed_ratio,
            "dual_dsb_cycle_ratio": self.dual_dsb_cycle_ratio,
            "dsb_skip_frac_predicted": self.dsb_skip_frac_predicted,
            "dsb_skip_frac_measured": self.dsb_skip_frac_measured,
        }


def _f32_fraction(count: int, n: int) -> float:
    """The f32 mean of a 0/1 array of ``n`` elements holding ``count`` ones,
    formed on the host from the exact count, so it is the same on every
    device and in every summation order. It is formed as the JAX package's
    CPU backend forms ``jnp.mean``: the sum (an exact integer below 2^24)
    times the f32 reciprocal of ``n`` — which differs from a correctly
    rounded ``count / n`` in the last bit for about half of all (count, n)."""
    if n == 0:
        return float("nan")
    return float(np.float32(count) * (np.float32(1.0) / np.float32(n)))


def _data_col_nonzero_frac(act: torch.Tensor, cu_h: int) -> float:
    """Fraction of CU_h-tall data columns containing any non-zero value.
    ``act``: (B, H, W, C) post-quantization activations entering a conv.
    The columns are non-overlapping blocks of ``cu_h`` rows (window and
    stride ``cu_h`` along H); the last ``H mod cu_h`` rows belong to no
    column, as in a VALID window reduction."""
    B, H, W, C = act.shape
    rows = (H // cu_h) * cu_h
    nz = (act[:, :rows].abs() > 0).reshape(B, H // cu_h, cu_h, W, C).any(dim=2)
    return _f32_fraction(int(nz.sum()), nz.numel())


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


def simulate(
    params: PyTree,
    state: PyTree,
    cfg: cnn.ResNetConfig,
    accel: AcceleratorConfig,
    images=None,
    labels=None,
    data_bypass: bool = False,
    measure_dsb: bool = False,
    dsb_sample: int = 4,
    *,
    device=None,
) -> SimulationReport:
    """Price one image's inference (per-image cycles are input-independent
    unless ``data_bypass``) and optionally measure accuracy on (images, labels).

    With images given, the report additionally carries ``cycles_dual`` —
    the cycle model re-run with the measured per-layer data-column
    fractions, i.e. the dual-sided DSB price next to the weight-only one.
    ``measure_dsb=True`` (needs images) further runs a real folded +
    quantized + streamed ``activation_dsb`` bind over ``images[:dsb_sample]``
    and reports the kernel skip counter's ``dsb_skip_frac_measured`` next
    to the column-granularity prediction ``dsb_skip_frac_predicted``.

    ``images`` (B, H, W, 3) and ``labels`` (B,) are tensors or numpy
    arrays; they, ``params`` and ``state`` are moved to ``device`` for the
    forwards (the GPU by default; raises without one)."""
    qcfg = dataclasses.replace(cfg, quantized=True)
    dims = cnn.layer_dims(cfg, params)

    # --- dispatch + HBM accounting via accounting-only binds ---------------
    # Two execs, no kernels (bind_kernels=False — plans/layouts/masks only,
    # no device), each reported through SparseConvExec.report so the
    # simulator prices exactly what the executed path dispatches.
    # quantized=True reproduces this simulator's skippability rule: masks
    # from the Q2.5-quantized weights' zero groups.
    # - per-group layout, materializing fixed bm=128: live tiles ARE the
    #   live (g, f_block) schedule steps per M-block (paper granularity);
    # - packed layout at the production contract (implicit kernel,
    #   adaptive bm): what the kernels actually dispatch.
    pg = cnn.bind_execution(
        params, cfg, bind_kernels=False,
        spec=cnn.ExecSpec(packed=False, quantized=True, implicit=False,
                          bm=128, n_cu=accel.n_cu))
    pk = cnn.bind_execution(
        params, cfg, bind_kernels=False,
        spec=cnn.ExecSpec(packed=True, quantized=True, implicit=True,
                          bm="auto", n_cu=accel.n_cu))
    pg_rep = pg.report(cfg, batch=1, per_layer=True)
    pk_rep = pk.report(cfg, batch=1, per_layer=True)

    group_masks, layer_sparsity, grid_steps, bm_eff_per_layer = [], {}, {}, {}
    for path, _layer in dims:
        name = "/".join(path)
        gm = np.asarray(pg.group_masks_np[path])
        group_masks.append(gm)
        layer_sparsity[name] = float(1.0 - gm.mean())
        pg_l, pk_l = pg_rep["per_layer"][name], pk_rep["per_layer"][name]
        # per-layer HBM contracts priced on the packed (dispatched) layout
        grid_steps[name] = {"executed": pg_l["executed"],
                            "dense": pg_l["dense"],
                            "packed_executed": pk_l["executed"],
                            "packed_dense": pk_l["dense"],
                            "hbm_materialized": pk_l["hbm_materialized"],
                            "hbm_implicit": pk_l["hbm_implicit"],
                            "hbm_materialized_int8": pk_l["hbm_materialized_int8"],
                            "hbm_implicit_int8": pk_l["hbm_implicit_int8"],
                            "hbm_streamed_int8": pk_l["hbm_streamed_int8"]}
        bm_eff_per_layer[name] = pk_l["bm_effective"]

    # --- optional activation-side bypass measurement -----------------------
    data_fracs = [1.0] * len(dims)
    col_fracs = {}
    if images is not None:
        dev = cnn.resolve_device(device)
        to_dev = lambda t: t.to(dev)
        params, state = tree_map(to_dev, params), tree_map(to_dev, state)
        images = _as_tensor(images, dev, torch.float32)
        with torch.no_grad():
            acts = _capture_conv_inputs(params, state, qcfg, images[:64])
        for li, (path, layer) in enumerate(dims):
            f = _data_col_nonzero_frac(acts[li], accel.cu_h)
            col_fracs["/".join(path)] = f
            if data_bypass:
                data_fracs[li] = f

    cyc = network_cycles([d for _, d in dims], accel, group_masks, data_fracs)

    # --- dual-sided pricing + kernel-measured skip -------------------------
    cyc_dual = None
    dsb_pred = dsb_meas = None
    dsb_per_layer = {}
    if col_fracs:
        dual_fracs = [col_fracs["/".join(path)] for path, _ in dims]
        cyc_dual = network_cycles([d for _, d in dims], accel, group_masks,
                                  dual_fracs)
        dsb_pred = 1.0 - float(np.mean(dual_fracs))
        dsb_per_layer = {n: {"predicted_skip": 1.0 - f}
                         for n, f in col_fracs.items()}
    if measure_dsb:
        if images is None:
            raise ValueError("measure_dsb=True needs sample images")
        with torch.no_grad():
            folded = cnn.fold_batchnorm(params, state, cfg)
            dsb_exec = cnn.bind_execution(
                folded, cfg,
                spec=cnn.ExecSpec(folded=True, quantized=True, streamed=True,
                                  implicit=True, activation_dsb=True,
                                  n_cu=accel.n_cu),
                device=dev)
            m = dsb_exec.measure_dsb_skip(folded, images[:dsb_sample], cfg)
        dsb_meas = m["dsb_skip_frac"]
        for name, st_l in m["dsb_per_layer"].items():
            d = dsb_per_layer.setdefault(name, {})
            d["measured_skip"] = (st_l["skipped_steps"] /
                                  max(st_l["live_steps"], 1))
            d["live_steps"] = st_l["live_steps"]

    acc = None
    if images is not None and labels is not None:
        with torch.no_grad():
            logits, _ = cnn.apply(params, state, images, qcfg, train=False)
        hits = torch.argmax(logits, -1) == _as_tensor(labels, dev)
        acc = _f32_fraction(int(hits.sum()), hits.numel())

    t = cyc.seconds(accel, with_dsb=True)
    ops = cyc.total_ops
    return SimulationReport(
        cycles=cyc,
        accel=accel,
        accuracy=acc,
        mean_time_per_image_s=t,
        gops=ops / t / 1e9,
        gops_paper_convention=(ops / 2) / t / 1e9,
        group_sparsity_per_layer=layer_sparsity,
        data_col_nonzero_frac=col_fracs,
        grid_steps_per_layer=grid_steps,
        executed_grid_steps=pg_rep["executed_grid_steps"],
        dense_grid_steps=pg_rep["dense_grid_steps"],
        packed_executed_grid_steps=pk_rep["executed_grid_steps"],
        packed_dense_grid_steps=pk_rep["dense_grid_steps"],
        schedule_steps_live=pk_rep["schedule_steps_live"],
        schedule_steps_total=pk_rep["schedule_steps_total"],
        padded_mac_utilization=pk_rep["padded_mac_utilization"],
        pergroup_mac_utilization=pg_rep["padded_mac_utilization"],
        hbm_bytes_materialized=pk_rep["hbm_bytes_materialized"],
        hbm_bytes_implicit=pk_rep["hbm_bytes_implicit"],
        hbm_bytes_materialized_int8=pk_rep["hbm_bytes_materialized_int8"],
        hbm_bytes_implicit_int8=pk_rep["hbm_bytes_implicit_int8"],
        hbm_bytes_streamed_int8=pk_rep["hbm_bytes_streamed_int8"],
        bm_effective_per_layer=bm_eff_per_layer,
        cycles_dual=cyc_dual,
        dsb_skip_frac_predicted=dsb_pred,
        dsb_skip_frac_measured=dsb_meas,
        dsb_skip_per_layer=dsb_per_layer,
    )


def _capture_conv_inputs(params, state, cfg, x):
    """Forward pass capturing each conv layer's (quantized) input, exec order."""
    acts = []
    qw = lambda w: Q.quantize(w, Q.Q2_5)
    qa = lambda a: Q.quantize(a, Q.Q3_4)
    h = qa(x)       # the accelerator ingests Q3.4 codes, input frame included
    acts.append(h)  # conv0 input
    conv = cnn._conv
    bn = lambda y, p, s: cnn._bn(y, p, s, False, cfg)[0]
    h1 = bn(conv(h, qw(params["conv0"]["w"]), 1), params["bn0"], state["bn0"])
    h = qa(torch.relu(h1))
    for si, n_blocks in enumerate(cfg.stages):
        for bi in range(n_blocks):
            name = f"s{si}b{bi}"
            blk, st = params[name], state[name]
            stride = 2 if (si > 0 and bi == 0) else 1
            acts.append(h)  # conv1 input
            y = bn(conv(h, qw(blk["conv1"]["w"]), stride), blk["bn1"], st["bn1"])
            y = qa(torch.relu(y))
            acts.append(y)  # conv2 input
            y = bn(conv(y, qw(blk["conv2"]["w"]), 1), blk["bn2"], st["bn2"])
            if "proj" in blk:
                acts.append(h)  # proj input
                sc = bn(conv(h, qw(blk["proj"]["w"]), stride), blk["bnp"], st["bnp"])
            else:
                sc = h
            h = qa(torch.relu(y + sc))
    return acts
