#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run ``python3 chip_smoke.py`` from the repository root. It

1. builds the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc`` and
   checks with ``cuobjdump -sass`` that every instance of the implicit conv
   kernel (K2) holds tensor-core instructions: ``IMMA`` in the int8 ones,
   ``HMMA`` in the f32 (3xTF32) and bf16 ones; ``HMMA`` in every instance
   of the weight-gradient kernel (K3) and of the block-sparse matmul's
   float kernel (K1, f32 and bf16), and ``IMMA`` in every instance of K1's
   int8 kernel and of the dense int8 matmul (K4),
2. holds each kernel against its plain PyTorch version on the GPU at the
   layer shapes of the full-width ``ResNetConfig()`` (bit equality for int8
   outputs and skip counters, <= 1e-4 for f32, K2's f32 instance also
   bit-identical across two launches), timing kernel, plain version
   and ``F.conv2d`` as a yardstick, K1's int8 rows also beside
   ``torch._int_mm`` on the same packed operands (``*_ms``: device time per
   launch with the launches queued back to back; ``*_call_ms``: one call on
   an idle device, host-side wrapper included), and each kernel summed over
   the 21 convs of one forward (``kernels_per_forward``); the representative
   geometry also
   at batch 1, serving's smallest bucket; K2's f32 instance again at the
   training batch (128) at every layer geometry in both layouts, the shapes
   the training forward launches (``kernels_f32_train``); K3 there too
   (``kernels_grad_weight``); and K1's f32 dX as the training backward
   launches it, on the transposed plan with the layout's lane count, at
   every geometry past conv0 in both layouts (``kernels_dx_train``, beside
   ``matmul(g, Wpᵀ)``),
3. serves the full-width, HAPM-pruned (0.5), random-weight network through
   ``CnnServer`` in both tile layouts (implicit kernel on all 21 layers), the
   materializing contract in both layouts (K1's int8 kernel on all 21), the
   default command-line contract and every rung of the degradation ladder,
   checking logits against a CPU server that runs the plain versions, and
   proving by launch counts that the kernels ran; then times the implicit
   and the materializing servers at every bucket (``timing``),
4. trains the same network (QAT, batch 128, synthetic CIFAR from a seed)
   for a few SGD steps through ``ExecSpec(trainable=True)`` binds in both
   tile layouts — forward through the implicit conv kernel, dX through the
   matmul kernel on the transposed plan, dW through the weight-gradient
   kernel — checking that the loss falls, that pruned groups' gradients and
   weights stay exactly zero and (f32 network) that the gradients match
   dense autograd in float64 leaf by leaf, and proving by launch counts
   that the kernels ran; then runs the training command line
   (``repro_torch.launch.train_cnn``, which also prices its models on the
   paper's FPGA boards) on a small set at its default bind contract and
   reports which kernels it launched,
5. holds the dense int8 matmul kernel (K4) to its plain version and to
   ``int8_matmul_ref`` bit for bit at the shapes of the JAX package's tests,
   the widest conv's im2col GEMM at batch 128, 4096^3 and a depth whose
   sums pass 2^24, timing it against ``torch._int_mm`` with the block tile
   and block count it picked, and the SM clock and power draw read before
   and after 4096^3; then drives
   ``fixed_point_matmul`` forward and backward on the card against a CPU
   run of the port (the fixed-point path, K4) and takes the device time of
   its forward from the profiler (``fixed_point_timing``),
6. prices the full-width HAPM network against uniform pruning at the same
   element sparsity with ``accel.simulate(measure_dsb=True)`` on the card,
   on the paper's three FPGA boards (the pricing path: the activation
   capture and the accuracy forward on the card, the DSB skip measurement
   through the implicit conv kernel), holding every field of every report
   to a CPU run of the port and asserting the paper's ordering; the
   quickstart (``repro_torch.launch.quickstart``) runs on the card too,
7. runs the executed-sparsity bench twin
   (``benchmarks/bench_sparse_cnn_torch.py``, ``--fast``) on the card as a
   fifth main path (``sparse_cnn_bench``: K1, K2 and K3 at group sparsity
   0/25/50/75 % on the bench's reduced net, every hard assert of the bench
   in force, its JSON written to ``build/chip_smoke/``) and prints the 50 % row's wall
   and device-time ratios beside the bench's three wall-clock floors; then
   binds the full-width HAPM 0.5 network at batch 128 under four execution
   contracts (default ``ExecSpec``, ``dense_fallback=2.0``, ``packed=False``
   and both) for the streamed int8 and the f32 forward, with layers bound,
   launches, device time, wall p50 and logits against the all-bound packed
   contract, and ``simulate``'s measured skip under the default contract
   against every layer bound (``exec_contracts``),
8. runs the serving bench twin (``benchmarks/bench_serving_cnn_torch.py``,
   ``--smoke``) on the card as a sixth main path (``serving_cnn_bench``: K2
   through the streamed servers, every hard assert of the bench in force,
   including bit-equal logits at every bucket and zero wrong answers under
   its chaos scenario, a server with ``policy`` and ``faults`` set; its
   chaos counters must equal the reference's committed row), printing each
   bucket's p50, device time and busy share and both amortization verdicts;
   then serves the full-width network through ``CnnServer`` with a fixed
   ``ExecSpec(bm=64)`` in both tile layouts against a CPU server
   (``serve_bm64_*``),
9. prints one JSON line per phase, then the card's name and power limit, a
   ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.

Any failing phase raises: the exit code is non-zero and no ``ok`` line is
printed. Without a CUDA device the script exits with code 2 before printing
any result. ``--log FILE`` also appends every phase line to a file.
``--baseline`` times an older tree against this one (a copy of that tree
with this script in its root): every phase runs, but the build phase only
reports the SASS counts (such a tree lacks instances the check names, e.g.
K1's int8 tensor-core kernel before it existed) and no ``ok`` line is
printed.

The ``kernels`` line gives each kernel at the layer the network runs most
often: ``ms`` is the device time per launch with launches queued back to
back, ``call_ms`` one call on an idle device. ``bound_ms`` counts what the
convolution needs (real output rows and channels); ``bound_padded_ms`` also
counts the padded lanes and rows the kernel's output array carries.
``launches`` sums the six main paths (serving, training, pricing,
fixed point, the executed-sparsity bench, the serving bench), each counted
from zero just before it is driven;
``launches_by_path`` splits them. K2's entry also has ``by_mode``: its int8
(``streamed``, ``int8``) and f32 instances at the representative geometry,
streamed at batch 1 in both layouts, each beside its bound and the cuDNN
yardstick, and f32 at the training batch in both layouts
(``f32_batch128``). K1's ``by_mode`` has its int8 (``streamed``) and f32
forward rows there and its f32 dX at the training batch in both layouts
(``f32_dx_batch128``, ``f32_dx_batch128_packed``). The ``timing`` phase gives each bucket's device time per kernel
(``device_ms_by_kernel``). The pricing path's times and GOP/s for the FPGA
boards are outputs of the cycle model, not times on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.accel import BOARDS, simulate
from repro_torch.core import (HAPMConfig, apply_masks, full_masks, global_sparsity,
                              hapm_element_masks, hapm_epoch_update, hapm_init,
                              magnitude_masks)
from repro_torch.core.groups import fpga_conv_groups
from repro_torch.core.masks import tree_map
from repro_torch.core.masks import tree_flatten_with_path
from repro_torch.core.quant import QuantSpec
from repro_torch.data.synthetic import SyntheticCifar
from repro_torch.kernels import _build
from repro_torch.kernels import block_sparse_matmul as BSM
from repro_torch.kernels import implicit_conv as IC
from repro_torch.kernels import int8_matmul as I8
from repro_torch.kernels import ref as REF
from repro_torch.kernels.conv_lowering import (conv_out_size, im2col_patches,
                                               pad_nhwc, same_pads)
from repro_torch.kernels.ops import (_pad_rows, fixed_point_matmul,
                                    make_block_sparse_grad_weight)
from repro_torch.launch import quickstart, serve_cnn, train_cnn
from repro_torch.launch.serve_cnn import CnnServer
from repro_torch.models import cnn
from repro_torch.sparse.block_mask import transpose_plan
from repro_torch.sparse.conv_plan import (adaptive_bm, conv_gemm_layout,
                                          plan_from_tile_mask)
from repro_torch.train import cnn_training
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import sgd

# published peaks of one H100 SXM (dense): memory rate, int8 tensor rate,
# f32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "f32": 67e12}
# dense TF32 tensor rate: 3xTF32 takes three of its products for one f32 one
PEAK_TF32_S = 495e12

KERNEL_INFO = {
    "block_sparse_matmul": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/block_sparse_matmul.cu",
        "replaces": "src/repro/kernels/block_sparse_matmul.py:187"},
    "implicit_block_sparse_conv": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/implicit_conv.cu",
        "replaces": "src/repro/kernels/implicit_conv.py:347"},
    "block_sparse_grad_weight": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/block_sparse_grad_weight.cu",
        "replaces": "src/repro/kernels/block_sparse_matmul.py:257"},
    "int8_matmul": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:72"},
}
# the kernels each main path must launch
PATH_KERNELS = {
    "serve": ("block_sparse_matmul", "implicit_block_sparse_conv"),
    "train": ("block_sparse_matmul", "implicit_block_sparse_conv",
              "block_sparse_grad_weight"),
    "price": ("implicit_block_sparse_conv",),
    "fixed_point": ("int8_matmul",),
    "sparse_cnn": ("block_sparse_matmul", "implicit_block_sparse_conv",
                   "block_sparse_grad_weight"),
    "serving_cnn": ("implicit_block_sparse_conv",),
}

F32_TOL = 1e-4          # f32 kernels vs plain: summation order differs
LOGIT_TOL = 1e-5        # int8 contracts: convs exact, only the head's mean+matmul differs
GRAD_W_REL_TOL = 1e-4   # K3 vs plain: x 1e-4 of max(|x|^T |g|) over the live tiles
DX_REL_TOL = 1e-4       # K1's dX vs plain: x 1e-4 of max(|g| |W^T|) over live columns
GRAD_REL_TOL = 1e-2     # f32 training grads through the kernels vs dense autograd in
                        # f64, per leaf, x the leaf's largest f64 gradient; on an
                        # H100 the kernels read at most 5.4e-3 (a BN bias) and the
                        # dense f32 library run 3.8e-3 at batch 128
N_CU = 12
SPARSITY = 0.5
TRAIN_BATCH = 128
TRAIN_LR = 0.05


LOG_PATH = None         # --log: every phase line is also appended here
T_START = time.time()   # every phase line carries its seconds since the start
# the executed-sparsity bench's --fast JSON
SPARSE_CNN_JSON = os.path.join(ROOT, "build", "chip_smoke", "BENCH_sparse_cnn_torch_fast.json")
# the serving bench's --smoke JSON, and the reference's committed one, whose
# chaos row the card's must reproduce: its counters and trace live on a
# virtual clock and do not depend on the weights
SERVING_CNN_JSON = os.path.join(ROOT, "build", "chip_smoke", "BENCH_serving_cnn_torch_fast.json")
SERVING_REF_JSON = os.path.join(ROOT, "BENCH_serving_cnn.json")
CHAOS_COUNTERS = ("fault_kinds", "faults_injected", "resilience", "shed_rate", "degrade_log",
                  "answers_checked", "answers_at_recorded_rung", "wrong_answers",
                  "snapshot_warm_restart")
FIXED_BM = 64           # a fixed M block (<= 128) bound through CnnServer


def emit(phase: str, **fields) -> None:
    line = json.dumps({"phase": phase, "elapsed_s": time.time() - T_START, **fields},
                      default=str)
    print(line, flush=True)
    if LOG_PATH is not None:
        with open(LOG_PATH, "a") as f:
            f.write(line + "\n")


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


# K2's instances, by the name of their kernel templates: int8 codes, and the
# f32 / bf16 operands (told apart by the bf16 type in the mangled name);
# K3's and K1's float ones (f32 / bf16 operands; 16-byte or element copies;
# narrow or wide lanes); K1's int8 ones (16-, 8-, 4-byte or element copies)
K2_INT8_KERNEL = "implicit_conv_kernel_imma"
K2_FLOAT_KERNEL = "implicit_conv_kernel"
K3_KERNEL = "grad_weight_stack_kernel"
K1_FLOAT_KERNEL = "block_sparse_matmul_mma_kernel"
K1_INT8_KERNEL = "block_sparse_matmul_imma_kernel"
K4_KERNEL = "int8_matmul_imma_kernel"


def tensor_core_instances(require: bool = True) -> dict:
    """{"int8": {instance: IMMA instructions}, "f32": {instance: HMMA
    instructions}, "bf16": {...}} for K2, {"k3_f32": ..., "k3_bf16": ...}
    for K3, {"k1_f32": ..., "k1_bf16": ...} for K1's float instances and
    {"k1_int8": ...} (IMMA) for its int8 ones, {"k4": ...} (IMMA) for K4's,
    from ``cuobjdump -sass`` of the
    built library, and "k2_int8_sass": {instance: sha1 of its instructions}
    (addresses and encodings dropped), so that two builds of K2 can be told
    equal. With ``require`` it raises unless each of the four int8 instances
    of K2 (one per m16 tiles per block) holds integer tensor-core (IMMA)
    instructions, each of its four f32 and four bf16 instances holds float
    ones (HMMA), each of K3's and of K1's four f32 and four bf16 instances
    (16-byte or element copies, narrow or wide lanes) holds HMMA, and each of
    K1's four int8 instances and each of K4's twelve holds IMMA: the proof
    that all of K1's, K2's, K3's and K4's products run on the tensor cores."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path())], text=True,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300)
    if sass.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {sass.stdout[-2000:]}")
    counts, text, fn = {}, {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"IMMA": 0, "HMMA": 0}
            text[fn] = hashlib.sha1()
        elif fn is not None:
            for op in ("IMMA", "HMMA"):
                if op in line:
                    counts[fn][op] += 1
            ins = line.split("*/", 1)[-1].split("/*", 1)[0].strip()
            if ins:
                text[fn].update(ins.encode())
    k2 = {f: n for f, n in counts.items() if K2_FLOAT_KERNEL in f}
    out = {"int8": {f: n["IMMA"] for f, n in k2.items() if K2_INT8_KERNEL in f}}
    out["k2_int8_sass"] = {f: text[f].hexdigest() for f in out["int8"]}
    floats = {f: n["HMMA"] for f, n in k2.items() if K2_INT8_KERNEL not in f}
    out["bf16"] = {f: n for f, n in floats.items() if "bfloat16" in f}
    out["f32"] = {f: n for f, n in floats.items() if "bfloat16" not in f}
    out["k1_int8"] = {f: n["IMMA"] for f, n in counts.items() if K1_INT8_KERNEL in f}
    out["k4"] = {f: n["IMMA"] for f, n in counts.items() if K4_KERNEL in f}
    wanted = [("K2", kind, op, out[kind]) for kind, op in
              (("int8", "IMMA"), ("f32", "HMMA"), ("bf16", "HMMA"))]
    wanted.append(("K1", "int8", "IMMA", out["k1_int8"]))
    wanted.append(("K4", "int8", "IMMA", out["k4"]))
    for tag, name in (("k3", K3_KERNEL), ("k1", K1_FLOAT_KERNEL)):
        found = {f: n["HMMA"] for f, n in counts.items() if name in f}
        out[f"{tag}_bf16"] = {f: n for f, n in found.items() if "bfloat16" in f}
        out[f"{tag}_f32"] = {f: n for f, n in found.items() if "bfloat16" not in f}
        for kind in ("f32", "bf16"):
            wanted.append((tag.upper(), kind, "HMMA", out[f"{tag}_{kind}"]))
    for tag, kind, op, found in wanted:
        # K4: three block tiles x four copy widths; the others: four or more
        if require and (len(found) < (12 if tag == "K4" else 4) or not all(found.values())):
            raise AssertionError(f"{tag}'s {kind} instances lack {op} instructions: {found}")
    return out


def resource_usage(name: str) -> dict:
    """{instance: {"REG": registers a thread, "LOCAL": local (spill) bytes}}
    of the kernels whose mangled name holds ``name``, from ``cuobjdump
    -res-usage`` of the built library (auxiliary: empty if the tool prints
    nothing it can read)."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-res-usage", str(_build.library_path())], text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300)
    out, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function" in line:
            fn = line.split("Function", 1)[1].strip(" :")
        elif fn is not None and name in fn and "REG:" in line:
            fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
            out[fn] = {k: int(fields[k]) for k in ("REG", "LOCAL") if fields.get(k, "").isdigit()}
            fn = None
    return out


def sync(device) -> None:
    torch.cuda.synchronize(device)


def time_ms(fn, device, reps: int, warmup: int = 3) -> float:
    """Median time of one ``fn()`` call in ms as its caller sees it on an
    idle device: CUDA events around each call (host-side wrapper work
    included)."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


_BUSY = {}


def device_ms(fn, device, reps: int, rounds: int = 5) -> float:
    """Device time of one ``fn()`` in ms with the host taken out: a long
    matrix product keeps the GPU busy while the host enqueues ``reps`` calls
    behind it, so the calls then run back to back and the events around them
    measure the device alone. Median over ``rounds``. (Inputs are re-read
    from a warm L2, as a serving layer finds what the previous layer wrote.)"""
    if device not in _BUSY:
        _BUSY[device] = torch.randn(8192, 8192, device=device)
    big = _BUSY[device]
    fn()
    sync(device)
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.mm(big, big)             # ~20 ms of f32 work ahead of the queue
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


# ---------------------------------------------------------------------------
# model and data, made from a seed with numpy
# ---------------------------------------------------------------------------

def numpy_model(cfg: cnn.ResNetConfig, seed: int):
    """(params, state) as nested dicts of numpy arrays with the package's
    keys: He-normal conv weights, non-trivial BN statistics (so folding and
    per-cout calibration do real work)."""
    rs = np.random.RandomState(seed)

    def conv(kx, ky, cin, cout):
        return {"w": (rs.randn(kx, ky, cin, cout)
                      * np.sqrt(2.0 / (kx * ky * cin))).astype(np.float32)}

    def bn(c):
        return ({"scale": rs.uniform(0.5, 1.5, c).astype(np.float32),
                 "bias": (0.1 * rs.randn(c)).astype(np.float32)},
                {"mean": (0.1 * rs.randn(c)).astype(np.float32),
                 "var": rs.uniform(0.5, 1.5, c).astype(np.float32)})

    params = {"conv0": conv(3, 3, cfg.in_channels, cfg.widths[0])}
    state = {}
    params["bn0"], state["bn0"] = bn(cfg.widths[0])
    cin = cfg.widths[0]
    for si, (n_blocks, width) in enumerate(zip(cfg.stages, cfg.widths)):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk, st = {}, {}
            blk["conv1"] = conv(3, 3, cin, width)
            blk["bn1"], st["bn1"] = bn(width)
            blk["conv2"] = conv(3, 3, width, width)
            blk["bn2"], st["bn2"] = bn(width)
            if stride != 1 or cin != width:
                blk["proj"] = conv(1, 1, cin, width)
                blk["bnp"], st["bnp"] = bn(width)
            params[f"s{si}b{bi}"], state[f"s{si}b{bi}"] = blk, st
            cin = width
    params["fc"] = {"w": (rs.randn(cin, cfg.num_classes)
                          * np.sqrt(1.0 / cin)).astype(np.float32),
                    "b": np.zeros(cfg.num_classes, np.float32)}
    return params, state


def hapm_model(cfg, seed, n_cu, device):
    """The seeded model on ``device`` with HAPM group sparsity 0.5 applied
    (one epoch, as ``serve_cnn.main`` prunes): (pruned params, BN state,
    element masks on ``device``, group specs, HAPM state)."""
    params, state = cnn.params_from_numpy(*numpy_model(cfg, seed), device=device)
    specs = cnn.conv_group_specs(params, n_cu)
    hcfg = HAPMConfig(SPARSITY, 1)
    st = hapm_epoch_update(hapm_init(specs, hcfg), specs, params, hcfg)
    masks = tree_map(lambda m: m.to(device), hapm_element_masks(specs, st))
    return apply_masks(params, masks), state, masks, specs, st


# ---------------------------------------------------------------------------
# phase: kernels against their plain versions
# ---------------------------------------------------------------------------

def layer_geometries(cfg: cnn.ResNetConfig):
    """One (name, H, stride, k, cin, cout) per distinct conv geometry of the
    network, in execution order."""
    seen, out = set(), []
    for g in all_layer_geometries(cfg):
        if g[1:] not in seen:
            seen.add(g[1:])
            out.append(g)
    return out


def all_layer_geometries(cfg: cnn.ResNetConfig):
    """(name, H, stride, k, cin, cout) of every conv of the network, in
    execution order."""
    feat, cin = cfg.image_size, cfg.in_channels
    geoms = [("conv0", feat, 1, 3, cin, cfg.widths[0])]
    cin = cfg.widths[0]
    for si, n_blocks in enumerate(cfg.stages):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            width = cfg.widths[si]
            o = -(-feat // stride)
            geoms.append((f"s{si}b{bi}/conv1", feat, stride, 3, cin, width))
            geoms.append((f"s{si}b{bi}/conv2", o, 1, 3, width, width))
            if stride != 1 or cin != width:
                geoms.append((f"s{si}b{bi}/proj", feat, stride, 1, cin, width))
            feat, cin = o, width
    return geoms


def make_case(geom, packed: bool, mode: str, batch: int, n_cu: int, device,
              rs: np.random.RandomState, k1: bool = True):
    """Operands of both kernels for one conv layer, as ``make_sparse_conv``
    would hand them over: packed (masked) weight, dispatch table, epilogue
    rows, the padded activation (implicit kernel) and, unless ``k1`` is
    False, the packed patch matrix (matmul kernel). ``mode``: "f32", "int8"
    (f32 out) or "streamed" (int8 codes out, activation-DSB with skip
    counting). Half the groups are pruned at random and the last f_block
    column entirely, so one output tile column has cnt == 0 in the unpacked
    layout."""
    name, H, stride, k, cin, cout = geom
    spec = fpga_conv_groups((k, k, cin, cout), n_cu)
    layout = conv_gemm_layout(spec, packed=packed)
    gm = (rs.rand(cin, spec.n_fblocks) > SPARSITY).astype(np.float32)
    gm[:, -1] = 0.0
    gm = gm.reshape(-1)
    w = (rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
    bias = (0.1 * rs.randn(cout)).astype(np.float32)
    # post-ReLU-like activation with whole zero regions (exercises the skip)
    x = np.maximum(rs.randn(batch, H, H, cin), 0).astype(np.float32)
    x[: batch // 2, : H // 2] = 0.0
    w_t = torch.from_numpy(w).to(device)
    x_t = torch.from_numpy(x).to(device)
    wm = spec.expand(gm).to(device) * w_t
    quant = None if mode == "f32" else QuantSpec.calibrate(w_t)
    if quant is None:
        wp, xin = layout.pack_weight(wm), x_t
        scale = out_scale = None
    else:
        wp, xin = layout.pack_weight(quant.weight_codes(wm)), quant.act_codes(x_t)
        scale = layout.pack_bias(quant.dequant_row(cout, device))
        out_scale = (layout.pack_bias(torch.full((cout,), QuantSpec().act_scale,
                                                 device=device))
                     if mode == "streamed" else None)
    plan = plan_from_tile_mask(layout.tile_mask(gm), layout.block)
    idx = torch.from_numpy(plan.idx).to(device)
    cnt = torch.from_numpy(plan.cnt).to(device)
    pbias = layout.pack_bias(torch.from_numpy(bias).to(device))
    ho = conv_out_size(H, k, stride, "SAME")
    mb = IC.choose_m_block(ho, ho)
    geo = layout.implicit_geometry()
    xp = IC.pad_input(xin, k, k, stride, "SAME", mb, layout.tiles[0] * geo["cpk"])
    bm1 = adaptive_bm(batch * ho * ho)
    p2d = (_pad_rows(layout.pack_patches(im2col_patches(xin, k, k, stride, "SAME")), bm1)[0]
           if k1 else torch.empty((batch * mb.bpi * mb.bm, 0), device=device))
    itemsize = xin.element_size()
    out_itemsize = 1 if mode == "streamed" else 4
    real_out = batch * ho * ho * cout
    live_tiles = int(plan.cnt.sum())
    live_k = len({int(t) for j in range(plan.idx.shape[0])
                  for t in plan.idx[j, :plan.cnt[j]]})
    live_elems, _ = layout.mac_accounting(gm)
    n_rows = 1 + (scale is not None) + (out_scale is not None)
    table_bytes = plan.idx.nbytes + plan.cnt.nbytes
    w_bytes = live_tiles * layout.block[0] * layout.block[1] * itemsize
    ops = 2 * batch * ho * ho * live_elems
    peak = PEAK_OPS_S["f32" if mode == "f32" else "int8"]

    def bound(in_bytes, out_rows):
        """(ms, by, padded ms). The bound charges the output and the
        epilogue rows at the layer's real size (ho * wo rows, cout
        channels); the padded figure charges the array the kernel writes
        (rows padded to the M-block, channels to the tile's lanes), which
        on a narrow layer is most of its bytes."""
        fixed = in_bytes + w_bytes + table_bytes
        real = fixed + n_rows * cout * 4 + real_out * out_itemsize
        padded = (fixed + n_rows * layout.n_packed * 4
                  + out_rows * layout.n_packed * out_itemsize)
        t_b, t_o = real / PEAK_BYTES_S, ops / peak
        return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
                max(padded / PEAK_BYTES_S, t_o) * 1e3)

    # each input byte once: the activation channels / patch columns of the
    # K-tiles that are live in some column, each live weight tile, the rows
    # and the table; each output byte once
    k2_in = batch * xp.shape[1] * xp.shape[2] * live_k * geo["cpk"] * itemsize
    k1_in = p2d.shape[0] * live_k * layout.block[0] * itemsize
    return {
        "name": name, "packed": packed, "mode": mode, "batch": batch,
        "k": k, "stride": stride, "H": H, "cin": cin, "cout": cout, "ho": ho,
        "x": x_t, "w": w_t, "layout": layout,
        "common": dict(w=wp.contiguous(), idx=idx, cnt=cnt, bias=pbias,
                       scale=scale, out_scale=out_scale),
        "k2": dict(xp=xp.contiguous(), kx=k, ky=k, stride=stride, mb=mb,
                   block=layout.block, cpk=geo["cpk"], slot=geo["slot"],
                   relu=True, activation_dsb=(mode == "streamed"),
                   count_skips=(mode == "streamed")),
        "k1": dict(x=p2d.contiguous(), block=layout.block, bm=bm1, relu=True),
        "bound_k2": bound(k2_in, batch * mb.bpi * mb.bm),
        "bound_k1": bound(k1_in, p2d.shape[0]),
    }


def run_k2(fn, case):
    c, k2 = case["common"], case["k2"]
    return fn(k2["xp"], c["w"], c["idx"], c["cnt"], c["bias"], c["scale"],
              c["out_scale"], **{k: v for k, v in k2.items() if k != "xp"})


def run_k1(fn, case):
    c, k1 = case["common"], case["k1"]
    return fn(k1["x"], c["w"], c["idx"], c["cnt"], c["bias"], c["scale"],
              c["out_scale"], block=k1["block"], bm=k1["bm"], relu=k1["relu"])


def compare(name: str, got, want, case) -> float:
    """Max abs error kernel vs plain; raises unless int8 outputs (and skip
    counters) are bit-equal and float outputs within F32_TOL (f32 operands:
    other summation order) or exactly equal (int8 operands: exact integer
    accumulation, identical epilogue)."""
    label = f"{name} {case['name']} packed={case['packed']} mode={case['mode']}"
    if isinstance(got, tuple):
        (got, skips_k), (want, skips_p) = got, want
        if not torch.equal(skips_k, skips_p):
            raise AssertionError(f"{label}: skip counters differ "
                                 f"({int(skips_k.sum())} vs {int(skips_p.sum())})")
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
    if not bool(torch.isfinite(got.to(torch.float32)).all()):
        raise AssertionError(f"{label}: non-finite output")
    tol = F32_TOL if case["mode"] == "f32" else 0.0
    if err > tol:
        raise AssertionError(f"{label}: max abs err {err} > {tol}")
    return err


# device-side kernel names of this repo's CUDA kernels, by the kernel they
# belong to
OWN_KERNELS = {"implicit_block_sparse_conv": ("implicit_conv_kernel",),
               "block_sparse_matmul": (K1_INT8_KERNEL, K1_FLOAT_KERNEL),
               "block_sparse_grad_weight": (K3_KERNEL, "grad_weight_reduce_kernel"),
               "int8_matmul": (K4_KERNEL,)}


def profiler_device_ms(fn, device, reps: int):
    """Device time per ``fn()`` call from the profiler, as a cross-check of
    ``device_ms`` and as the split of a request: ``{"total_ms": all GPU
    kernels and copies that ``reps`` calls put on the device, per call,
    "kernels_ms": the share of this repo's own CUDA kernels, "by_kernel":
    that share per kernel}``. Only
    device-side events are summed (an operator's host-side event repeats
    its kernels' time). ``None`` where the profiler cannot trace the device
    or records no device time. (``fn`` has already run once,
    unprofiled, when tracing starts: an error of ``fn`` itself is not hidden.)"""
    fn()
    sync(device)
    try:
        by_key = kernels.profile_device_us(fn, reps, device)
    except RuntimeError as e:       # no device tracing here: an auxiliary
        print(f"chip_smoke: profiler unavailable ({e})", file=sys.stderr)
        return None                 # figure is missing, nothing is wrong
    total_us = sum(by_key.values())
    by_kernel = {kname: sum(t for key, t in by_key.items() if any(n in key for n in names))
                 for kname, names in OWN_KERNELS.items()}
    if total_us <= 0:
        return None
    return {"total_ms": total_us / reps / 1e3,
            "kernels_ms": sum(by_kernel.values()) / reps / 1e3,
            "by_kernel": {k: v / reps / 1e3 for k, v in by_kernel.items()}}


def library_ms(case, device, reps) -> float:
    """``F.conv2d`` through cuDNN (f32, TF32 off) on the same layer and
    batch — a yardstick only; the port's bound path never calls it."""
    k, stride = case["k"], case["stride"]
    x, w = case["x"], case["w"]
    xn = pad_nhwc(x, same_pads(x.shape[1], k, stride),
                  same_pads(x.shape[2], k, stride)).permute(0, 3, 1, 2).contiguous()
    wn = w.permute(3, 2, 0, 1).contiguous()

    fn = lambda: F.conv2d(xn, wn, stride=stride)
    # cuDNN on, TF32 off (flags() turns cuDNN off unless it is asked for)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        if case.get("profile"):
            prof = profiler_device_ms(fn, device, reps)
            case["library_profiler_ms"] = None if prof is None else prof["total_ms"]
        return device_ms(fn, device, reps)


def kernel_case_row(case, device, reps: int, plain_reps: int, worst,
                    k1: bool = True) -> dict:
    """Both conv kernels (K2 alone unless ``k1``) on one case: held to
    their plain versions (raises on a difference; K2's f32 instance also
    launched twice, bit-identical), timed beside their bounds and the cuDNN
    yardstick."""
    row = {k: case[k] for k in ("name", "packed", "mode", "batch",
                                "H", "stride", "k", "cin", "cout")}
    row["live_tiles"] = int(case["common"]["cnt"].sum())
    row["pruned_columns"] = int((case["common"]["cnt"] == 0).sum())
    for kname, run, kern, plain, bkey in (
            ("implicit_block_sparse_conv", run_k2,
             IC.implicit_block_sparse_conv,
             IC.implicit_block_sparse_conv_plain, "bound_k2"),
            ("block_sparse_matmul", run_k1, BSM.block_sparse_matmul,
             BSM.block_sparse_matmul_plain, "bound_k1"))[:2 if k1 else 1]:
        got = run(kern, case)
        if kname == "implicit_block_sparse_conv" and case["mode"] == "f32":
            again = run(kern, case)
            sync(device)
            if not torch.equal(got, again):
                raise AssertionError(f"{kname} {case['name']} packed={case['packed']} "
                                     f"batch={case['batch']} f32: two launches differ")
            row["k2_bit_identical"] = True
        sync(device)
        want = run(plain, case)
        err = compare(kname, got, want, case)
        worst[kname] = max(worst[kname], err)
        tag = "k2" if kname.startswith("implicit") else "k1"
        row[f"{tag}_max_abs_err"] = err
        row[f"{tag}_ms"] = device_ms(lambda: run(kern, case), device, reps)
        row[f"{tag}_call_ms"] = time_ms(lambda: run(kern, case), device, reps)
        row[f"{tag}_plain_ms"] = time_ms(lambda: run(plain, case),
                                         device, plain_reps, warmup=1)
        (row[f"{tag}_bound_ms"], row[f"{tag}_bound_by"],
         row[f"{tag}_bound_padded_ms"]) = case[bkey]
        if isinstance(got, tuple):
            row["skipped_steps"] = int(got[1].sum())
            row["live_steps"] = int(got[1].shape[0]) * row["live_tiles"]
    if case.get("profile"):
        for tag, run, kern in (("k2", run_k2, IC.implicit_block_sparse_conv),
                               ("k1", run_k1, BSM.block_sparse_matmul))[:2 if k1 else 1]:
            prof = profiler_device_ms(lambda: run(kern, case), device, reps)
            row[f"{tag}_profiler_ms"] = None if prof is None else prof["total_ms"]
    row["library_ms"] = library_ms(case, device, reps)
    if case.get("profile"):
        row["library_profiler_ms"] = case.get("library_profiler_ms")
    if k1:
        row["k1_ms_div_library"] = row["k1_ms"] / row["library_ms"]
        if case["mode"] != "f32":
            row["k1_int_mm_ms"] = int_mm_ms(case, device, reps)
    return row


def int_mm_ms(case, device, reps):
    """``torch._int_mm(patches, Wp)`` through cuBLAS on K1's packed int8
    operands: the dense product (dead tiles included, no epilogue), a
    yardstick only; None where cuBLAS refuses the shape."""
    x, w = case["k1"]["x"], case["common"]["w"]
    try:
        return device_ms(lambda: torch._int_mm(x, w), device, reps)
    except RuntimeError as e:
        print(f"chip_smoke: _int_mm refused {tuple(x.shape)} x {tuple(w.shape)} "
              f"({str(e).splitlines()[0]})", file=sys.stderr)
        return None


def per_forward(cfg, rows, batch):
    """Each kernel's time summed over the 21 convs of one forward at
    ``batch`` (every geometry's row times the convs that share it), per
    layout and mode, beside cuDNN's and (int8) ``_int_mm``'s."""
    count = {}
    for g in all_layer_geometries(cfg):
        count[g[1:]] = count.get(g[1:], 0) + 1
    out = {}
    for r in rows:
        if r["batch"] != batch:
            continue
        n = count[(r["H"], r["stride"], r["k"], r["cin"], r["cout"])]
        d = out.setdefault(f"{'packed' if r['packed'] else 'unpacked'}_{r['mode']}",
                           {"convs": 0, "k1_ms": 0.0, "k2_ms": 0.0, "library_ms": 0.0,
                            "k1_int_mm_ms": 0.0})
        d["convs"] += n
        for k in ("k1_ms", "k2_ms", "library_ms", "k1_int_mm_ms"):
            if d[k] is not None and r.get(k) is not None:
                d[k] += n * r[k]
            else:
                d[k] = None
    return out


def phase_kernels(cfg, device, batch: int, reps: int, plain_reps: int):
    """K1 and K2 at every distinct layer geometry, both layouts, all three
    modes at ``batch``, then the representative geometry streamed at batch 1.
    Returns (worst errors, the representative row, {mode: row} of the
    representative geometry unpacked)."""
    rs = np.random.RandomState(7)
    cases_out = []
    worst = {"block_sparse_matmul": 0.0, "implicit_block_sparse_conv": 0.0}
    # the representative shape of each kernel's summary line: the layer
    # geometry the main path runs most often (3x3, stride 1, 16 -> 16
    # channels at 32x32), one group per tile, streamed int8
    rep_geom = (cfg.image_size, 1, 3, cfg.widths[0], cfg.widths[0])
    rep, by_mode = {}, {}
    for geom in layer_geometries(cfg):
        for packed in (False, True):
            for mode in ("f32", "int8", "streamed"):
                case = make_case(geom, packed, mode, batch, N_CU, device, rs)
                is_rep = geom[1:] == rep_geom and not packed and mode == "streamed"
                case["profile"] = is_rep
                row = kernel_case_row(case, device, reps, plain_reps, worst)
                if geom[1:] == rep_geom and not packed:
                    by_mode[mode] = row
                if is_rep:
                    rep = row
                cases_out.append(row)
    # serving's bucket 1: the representative geometry at batch 1, both layouts
    geom = next(g for g in layer_geometries(cfg) if g[1:] == rep_geom)
    for packed in (False, True):
        case = make_case(geom, packed, "streamed", 1, N_CU, device, rs)
        row = kernel_case_row(case, device, reps, plain_reps, worst)
        by_mode[f"streamed_batch1{'_packed' if packed else ''}"] = row
        cases_out.append(row)
    emit("kernels", batch=batch, f32_tol=F32_TOL, int8_tol=0.0,
         reps=reps, plain_reps=plain_reps, cases=cases_out)
    emit("kernels_per_forward", batch=batch, card=gpu_name_and_limit(),
         sums=per_forward(cfg, cases_out, batch))
    return worst, rep, by_mode


def phase_kernels_f32_train(cfg, device, batch: int, reps: int, plain_reps: int,
                            worst, by_mode):
    """K2's f32 instance at the training batch, as the training forward
    launches it: every distinct layer geometry in both layouts, within
    F32_TOL of the plain version, two launches bit-identical, timed beside
    its bound and cuDNN (f32, TF32 off). Adds the representative geometry's
    rows to ``by_mode`` (``f32_batch128``, ``f32_batch128_packed``)."""
    rs = np.random.RandomState(19)
    rep_geom = (cfg.image_size, 1, 3, cfg.widths[0], cfg.widths[0])
    rows = []
    for geom in layer_geometries(cfg):
        for packed in (False, True):
            case = make_case(geom, packed, "f32", batch, N_CU, device, rs, k1=False)
            row = kernel_case_row(case, device, reps, plain_reps, worst, k1=False)
            row["k2_ms_div_library"] = row["k2_ms"] / row["library_ms"]
            rows.append(row)
            if geom[1:] == rep_geom:
                by_mode[f"f32_batch{batch}{'_packed' if packed else ''}"] = row
    emit("kernels_f32_train", batch=batch, f32_tol=F32_TOL, reps=reps,
         plain_reps=plain_reps, cases=rows)


# ---------------------------------------------------------------------------
# phases: serving
# ---------------------------------------------------------------------------

def request_sizes(buckets):
    """1, 8, 5, 32, 128 and 200 frames at the default buckets: exact fits,
    padding (5 -> 8) and chunking (200 -> 128 + 72 padded to 128)."""
    top = max(buckets)
    return [1, min(8, top), min(5, top), min(32, top), top, top + (top * 9) // 16]


def n_chunks(n: int, buckets) -> int:
    return -(-n // max(buckets))


def serve_phase(name, cfg, spec, buckets, models, frames, devices, *,
                sizes, kernel_name, tol=LOGIT_TOL):
    """Serve ``sizes`` requests through a server on the GPU and the same
    server on the CPU (plain versions); logits must agree within ``tol``.
    Returns (gpu server, launches of ``kernel_name`` during the requests)."""
    dev, ref_dev = devices
    srv = CnnServer(*models[dev], cfg, spec=spec, buckets=buckets, device=dev)
    ref = CnnServer(*models[ref_dev], cfg, spec=spec, buckets=buckets, device=ref_dev)
    t0 = time.time()
    srv.warmup()
    warm_s = time.time() - t0
    table = srv._bind().table
    n_layers = len(table)
    dense_layers = sum(v is None for v in table.values())
    if dense_layers:
        raise AssertionError(f"{name}: {dense_layers} of {n_layers} layers "
                             "took the dense route (dense_fallback=2.0 must "
                             "bind every layer)")
    before = kernels.launch_counts()
    errs, lo, chunks = [], 0, 0
    for n in sizes:
        x = frames[lo:lo + n]
        lo += n
        y = srv.infer(x)
        sync(dev)
        y_ref = ref.infer(x)
        if tuple(y.shape) != (n, cfg.num_classes) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name}: bad logits for a {n}-frame request")
        errs.append(float((y.cpu() - y_ref.cpu()).abs().max()))
        chunks += n_chunks(n, buckets)
    after = kernels.launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    worst = max(errs)
    if worst > tol:
        raise AssertionError(f"{name}: logits differ from the CPU server by "
                             f"{worst} > {tol} (per request: {errs})")
    want = n_layers * chunks
    if launched[kernel_name] != want:
        raise AssertionError(f"{name}: {kernel_name} launched "
                             f"{launched[kernel_name]} times, expected "
                             f"{n_layers} layers x {chunks} chunks = {want}")
    emit(name, spec=repr(spec), requests=sizes, chunks=chunks, layers=n_layers,
         dense_layers=dense_layers, launches=launched, expected_launches=want,
         max_abs_err_vs_cpu=worst, per_request_err=errs, tol=tol, warmup_s=warm_s, stats=srv.stats())
    return srv, launched


def phase_default_cli(device):
    """The normal entry point as a user runs it."""
    argv = ["--no-smoke", "--activation-dsb", "--requests", "8"]
    before = kernels.launch_counts()
    srv = serve_cnn.main(argv)
    sync(device)
    after = kernels.launch_counts()
    exec_ = srv._bind()
    bound = sum(v is not None for v in exec_.table.values())
    h = srv.cfg.image_size
    x = torch.from_numpy(np.random.RandomState(3).rand(8, h, h, 3).astype(np.float32))
    dsb = exec_.measure_dsb_skip(srv._tree, x.to(srv.device), srv.run_cfg)
    y = srv.infer(x)
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("serve_default: non-finite logits")
    emit("serve_default", argv=argv, layers=len(exec_.table), layers_bound=bound,
         layers_dense=len(exec_.table) - bound,
         launches={k: after[k] - before[k] for k in after},
         dsb_skip_frac=dsb["dsb_skip_frac"],
         dsb_skipped_steps=dsb["dsb_skipped_steps"],
         dsb_live_steps=dsb["dsb_live_steps"], stats=srv.stats())


def phase_ladder(cfg, spec, buckets, models, frames, devices):
    dev, ref_dev = devices
    srv = CnnServer(*models[dev], cfg, spec=spec, buckets=buckets, device=dev)
    ref = CnnServer(*models[ref_dev], cfg, spec=spec, buckets=buckets, device=ref_dev)
    n = min(8, max(buckets))
    rungs = []
    for level, rung in enumerate(srv.rungs):
        srv.force_level(level)
        ref.force_level(level)
        y, y_ref = srv.infer(frames[:n]), ref.infer(frames[:n])
        sync(dev)
        rname = serve_cnn.rung_name(rung)
        # int8 rungs: convs exact; f32 and dense rungs: float summation order
        tol = LOGIT_TOL if rname in ("streamed", "quantized") else F32_TOL
        err = float((y.cpu() - y_ref.cpu()).abs().max())
        if srv.last_request_level != level or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"ladder: rung {rname} did not serve cleanly")
        if err > tol:
            raise AssertionError(f"ladder: rung {rname} differs from the CPU "
                                 f"server by {err} > {tol}")
        rungs.append({"level": level, "rung": rname, "max_abs_err_vs_cpu": err,
                      "tol": tol})
    emit("ladder", rungs=rungs)


def phase_timing(servers, buckets, frames, device, reps, card):
    out = {}
    for label, srv in servers.items():
        per_bucket = {}
        for b in buckets:
            x = frames[:b].to(device)
            for _ in range(3):
                srv.infer(x)
            sync(device)
            lat = []
            for _ in range(reps):
                t0 = time.perf_counter()
                srv.infer(x)
                sync(device)
                lat.append((time.perf_counter() - t0) * 1e3)
            p50 = float(np.percentile(lat, 50))
            # device time of one request (profiler, all GPU kernels of the
            # request summed): the rest of p50 is the host
            prof = profiler_device_ms(lambda: srv.infer(x), device, 5)
            per_bucket[str(b)] = {
                "p50_ms": p50, "p99_ms": float(np.percentile(lat, 99)),
                "frames_per_s": b / (p50 / 1e3),
                "device_ms": None if prof is None else prof["total_ms"],
                "device_own_kernels_ms": None if prof is None else prof["kernels_ms"],
                "device_ms_by_kernel": None if prof is None else prof["by_kernel"],
                "device_busy_share": None if prof is None else prof["total_ms"] / p50}
        out[label] = per_bucket
    emit("timing", card=card, reps=reps, latency=out)


# ---------------------------------------------------------------------------
# phase: the weight-gradient kernel against its plain version
# ---------------------------------------------------------------------------

def pack_output_grad(layout, dy):
    """``dy`` (B, ho, wo, cout) onto the packed N lanes: the transpose of
    ``layout.unpack_output``, as the trainable conv's backward forms it."""
    B, ho, wo = dy.shape[:3]
    with torch.enable_grad():
        o2 = torch.zeros((B * ho * wo, layout.n_packed), device=dy.device,
                         requires_grad=True)
        g2d, = torch.autograd.grad(layout.unpack_output(o2, (B, ho, wo)), o2, dy)
    return g2d


def make_grad_case(geom, packed: bool, batch: int, n_cu: int, device,
                   rs: np.random.RandomState):
    """Operands of K3 for one conv layer at training batch ``batch``, as the
    trainable conv's backward hands them over: the packed patch matrix and
    the packed output gradient (rows padded to bm), the live tiles of a
    random half-pruned group mask."""
    name, H, stride, k, cin, cout = geom
    spec = fpga_conv_groups((k, k, cin, cout), n_cu)
    layout = conv_gemm_layout(spec, packed=packed)
    gm = (rs.rand(cin, spec.n_fblocks) > SPARSITY).astype(np.float32)
    gm[0, 0] = 1.0                        # at least one live tile
    tm = layout.tile_mask(gm.reshape(-1))
    live = np.argwhere(tm)
    ho = conv_out_size(H, k, stride, "SAME")
    x = torch.relu(torch.from_numpy(rs.randn(batch, H, H, cin).astype(np.float32)
                                    ).to(device))
    dy = torch.from_numpy(rs.randn(batch, ho, ho, cout).astype(np.float32)).to(device)
    M = batch * ho * ho
    bm = adaptive_bm(M)
    p2d, _ = _pad_rows(layout.pack_patches(im2col_patches(x, k, k, stride, "SAME")), bm)
    g2d, _ = _pad_rows(pack_output_grad(layout, dy), bm)
    bk, bn = layout.block
    L = len(live)
    # max over live tiles of |x|^T |g|: the size of the sums compared
    absprod = (p2d.abs().T @ g2d.abs()).reshape(tm.shape[0], bk, tm.shape[1], bn)
    scale = max(float(absprod[kt, :, nt, :].max()) for kt, nt in live)
    # the bound counts what the weight gradient needs: the M real rows, the
    # patch columns (k*k taps of each input channel with a live group) and
    # gradient columns (the real filters of each f-block with a live group)
    # read once, 2*M multiply-adds per live weight element, each live
    # element written once. The padded figure charges what the kernel
    # touches: every row padded to bm, whole (bk, bn) tiles.
    live_elems, _ = layout.mac_accounting(gm.reshape(-1))
    fb_filters = np.minimum(n_cu, cout - n_cu * np.arange(spec.n_fblocks))
    x_cols = k * k * int(gm.any(axis=1).sum())
    g_cols = int(fb_filters[gm.any(axis=0)].sum())
    t_b = 4 * (M * (x_cols + g_cols) + live_elems) / PEAK_BYTES_S
    t_o = 2 * M * live_elems / PEAK_OPS_S["f32"]
    n_k, n_n = len(set(live[:, 0].tolist())), len(set(live[:, 1].tolist()))
    t_b_pad = 4 * (p2d.shape[0] * (bk * n_k + bn * n_n) + L * bk * bn) / PEAK_BYTES_S
    t_o_pad = 2 * p2d.shape[0] * bk * bn * L / PEAK_OPS_S["f32"]
    # the same work with each product taken three times at the TF32 rate
    t_o_3x = 3 * 2 * M * live_elems / PEAK_TF32_S
    return {"name": name, "packed": packed, "batch": batch, "H": H, "stride": stride,
            "k": k, "cin": cin, "cout": cout, "M": M, "block": (bk, bn), "bm": bm,
            "spec": spec, "layout": layout, "group_mask": gm.reshape(-1),
            "tile_mask": tm, "live_tiles": L, "x": p2d.contiguous(), "g": g2d.contiguous(),
            "kk": torch.from_numpy(live[:, 0].astype(np.int32)).to(device),
            "nn": torch.from_numpy(live[:, 1].astype(np.int32)).to(device),
            "stacks": torch.from_numpy(BSM.grad_weight_stacks(live[:, 0], live[:, 1], bk)
                                       ).to(device),
            "g_lanes": layout.output_lanes,
            "scale": scale, "live_elems": live_elems, "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bound_padded_ms": max(t_b_pad, t_o_pad) * 1e3,
            "bound_3xtf32_ms": max(t_b, t_o_3x) * 1e3}


def phase_kernels_grad_weight(cfg, device, batch: int, reps: int, plain_reps: int):
    """K3 at every distinct layer geometry in both layouts at training batch
    ``batch``: within GRAD_W_REL_TOL x max(|x|^T |g|) of the plain version,
    two launches bit-identical, dead tiles exactly zero after the scatter.
    The kernel takes the stack table and the lane count as the training
    path's bind hands them over (the table built once, on the device; g
    zero past the layout's ``output_lanes``). Returns (worst relative error,
    the row of the representative shape)."""
    rs = np.random.RandomState(11)
    rows, rep, worst = [], {}, 0.0
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    for geom in layer_geometries(cfg):
        for packed in (False, True):
            c = make_grad_case(geom, packed, batch, N_CU, device, rs)
            kw = dict(block=c["block"], bm=c["bm"])
            run = lambda fn: fn(c["x"], c["g"], c["kk"], c["nn"], **kw)
            kern = lambda: BSM.block_sparse_grad_weight(c["x"], c["g"], c["kk"], c["nn"],
                                                        stacks=c["stacks"],
                                                        g_lanes=c["g_lanes"], **kw)
            got = kern()
            again = kern()
            sync(device)
            want = run(BSM.block_sparse_grad_weight_plain)
            label = f"block_sparse_grad_weight {c['name']} packed={packed}"
            if not torch.equal(got, again):
                raise AssertionError(f"{label}: two launches differ")
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{label}: non-finite output")
            err = float((got.double() - want.double()).abs().max())
            if err > GRAD_W_REL_TOL * c["scale"]:
                raise AssertionError(f"{label}: max abs err {err} > "
                                     f"{GRAD_W_REL_TOL} x {c['scale']}")
            worst = max(worst, err)
            bk, bn = c["block"]
            dw = make_block_sparse_grad_weight(c["tile_mask"], c["block"], bm=c["bm"],
                                               g_lanes=c["g_lanes"])(c["x"], c["g"])
            dead = torch.from_numpy(~np.repeat(np.repeat(c["tile_mask"], bk, 0), bn, 1)
                                    ).to(device)
            if not bool((dw[dead] == 0).all()):
                raise AssertionError(f"{label}: a dead tile is not exactly zero")
            row = {k: c[k] for k in ("name", "packed", "batch", "H", "stride", "k",
                                     "cin", "cout", "M", "bm", "live_tiles",
                                     "live_elems", "bound_ms", "bound_by",
                                     "bound_padded_ms", "bound_3xtf32_ms")}
            row["block"] = list(c["block"])
            row["stacks"] = int(c["stacks"].shape[0])
            row["g_lanes"] = c["g_lanes"]
            row["split"] = list(BSM.grad_weight_split(
                c["x"].shape[0], row["stacks"],
                torch.cuda.get_device_properties(device).multi_processor_count))
            row["max_abs_err"] = err
            row["tol"] = GRAD_W_REL_TOL * c["scale"]
            row["ms"] = device_ms(kern, device, reps)
            row["call_ms"] = time_ms(kern, device, reps)
            row["plain_ms"] = time_ms(lambda: run(BSM.block_sparse_grad_weight_plain),
                                      device, plain_reps, warmup=1)
            # the dense product x^T g, f32 with TF32 off: a yardstick only
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                xt, g = c["x"].T, c["g"]
                row["library_ms"] = device_ms(lambda: torch.matmul(xt, g), device, reps)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev_tf32
            rows.append(row)
            # representative shape, as for K1 and K2: s0b0/conv1, one group
            # per tile
            if geom[1:] == (cfg.image_size, 1, 3, cfg.widths[0], cfg.widths[0]) \
                    and not packed:
                prof = profiler_device_ms(kern, device, reps)
                row["profiler_ms"] = None if prof is None else prof["total_ms"]
                rep = row
    emit("kernels_grad_weight", batch=batch, rel_tol=GRAD_W_REL_TOL, reps=reps,
         plain_reps=plain_reps, cases=rows)
    return worst, rep


# ---------------------------------------------------------------------------
# phase: K1's dX at the training batch against its plain version
# ---------------------------------------------------------------------------

def phase_kernels_dx_train(cfg, device, batch: int, reps: int, plain_reps: int, worst,
                           by_mode):
    """K1's f32 instance as the training backward launches it for dX (as
    ``kernels/ops.py``'s ``_BoundBlockSparseMatmul.backward`` does): dP = g @
    Wpᵀ with the packed masked weight transposed, on the transposed plan,
    ``x_lanes`` = the layout's ``output_lanes``, at every layer geometry past
    conv0 (the convs whose dX the backward computes) in both layouts at
    training batch ``batch``, g and the tile mask as ``make_grad_case`` makes
    them. Each row within DX_REL_TOL x max(|g| |Wpᵀ|) over the live output
    columns of the plain version, two launches bit-identical, the output
    finite; timed beside its bounds and ``matmul(g, Wpᵀ)`` (f32, TF32 off).
    Raises ``worst["block_sparse_matmul"]`` to the phase's worst error; adds
    s0b0/conv1's rows to ``by_mode`` (``f32_dx_batch128``,
    ``f32_dx_batch128_packed``)."""
    rs = np.random.RandomState(23)
    rows = []
    rep_geom = (cfg.image_size, 1, 3, cfg.widths[0], cfg.widths[0])
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for geom in layer_geometries(cfg)[1:]:
            for packed in (False, True):
                rows.append(dx_train_row(geom, packed, batch, device, rs, reps, plain_reps))
                row = rows[-1]
                worst["block_sparse_matmul"] = max(worst["block_sparse_matmul"],
                                                   row["max_abs_err"])
                if geom[1:] == rep_geom:
                    by_mode[f"f32_dx_batch{batch}{'_packed' if packed else ''}"] = row
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    emit("kernels_dx_train", batch=batch, rel_tol=DX_REL_TOL, reps=reps,
         plain_reps=plain_reps, cases=rows)


def dx_train_row(geom, packed, batch, device, rs, reps, plain_reps) -> dict:
    """One row of ``phase_kernels_dx_train`` (TF32 already off)."""
    name, H, stride, k, cin, cout = geom
    c = make_grad_case(geom, packed, batch, N_CU, device, rs)
    layout, tm = c["layout"], c["tile_mask"]
    w = torch.from_numpy((rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))
                          ).astype(np.float32)).to(device)
    wt = layout.pack_weight(c["spec"].expand(c["group_mask"]).to(device) * w).t().contiguous()
    t_plan = transpose_plan(plan_from_tile_mask(tm, layout.block), tm)
    t_idx = torch.from_numpy(t_plan.idx).to(device)
    t_cnt = torch.from_numpy(t_plan.cnt).to(device)
    g, lanes = c["g"], layout.output_lanes
    kw = dict(block=t_plan.block, bm=c["bm"], x_lanes=lanes)
    kern = lambda: BSM.block_sparse_matmul(g, wt, t_idx, t_cnt, **kw)
    plain = lambda: BSM.block_sparse_matmul_plain(g, wt, t_idx, t_cnt, **kw)
    label = f"block_sparse_matmul dX {name} packed={packed}"
    got = kern()
    again = kern()
    sync(device)
    want = plain()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches differ")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite output")
    bk_t, bn_t = t_plan.block
    live_cols = torch.repeat_interleave(t_cnt > 0, bn_t)
    scale = float((g.abs() @ wt.abs())[:, live_cols].max())
    err = float((got.double() - want.double()).abs().max())
    if err > DX_REL_TOL * scale:
        raise AssertionError(f"{label}: max abs err {err} > {DX_REL_TOL} x {scale}")
    # the bound counts what dX needs: g's lanes below x_lanes in the K-tiles
    # with a live tile, read once over the M real rows; dP (the packed patch
    # gradient) written once; the live weight tiles' rows below x_lanes; and
    # 2*M*x_lanes*bn operations a live tile. The padded figure charges every
    # row padded to bm and whole tiles.
    M, Mp, n_out, L = c["M"], g.shape[0], wt.shape[1], c["live_tiles"]
    n_g = int(tm.any(axis=0).sum())     # K-tiles of the transposed plan in use
    t_b = 4 * (M * n_g * lanes + M * n_out + L * lanes * bn_t) / PEAK_BYTES_S
    ops = 2 * M * L * lanes * bn_t
    t_o = ops / PEAK_OPS_S["f32"]
    t_b_pad = 4 * (Mp * n_g * bk_t + Mp * n_out + L * bk_t * bn_t) / PEAK_BYTES_S
    t_o_pad = 2 * Mp * L * bk_t * bn_t / PEAK_OPS_S["f32"]
    row = {"name": name, "packed": packed, "batch": batch, "H": H, "stride": stride, "k": k,
           "cin": cin, "cout": cout, "M": M, "bm": c["bm"], "block": list(t_plan.block),
           "x_lanes": lanes, "live_tiles": L, "live_columns": int((t_cnt > 0).sum()),
           "max_abs_err": err, "tol": DX_REL_TOL * scale, "bit_identical": True,
           "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations",
           "bound_3xtf32_ms": max(t_b, 3 * ops / PEAK_TF32_S) * 1e3,
           "bound_padded_ms": max(t_b_pad, t_o_pad) * 1e3}
    row["ms"] = device_ms(kern, device, reps)
    row["call_ms"] = time_ms(kern, device, reps)
    row["plain_ms"] = time_ms(plain, device, plain_reps, warmup=1)
    # the dense product g @ Wpᵀ, f32: a yardstick only
    row["library_ms"] = device_ms(lambda: torch.matmul(g, wt), device, reps)
    row["ms_div_library"] = row["ms"] / row["library_ms"]
    return row


# ---------------------------------------------------------------------------
# phases: training through the kernels
# ---------------------------------------------------------------------------

def train_batch(cfg, seed, device, batch):
    """One fixed batch of the synthetic CIFAR set, made from a seed."""
    ds = SyntheticCifar(num_train=batch, num_test=8, seed=seed,
                        image_size=cfg.image_size)
    return {"x": torch.from_numpy(ds.train_x).to(device),
            "y": torch.from_numpy(ds.train_y).to(device)}


def bind_trainable(model, cfg, device, **spec_kw):
    params, _, _, specs, st = model
    return cnn.bind_execution(params, cfg, spec=cnn.ExecSpec(trainable=True, **spec_kw),
                              specs=specs, group_masks=st.group_masks, device=device)


def masked_grads(model, cfg, batch, exec_, through_mask=False):
    """(loss, grads) of the masked loss: with respect to the masked params,
    as the train step takes them, or (``through_mask``) with respect to the
    params through the mask multiply, which zeroes pruned positions on any
    conv path — the form a dense reference is compared in."""
    params, state, masks = model[:3]
    if through_mask:
        fn = lambda p: cnn_training._loss_fn(apply_masks(p, masks), state, batch, cfg,
                                             exec_)
        (loss, _), grads = value_and_grad(fn, params)
    else:
        (loss, _), grads = value_and_grad(cnn_training._loss_fn,
                                          apply_masks(params, masks), state, batch, cfg,
                                          exec_)
    return float(loss), grads


def check_pruned_zero(label, tree, masks):
    leaves = dict(tree_flatten_with_path(tree))
    for path, m in tree_flatten_with_path(masks):
        if float(torch.max(torch.abs(leaves[path] * (1 - m)))) != 0.0:
            raise AssertionError(f"{label}: {'/'.join(path)} is not exactly zero "
                                 "at pruned positions")


def phase_train(name, cfg, packed: bool, model, batch, device, warmup=3, steps=10):
    """SGD steps (lr 0.05, momentum 0.9, weight decay 1e-4, re-mask after
    the update) on one fixed batch through a trainable bind of every conv
    (``dense_fallback=2.0``). Checks the loss falls, the gradients are
    finite and exactly zero at pruned positions, pruned weights stay zero,
    and each kernel launched (K3 exactly once per step per bound conv with
    a live tile). Returns the phase's numbers."""
    params, state, masks = model[:3]
    exec_ = bind_trainable(model, cfg, device, packed=packed, n_cu=N_CU,
                           dense_fallback=2.0)
    bound = [k for k, v in exec_.table.items() if v is not None]
    live_convs = sum(1 for k in bound if int(exec_.plans[k].cnt.sum()) > 0)
    if len(bound) != len(exec_.table):
        raise AssertionError(f"{name}: {len(exec_.table) - len(bound)} layers "
                             "took the dense route")
    step = cnn_training.make_sparse_train_step(cfg, exec_)
    st = {"p": params, "s": state, "o": sgd(momentum=0.9, weight_decay=1e-4)[0](params)}
    losses, lat = [], []

    def one_step():
        st["p"], st["s"], st["o"], loss = step(st["p"], st["s"], st["o"], masks, batch,
                                               TRAIN_LR)
        return loss

    before = kernels.launch_counts()
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        loss = one_step()
        sync(device)
        if i >= warmup:
            lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    after = kernels.launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    n_steps = warmup + steps
    if launched["block_sparse_grad_weight"] != n_steps * live_convs:
        raise AssertionError(f"{name}: block_sparse_grad_weight launched "
                             f"{launched['block_sparse_grad_weight']} times, expected "
                             f"{n_steps} steps x {live_convs} live convs")
    for kname in PATH_KERNELS["train"]:
        if launched[kname] < 1:
            raise AssertionError(f"{name}: {kname} was not launched")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses}")
    check_pruned_zero(f"{name} weights", st["p"], masks)
    loss, grads = masked_grads((st["p"], st["s"], masks), cfg, batch, exec_)
    if not all(bool(torch.isfinite(g).all()) for _, g in tree_flatten_with_path(grads)):
        raise AssertionError(f"{name}: non-finite gradients")
    check_pruned_zero(f"{name} gradients", grads, masks)
    prof = profiler_device_ms(one_step, device, 3)
    dev_ms = None if prof is None else prof["total_ms"]
    out = {"layers": len(exec_.table), "layers_with_live_tiles": live_convs,
           "steps": steps, "warmup": warmup, "batch": int(batch["x"].shape[0]),
           "losses": losses,
           "step_p50_ms": float(np.percentile(lat, 50)),
           "step_p99_ms": float(np.percentile(lat, 99)),
           "device_ms_per_step": dev_ms,
           "kernel_ms_per_step": None if prof is None else prof["by_kernel"],
           "kernel_share": None if prof is None else {
               k: v / dev_ms for k, v in prof["by_kernel"].items()},
           "device_busy_share": None if prof is None else dev_ms / float(np.percentile(lat, 50)),
           "launches": launched, "expected_grad_weight_launches": n_steps * live_convs}
    emit(name, spec=repr(exec_.spec), quantized_net=cfg.quantized, **out)
    return out


def phase_train_grad_parity(cfg_f32, model, batch, device):
    """One step's gradients through trainable binds (both layouts) against
    dense autograd (library convolution), both taken through
    ``apply_masks``, on the f32 network at the training batch. The
    reference is the dense run in float64. Each leaf is held on its own
    scale: max |g - g64| / max |g64| over the leaf must stay within
    GRAD_REL_TOL (a leaf whose float64 gradient is all zero must come out
    exactly zero). The f32 dense run's reading stands beside the kernels'
    for comparison; it sets no bar. Not an absolute bar: the conv0 weight
    gradient, a sum over 131072 rows of positive pixels times a BN-centred
    gradient, cancels, so any f32 summation order leaves an error of its
    terms' scale, not of the result's. The f32 network: under QAT one
    activation within an ulp of a Q3.4 rounding boundary can round the
    other way when the sums are taken in another order, and moves the
    gradients by far more than the bar."""
    params, state, masks = model[:3]
    flat = lambda tree: {"/".join(k): v for k, v in tree_flatten_with_path(tree)}
    to64 = lambda t: t.to(torch.float64)
    model64 = (tree_map(to64, params), tree_map(to64, state), masks)
    batch64 = {"x": batch["x"].double(), "y": batch["y"]}
    g64 = flat(masked_grads(model64, cfg_f32, batch64, None, True)[1])
    scale = {k: float(v.abs().max()) for k, v in g64.items()}

    def rel(g):
        out = {}
        for k, ref in g64.items():
            e = float((g[k].double() - ref).abs().max())
            out[k] = e / scale[k] if scale[k] > 0 else (0.0 if e == 0 else float("inf"))
        return out

    readings = {"dense_f32": rel(flat(masked_grads(model, cfg_f32, batch, None, True)[1]))}
    for packed in (False, True):
        exec_ = bind_trainable(model, cfg_f32, device, packed=packed, n_cu=N_CU,
                               dense_fallback=2.0)
        readings["packed" if packed else "unpacked"] = rel(
            flat(masked_grads(model, cfg_f32, batch, exec_, True)[1]))
    worst = {name: max(r.items(), key=lambda kv: kv[1]) for name, r in readings.items()}
    emit("train_grad_parity", quantized=cfg_f32.quantized, batch=int(batch["x"].shape[0]),
         rel_tol=GRAD_REL_TOL, worst_leaf=worst, leaf_max_abs_grad=scale,
         rel_err_vs_f64=readings)
    bad = {f"{name} {k}": v for name in ("unpacked", "packed")
           for k, v in readings[name].items() if not v <= GRAD_REL_TOL}
    if bad:
        raise AssertionError(f"train_grad_parity: gradients through the kernels off "
                             f"the float64 reference by more than {GRAD_REL_TOL} of "
                             f"the leaf's largest gradient: {bad}")


def phase_train_default(cfg, model, batch, device, steps=5):
    """SGD steps at the default trainable contract,
    ``ExecSpec(trainable=True, n_cu=12)``: how many of the layers bind, and
    the step's p50 (host clock + synchronize, after one untimed step) and
    device time (profiler). The layers that do not bind run the dense rung
    forward and backward."""
    exec_ = bind_trainable(model, cfg, device, n_cu=N_CU)
    params, state, masks = model[:3]
    step = cnn_training.make_sparse_train_step(cfg, exec_)
    opt = sgd(momentum=0.9, weight_decay=1e-4)[0](params)
    one_step = lambda: step(params, state, opt, masks, batch, TRAIN_LR)[3]
    before = kernels.launch_counts()
    loss = one_step()
    sync(device)
    after = kernels.launch_counts()
    if not np.isfinite(float(loss)):
        raise AssertionError("train_default: non-finite loss")
    lat = []
    for _ in range(steps):
        t0 = time.perf_counter()
        one_step()
        sync(device)
        lat.append((time.perf_counter() - t0) * 1e3)
    prof = profiler_device_ms(one_step, device, 3)
    bound = sum(v is not None for v in exec_.table.values())
    emit("train_default", spec=repr(exec_.spec), layers=len(exec_.table),
         layers_bound=bound, layers_dense=len(exec_.table) - bound, loss=float(loss),
         launches={k: after[k] - before[k] for k in after}, steps=steps,
         step_p50_ms=float(np.percentile(lat, 50)),
         device_ms_per_step=None if prof is None else prof["total_ms"],
         kernel_ms_per_step=None if prof is None else prof["by_kernel"])


def phase_train_cli(device):
    """The training entry point as a user runs it, on the GPU: fp32 -> int8
    -> HAPM (``--sparse-training``, the default) on a small synthetic set,
    then its own checks (executed-int8 vs QAT logits, gradients through a
    trainable bind against dense autograd, pruned gradients exactly zero).
    It binds at the default contract, so only the layers whose plan is
    below ``dense_fallback`` train through the kernels; the launch counts
    show which kernels ran."""
    argv = ["--epochs", "1", "--train-size", "256"]
    before = kernels.launch_counts()
    t0 = time.time()
    m = train_cnn.main(argv)
    sync(device)
    seconds = time.time() - t0
    after = kernels.launch_counts()
    if not all(np.isfinite(m.history)):
        raise AssertionError(f"train_cli: non-finite epoch loss {m.history}")
    emit("train_cli", argv=argv, seconds=seconds, history=m.history,
         test_accuracy=m.test_accuracy, launches={k: after[k] - before[k] for k in after})


# ---------------------------------------------------------------------------
# phase: the dense int8 matmul kernel (K4) against its plain version
# ---------------------------------------------------------------------------

# (label, real (M, K, N), padded (M, K, N)): the three shapes of the JAX
# package's K4 tests (M = 100 padded to a 128 multiple as fixed_point_matmul
# pads it), the dense im2col GEMM of the widest conv (s2b*/conv2: 3x3,
# 64 -> 64 at 8x8, batch 128) with K and N zero-padded to 128 multiples,
# 4096^3, and a depth whose sums pass 2^24
INT8_SHAPES = (
    ("test_128x128x128", (128, 128, 128), (128, 128, 128)),
    ("test_100x256x128", (100, 256, 128), (128, 256, 128)),
    ("test_256x384x256", (256, 384, 256), (256, 384, 256)),
    ("s2b_conv2_im2col_b128", (8192, 576, 64), (8192, 640, 128)),
    ("square_4096", (4096, 4096, 4096), (4096, 4096, 4096)),
    ("deep_k1152", (512, 1152, 256), (512, 1152, 256)),
)
INT8_REP = "s2b_conv2_im2col_b128"
FIXED_POINT_SHAPE = (8192, 640, 128)
FIXED_POINT_DX_TOL = 1e-4       # dx = g wᵀ: 128-term f32 sums, absolute
FIXED_POINT_DW_REL_TOL = 1e-4   # dw = xᵀ g: 8192-term f32 sums, x max(|x|ᵀ|g|)


def int8_codes(real, padded, rs):
    """Codes over the whole int8 range, -128 included, with one row of x and
    one column of w at -128 and one at 127 (sums of K * 2^14 at the extreme),
    zero-padded from the real to the padded shape."""
    (m, k, n), (M, K, N) = real, padded
    x = np.zeros((M, K), np.int8)
    w = np.zeros((K, N), np.int8)
    x[:m, :k] = rs.randint(-128, 128, (m, k))
    w[:k, :n] = rs.randint(-128, 128, (k, n))
    x[0, :k], w[:k, 0] = -128, -128
    x[m - 1, :k], w[:k, n - 1] = 127, 127
    return x, w


def clocks_and_power() -> str:
    """The card's SM clock and power draw now, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def gemm_bound(m, k, n, scale_len):
    """(ms, by): int8 operands read once, the scale row read once, the f32
    output written once; 2*m*k*n int8 operations."""
    t_b = (m * k + k * n + 4 * scale_len + 4 * m * n) / PEAK_BYTES_S
    t_o = 2 * m * k * n / PEAK_OPS_S["int8"]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_kernels_int8_matmul(device, reps: int, plain_reps: int):
    """K4 at every shape of INT8_SHAPES with both scale forms: bit-equal to
    ``int8_matmul_plain`` and to ``int8_matmul_ref`` on the card, two
    launches bit-identical; timed with the scalar scale (the fixed-point
    path's), each row with the block tile and block count the kernel picked
    (``None`` on a tree whose kernel does not report them); at 4096^3 the SM
    clock and power draw before the timing, while 2000 launches run, and
    after. Returns (worst error, the row of the representative shape)."""
    rs = np.random.RandomState(13)
    rows, rep = [], {}
    for label, real, padded in INT8_SHAPES:
        xn, wn = int8_codes(real, padded, rs)
        M, K, N = padded
        x, w = torch.from_numpy(xn).to(device), torch.from_numpy(wn).to(device)
        acc_max = int(REF.int_matmul_exact(x, w).abs().max())    # on the card
        scales = {"scalar": torch.tensor([1.0 / 512], device=device),
                  "per_cout": torch.from_numpy(
                      rs.uniform(1e-3, 1e-1, N).astype(np.float32)).to(device)}
        for form, scale in scales.items():
            got = I8.int8_matmul(x, w, scale)
            again = I8.int8_matmul(x, w, scale)
            sync(device)
            want = I8.int8_matmul_plain(x, w, scale)
            ref = REF.int8_matmul_ref(x, w, scale if form == "per_cout" else 1.0 / 512)
            name = f"int8_matmul {label} scale={form}"
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two launches differ")
            for what, other in (("plain version", want), ("int8_matmul_ref", ref)):
                if got.dtype != other.dtype or not torch.equal(got, other):
                    err = float((got.double() - other.double()).abs().max())
                    raise AssertionError(f"{name}: differs from the {what} by {err}")
        if label == "deep_k1152" and acc_max <= 2 ** 24:
            raise AssertionError(f"{label}: no sum passes 2^24 ({acc_max})")
        scale = scales["scalar"]
        run = lambda fn: fn(x, w, scale)
        row = {"shape": label, "M": M, "K": K, "N": N, "real": list(real),
               "max_abs_acc": acc_max, "max_abs_err": 0.0, "forms": list(scales)}
        tile = I8.kernel_tile(M, N, device) if hasattr(I8, "kernel_tile") else None
        row["tile"], row["blocks"] = (None, None) if tile is None else (list(tile[:2]), tile[2])
        if label == "square_4096":
            row["smi_before"] = clocks_and_power()
        row["ms"] = device_ms(lambda: run(I8.int8_matmul), device, reps)
        if label == "square_4096":
            for _ in range(2000):
                run(I8.int8_matmul)
            row["smi_during"] = clocks_and_power()
            sync(device)
            row["smi_after"] = clocks_and_power()
        row["call_ms"] = time_ms(lambda: run(I8.int8_matmul), device, reps)
        row["plain_ms"] = time_ms(lambda: run(I8.int8_matmul_plain), device, plain_reps,
                                  warmup=1)
        row["bound_ms"], row["bound_by"] = gemm_bound(*real, 1)
        row["bound_padded_ms"] = gemm_bound(M, K, N, 1)[0]
        try:       # cuBLAS int8 with an f32 flush: a yardstick only
            lib = lambda: torch._int_mm(x, w).float() * scale
            row["library_equal"] = bool(torch.equal(lib(), I8.int8_matmul(x, w, scale)))
            row["library_ms"] = device_ms(lib, device, reps)
        except RuntimeError as e:
            row["library_ms"], row["library_error"] = None, str(e).splitlines()[0]
        rows.append(row)
        if label == INT8_REP:
            prof = profiler_device_ms(lambda: run(I8.int8_matmul), device, reps)
            row["profiler_ms"] = None if prof is None else prof["total_ms"]
            # the kernel alone (the wrapper also copies the broadcast scale row)
            row["profiler_kernel_ms"] = (None if prof is None
                                         else prof["by_kernel"]["int8_matmul"])
            rep = row
    emit("kernels_int8_matmul", reps=reps, plain_reps=plain_reps, tol=0.0, cases=rows)
    return 0.0, rep


# ---------------------------------------------------------------------------
# main path 3: the fixed-point GEMM (K4)
# ---------------------------------------------------------------------------

def phase_fixed_point(device):
    """``fixed_point_matmul`` forward and backward at FIXED_POINT_SHAPE on
    the card and on the CPU (plain version), on the same float inputs: the
    forward bit-equal, dx within FIXED_POINT_DX_TOL, dw within
    FIXED_POINT_DW_REL_TOL x max(|x|ᵀ|g|) (f32 sums over 8192 rows in two
    orders), TF32 off for the backward's matmuls. Launches K4 once."""
    M, K, N = FIXED_POINT_SHAPE
    rs = np.random.RandomState(17)
    xn = rs.uniform(-4, 4, (M, K)).astype(np.float32)
    wn = rs.uniform(-2, 2, (K, N)).astype(np.float32)
    gn = rs.randn(M, N).astype(np.float32)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for d in (device, torch.device("cpu")):
            x = torch.from_numpy(xn).to(d).requires_grad_()
            w = torch.from_numpy(wn).to(d).requires_grad_()
            before = kernels.launch_counts()["int8_matmul"]
            t0 = time.perf_counter()
            y = fixed_point_matmul(x, w)
            y.backward(torch.from_numpy(gn).to(d))
            if d.type == "cuda":
                sync(d)
            out[d.type] = {"y": y.detach().cpu(), "dx": x.grad.cpu(), "dw": w.grad.cpu(),
                           "s": time.perf_counter() - t0,
                           "launches": kernels.launch_counts()["int8_matmul"] - before}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    g, c = out["cuda"], out["cpu"]
    err = {k: float((g[k].double() - c[k].double()).abs().max()) for k in ("y", "dx", "dw")}
    dw_scale = float((np.abs(xn).T @ np.abs(gn)).max())
    emit("fixed_point", shape=list(FIXED_POINT_SHAPE), launches=g["launches"],
         max_abs_err_vs_cpu=err, dx_tol=FIXED_POINT_DX_TOL,
         dw_tol=FIXED_POINT_DW_REL_TOL * dw_scale, gpu_s=g["s"], cpu_s=c["s"],
         tf32=False)
    if g["launches"] != 1:
        raise AssertionError(f"fixed_point: K4 launched {g['launches']} times, expected 1")
    if not torch.equal(g["y"], c["y"]):
        raise AssertionError(f"fixed_point: forward differs from the CPU run by {err['y']}")
    if not err["dx"] <= FIXED_POINT_DX_TOL:
        raise AssertionError(f"fixed_point: dx off the CPU run by {err['dx']}")
    if not err["dw"] <= FIXED_POINT_DW_REL_TOL * dw_scale:
        raise AssertionError(f"fixed_point: dw off the CPU run by {err['dw']}")


def phase_fixed_point_timing(device, reps: int):
    """Device time of one ``fixed_point_matmul`` forward at FIXED_POINT_SHAPE
    from the profiler: every kernel and copy it puts on the card, and K4's
    share (0 on a tree whose K4 kernel has another name)."""
    M, K, N = FIXED_POINT_SHAPE
    rs = np.random.RandomState(17)
    x = torch.from_numpy(rs.uniform(-4, 4, (M, K)).astype(np.float32)).to(device)
    w = torch.from_numpy(rs.uniform(-2, 2, (K, N)).astype(np.float32)).to(device)
    prof = profiler_device_ms(lambda: fixed_point_matmul(x, w), device, reps)
    emit("fixed_point_timing", shape=list(FIXED_POINT_SHAPE), reps=reps,
         forward_device_ms=None if prof is None else prof["total_ms"],
         forward_k4_ms=None if prof is None else prof["by_kernel"]["int8_matmul"])


# ---------------------------------------------------------------------------
# main path 4: pricing on the paper's boards (accel.simulate)
# ---------------------------------------------------------------------------

def report_differences(a, b) -> dict:
    """{field: (a, b)} for every field of two SimulationReports that is not
    equal (``accel`` aside: the caller passes the same board)."""
    out = {}
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("cycles", "cycles_dual") and va is not None and vb is not None:
            va, vb = dataclasses.asdict(va), dataclasses.asdict(vb)
        if va != vb:
            out[f.name] = (va, vb)
    if a.row() != b.row():
        out["row"] = {k: (v, b.row()[k]) for k, v in a.row().items() if v != b.row()[k]}
    return out


def phase_price(cfg, device, card):
    """``simulate(..., images, labels, measure_dsb=True)`` on the card for the
    full-width HAPM network (group sparsity 0.5, n_cu = 12) and for uniform
    magnitude pruning at the same element sparsity, on each of the three
    boards (DSB on), plus the HAPM and the dense network without DSB; every
    report equal, field by field, to a CPU run of the port on the same
    weights and frames. Asserts the paper's ordering. Returns the launches
    of the path (counted from zero just before the card's runs)."""
    cpu = torch.device("cpu")
    dense, state = cnn.params_from_numpy(*numpy_model(cfg, 0), device=cpu)
    hapm, _, masks, _, _ = hapm_model(cfg, 0, N_CU, cpu)
    s_elem = global_sparsity(masks)
    uniform = apply_masks(dense, magnitude_masks(
        dense, full_masks(dense, cnn.is_conv_weight), s_elem))
    ds = SyntheticCifar(num_train=8, num_test=64, seed=0, image_size=cfg.image_size)
    frames, labels = ds.test_x, ds.test_y
    nodsb = dataclasses.replace(BOARDS["zedboard_100mhz_72dsp"], dsb=False)
    runs = [(f"{m}_{b}", p, board) for b, board in BOARDS.items()
            for m, p in (("hapm", hapm), ("uniform", uniform))]
    runs += [("hapm_nodsb", hapm, nodsb), ("dense_nodsb", dense, nodsb),
             ("dense_zedboard_100mhz_72dsp", dense, BOARDS["zedboard_100mhz_72dsp"])]

    def sim(params, board, dev):
        return simulate(params, state, cfg, board, frames, labels, measure_dsb=True,
                        device=dev)

    kernels.reset_launch_counts()
    on_card, wall = {}, {}
    for name, params, board in runs:
        t0 = time.perf_counter()
        on_card[name] = sim(params, board, device)
        sync(device)
        wall[name] = time.perf_counter() - t0
    launched = kernels.launch_counts()
    diffs = {}
    for name, params, board in runs:
        d = report_differences(on_card[name], sim(params, board, cpu))
        if d:
            diffs[name] = d
    rows = {name: {"board": dataclasses.asdict(board), "simulate_wall_s_on_card": wall[name],
                   **on_card[name].row()} for name, _, board in runs}
    gains = {b: on_card[f"uniform_{b}"].mean_time_per_image_s
             / on_card[f"hapm_{b}"].mean_time_per_image_s for b in BOARDS}
    emit("price", card=card, element_sparsity=s_elem, frames=len(frames),
         hapm_over_uniform_cycle_model_fpga=gains, launches=launched,
         k2_note="at the default packed contract only the two fully pruned 1x1 proj "
                 "convs of the HAPM model bind, so K2 runs there alone",
         differences_vs_cpu=diffs, reports=rows)
    if diffs:
        raise AssertionError(f"price: the card's reports differ from the CPU run: {diffs}")
    for b in BOARDS:
        if not gains[b] > 1.0:
            raise AssertionError(f"price: HAPM+DSB is not faster than uniform+DSB on {b}")
    if (on_card["hapm_nodsb"].mean_time_per_image_s
            < on_card["dense_nodsb"].mean_time_per_image_s):
        raise AssertionError("price: HAPM without DSB is faster than dense")
    return launched


def phase_quickstart(device):
    """The quickstart as a user runs it, on the card."""
    t0 = time.time()
    base, fast, no_dsb = quickstart.main([])
    sync(device)
    emit("quickstart", seconds=time.time() - t0,
         cycle_model_ms_per_image={"dense_dsb": base.mean_time_per_image_s * 1e3,
                                   "hapm_dsb": fast.mean_time_per_image_s * 1e3,
                                   "hapm_no_dsb": no_dsb.mean_time_per_image_s * 1e3})


# ---------------------------------------------------------------------------
# main path 5: the executed-sparsity bench twin; the execution contracts
# ---------------------------------------------------------------------------

def phase_sparse_cnn_bench(card):
    """``benchmarks/bench_sparse_cnn_torch.py --fast`` on the card, every
    hard assert of its ``run()`` in force, its JSON written to
    ``build/chip_smoke/`` (``SPARSE_CNN_JSON``).
    Prints the 50 % row's wall and device-time ratios and the three
    wall-clock floors with their verdicts (the gate script, not the bench,
    enforces those). Returns the path's launches, counted from zero just
    before the run."""
    from benchmarks import bench_sparse_cnn_torch as bench
    out = SPARSE_CNN_JSON
    os.makedirs(os.path.dirname(out), exist_ok=True)
    kernels.reset_launch_counts()
    t0 = time.time()
    report = bench.run(bench.parse_args(["--fast", "--out", out]))
    launched = kernels.launch_counts()
    at50 = next(r for r in report["rows"] if r["target_group_sparsity"] == 0.5)
    emit("sparse_cnn_bench", card=card, seconds=time.time() - t0,
         out=os.path.relpath(out, ROOT), config=report["config"], launches=launched,
         wall_floors=at50["wall_floors"],
         row50={k: v for k, v in at50.items()
                if k != "wall_floors" and (k.startswith(("wall_", "device_", "train_step_"))
                                           or k.endswith(("speedup", "_ratio")))},
         rows_ratios=[{k: r[k] for k in ("target_group_sparsity",
                                         "implicit_vs_materializing_wallclock_speedup",
                                         "device_implicit_vs_materializing_speedup",
                                         "dsb_kernel_speedup", "device_dsb_kernel_speedup",
                                         "dsb_dense_act_ratio", "device_dsb_dense_act_ratio",
                                         "dense_fallback_layers")}
                      for r in report["rows"]])
    return launched


# ---------------------------------------------------------------------------
# main path 6: the serving bench twin; a fixed-bm server at full width
# ---------------------------------------------------------------------------

def phase_serving_cnn_bench(card):
    """``benchmarks/bench_serving_cnn_torch.py --smoke`` on the card, every
    hard assert of its ``run()`` in force (one bind per server, every steady
    request a hit, bit-equal logits at every bucket, the off-bucket batch,
    the streamed row, zero wrong answers under chaos), its JSON written to
    ``build/chip_smoke/`` (``SERVING_CNN_JSON``). The chaos row's counters
    and virtual-clock trace must equal the reference's committed row.
    Prints each bucket's p50, device time and busy share, both amortization
    verdicts (the gate script enforces them) and the chaos counters.
    Returns the path's launches, counted from zero just before the run."""
    from benchmarks import bench_serving_cnn_torch as bench
    kernels.reset_launch_counts()
    t0 = time.time()
    report = bench.run(bench.parse_args(["--smoke", "--out", SERVING_CNN_JSON]))
    launched = kernels.launch_counts()
    seconds = time.time() - t0
    chaos = report["chaos"]
    with open(SERVING_REF_JSON) as f:
        ref = json.load(f)["chaos"]
    differ = {k: (chaos[k], ref[k]) for k in CHAOS_COUNTERS if chaos[k] != ref[k]}
    differ.update({f"trace.{k}": (chaos["trace"][k], v) for k, v in ref["trace"].items()
                   if abs(chaos["trace"][k] - v) > 1e-12})
    if differ:
        raise AssertionError(f"serving_cnn_bench: the chaos row differs from the "
                             f"reference's committed row: {differ}")
    emit("serving_cnn_bench", card=card, seconds=seconds,
         out=os.path.relpath(SERVING_CNN_JSON, ROOT), launches=launched,
         kernel_build_s=report["kernel_build_s"], first_request_s=report["first_request_s"],
         cold_bind_p50_ms=report["cold_bind_p50_ms"],
         buckets=[{k: r[k] for k in ("bucket", "p50_ms", "p99_ms", "device_ms",
                                     "busy_share", "launches")} for r in report["buckets"]],
         streamed={k: report["streamed"][k] for k in (
             "cold_bind_p50_ms", "p50_ms", "device_ms", "busy_share", "launches")},
         amortization_floors=report["amortization_floors"],
         device_empty_sessions=report["config"]["device_empty_sessions"],
         chaos={"equals_reference": True, "direct_p50_ms": chaos["direct_p50_ms"],
                "direct_device_ms": chaos["direct_device_ms"], "trace": chaos["trace"],
                **{k: chaos[k] for k in CHAOS_COUNTERS}})
    return launched


def phase_fixed_bm_servers(cfg, buckets, models, frames, devices, sizes):
    """``CnnServer`` with ``ExecSpec(bm=FIXED_BM, ...)`` (streamed int8 wire,
    every layer bound) in both tile layouts at full width, logits within
    ``LOGIT_TOL`` of a CPU server, K2 launched on every layer of every chunk
    (``serve_phase``). The packed server answers the serve phases' requests;
    the unpacked one those up to the 32-frame bucket (exact fits and
    padding): all of them on the unpacked layout take about a minute, most
    of it the CPU server's (``serve_unpacked``)."""
    t0 = time.time()
    for packed, requests in ((True, sizes), (False, sizes[:4])):
        spec = cnn.ExecSpec(bm=FIXED_BM, quantized=True, folded=True, streamed=True,
                            dense_fallback=2.0, n_cu=N_CU, packed=packed)
        serve_phase(f"serve_bm{FIXED_BM}_{'packed' if packed else 'unpacked'}", cfg, spec,
                    buckets, models, frames, devices, sizes=requests,
                    kernel_name="implicit_block_sparse_conv")
    return time.time() - t0


# the execution contracts of PERF.md §7 (a): the default ExecSpec (packed
# tiles, dense_fallback 0.999) and the three it is held against
EXEC_CONTRACTS = {"default": {}, "packed_fallback2": {"dense_fallback": 2.0},
                  "unpacked": {"packed": False},
                  "unpacked_fallback2": {"packed": False, "dense_fallback": 2.0}}
CONTRACT_REF = "packed_fallback2"       # every layer on the kernels, packed tiles
CONTRACT_TWIN = "unpacked_fallback2"    # the same layers bound, unpacked tiles: its
                                        # int8 logits must equal the reference's


def phase_exec_contracts(cfg, device, card, batch: int = TRAIN_BATCH, reps: int = 5):
    """The full-width HAPM 0.5 network at ``batch`` under each contract of
    ``EXEC_CONTRACTS``, for the streamed int8 folded forward and the f32
    forward: layers bound of the net's convs, K1/K2 launches per forward,
    device time per forward (profiler), wall p50 (host clock + synchronize)
    and the max difference of its logits from the all-bound packed
    contract's, over the batch and on its first frame alone. Then
    ``simulate(measure_dsb=True)``'s measured skip under the default
    contract beside the same measurement with every layer bound."""
    t_start = time.time()
    params, state, _, specs, st = hapm_model(cfg, 0, N_CU, device)
    folded = cnn.fold_batchnorm(params, state, cfg)
    x = torch.from_numpy(np.random.RandomState(5).rand(
        batch, cfg.image_size, cfg.image_size, 3).astype(np.float32)).to(device)
    forwards = {
        "int8_streamed": (folded, dict(quantized=True, folded=True, streamed=True),
                          lambda e, xx: cnn.apply_folded(folded, xx, cfg, sparse=e)),
        "f32": (params, {}, lambda e, xx: cnn.apply(params, state, xx, cfg, sparse=e)[0]),
    }
    out = {}
    for mode, (tree, base, fwd) in forwards.items():
        rows, logits = {}, {}
        for name, kw in EXEC_CONTRACTS.items():
            e = cnn.bind_execution(tree, cfg, spec=cnn.ExecSpec(n_cu=N_CU, **base, **kw),
                                   specs=specs, group_masks=st.group_masks, device=device)
            fn = lambda ee=e: fwd(ee, x)
            fn()
            sync(device)
            before = kernels.launch_counts()
            y = fn()
            sync(device)
            after = kernels.launch_counts()
            if tuple(y.shape) != (batch, cfg.num_classes) or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"exec_contracts: bad {mode} logits under {name}")
            logits[name] = (y, fwd(e, x[:1]))
            lat = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                sync(device)
                lat.append((time.perf_counter() - t0) * 1e3)
            prof = profiler_device_ms(fn, device, 3)
            bound = sum(v is not None for v in e.table.values())
            rows[name] = {
                "spec": repr(e.spec), "layers": len(e.table), "layers_bound": bound,
                "launches_per_forward": {k: after[k] - before[k]
                                         for k in ("block_sparse_matmul",
                                                   "implicit_block_sparse_conv")},
                "device_ms": None if prof is None else prof["total_ms"],
                "device_own_kernels_ms": None if prof is None else prof["kernels_ms"],
                "wall_p50_ms": float(np.percentile(lat, 50))}
        ref, ref1 = logits[CONTRACT_REF]
        for name, (y, y1) in logits.items():
            rows[name][f"max_abs_logit_diff_vs_{CONTRACT_REF}"] = float((y - ref).abs().max())
            rows[name]["first_frame_max_abs_logit_diff"] = float((y1 - ref1).abs().max())
        out[mode] = rows
        # int8: the two all-bound layouts run the same codes through the same
        # requantize, so their logits are equal; the default contract's
        # difference is reported only (its fallback layers convolve the f32
        # folded weights, by design). f32: every contract computes the same
        # function, the sums differ only in order.
        held = list(rows) if mode == "f32" else [CONTRACT_TWIN]
        tol = F32_TOL if mode == "f32" else 0.0
        bad = {name: rows[name][f"max_abs_logit_diff_vs_{CONTRACT_REF}"] for name in held
               if not rows[name][f"max_abs_logit_diff_vs_{CONTRACT_REF}"] <= tol}
        if bad:
            emit("exec_contracts", card=card, contracts=out)
            raise AssertionError(f"exec_contracts: {mode} logits differ from "
                                 f"{CONTRACT_REF}'s by more than {tol}: {bad}")

    ds = SyntheticCifar(num_train=8, num_test=64, seed=0, image_size=cfg.image_size)
    board = BOARDS["zedboard_100mhz_72dsp"]
    rep = simulate(params, state, cfg, board, ds.test_x, ds.test_y, measure_dsb=True,
                   device=device)
    # simulate's own skip measurement (a streamed activation_dsb bind of the
    # folded tree over its first 4 frames), with every layer bound
    all_bound = cnn.bind_execution(
        folded, cfg, spec=cnn.ExecSpec(folded=True, quantized=True, streamed=True,
                                       implicit=True, activation_dsb=True, n_cu=N_CU,
                                       dense_fallback=2.0), device=device)
    m = all_bound.measure_dsb_skip(folded, torch.from_numpy(ds.test_x[:4]).to(device), cfg)
    emit("exec_contracts", card=card, seconds=time.time() - t_start, batch=batch, reps=reps,
         reference=CONTRACT_REF,
         contracts=out, simulate_dsb_skip_measured={
             "default": rep.dsb_skip_frac_measured,
             "dense_fallback_2": m["dsb_skip_frac"],
             "dense_fallback_2_steps": [m["dsb_skipped_steps"], m["dsb_live_steps"]],
             "predicted": rep.dsb_skip_frac_predicted})


def kernels_line(paths, worst, rep, rep_gw, rep_i8, by_mode, k1_by_mode):
    """The ``kernels`` list of the last-but-one line: every ported kernel at
    its representative shape, with its launches on each main path
    (``paths``: {path: launch counts of its run}); K2 also gives its
    instances apart (``by_mode``: the representative geometry unpacked in
    each mode at the kernels batch, and streamed at batch 1 in both
    layouts), each beside its bound and the cuDNN yardstick; K1 gives its
    int8 (``streamed``, also beside ``_int_mm``) and f32 forward rows at the
    kernels batch and its f32 dX at the training batch in both layouts
    (``k1_by_mode``), the dX beside ``matmul(g, Wpᵀ)``."""
    tag = {"block_sparse_matmul": "k1", "implicit_block_sparse_conv": "k2"}
    shape_keys = ("name", "packed", "batch", "H", "stride", "k", "cin", "cout")
    timing = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "bound_padded_ms",
              "library_ms")
    lines = []
    for kname in KERNEL_INFO:
        by_path = {p: counts[kname] for p, counts in paths.items()}
        common = {"name": kname, **KERNEL_INFO[kname],
                  "launches": sum(by_path.values()), "launches_by_path": by_path,
                  "max_abs_err": worst[kname]}
        if kname in tag:
            t = tag[kname]
            lines.append({**common, **{k: rep[f"{t}_{k}"] for k in timing[:-1]},
                          "library_ms": rep["library_ms"],
                          "shape": {k: rep[k] for k in (*shape_keys, "mode")}})
            if t == "k2":
                lines[-1]["by_mode"] = {
                    m: {"packed": r["packed"], "batch": r["batch"],
                        **{k: r[f"k2_{k}"] for k in timing[:-1]},
                        "library_ms": r["library_ms"]} for m, r in by_mode.items()}
            else:
                lines[-1]["by_mode"] = {
                    m: {"packed": r["packed"], "batch": r["batch"],
                        **{k: r[k if "x_lanes" in r else f"k1_{k}"] for k in timing[:-1]},
                        "library_ms": r["library_ms"],
                        **({"int_mm_ms": r["k1_int_mm_ms"]} if "k1_int_mm_ms" in r else {}),
                        **({"x_lanes": r["x_lanes"], "block": r["block"]}
                           if "x_lanes" in r else {})}
                    for m, r in k1_by_mode.items()}
        elif kname == "int8_matmul":
            lines.append({**common, **{k: rep_i8[k] for k in timing},
                          "shape": {k: rep_i8[k] for k in ("shape", "M", "K", "N", "real",
                                                           "tile", "blocks")}})
        else:
            lines.append({**common, **{k: rep_gw[k] for k in timing},
                          "bound_3xtf32_ms": rep_gw["bound_3xtf32_ms"],
                          "shape": {k: rep_gw[k] for k in (*shape_keys, "M", "block",
                                                           "stacks", "split", "g_lanes")}})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", default=None,
                    help="also append every phase line to this file (the "
                         "kernels line is long)")
    ap.add_argument("--baseline", action="store_true",
                    help="time an older source tree against this one: run from "
                         "a copy of that tree with this script in it; the build "
                         "phase reports the SASS counts without requiring the "
                         "instances such a tree lacks, and no ok line is printed")
    args = ap.parse_args(argv)
    if args.log:
        global LOG_PATH
        LOG_PATH = args.log
        os.makedirs(os.path.dirname(os.path.abspath(LOG_PATH)), exist_ok=True)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script measures the port "
              "on a GPU and does not fall back", file=sys.stderr)
        return 2
    device, ref_device = torch.device("cuda", 0), torch.device("cpu")
    cfg = cnn.ResNetConfig()
    buckets, kernel_batch, reps, plain_reps = (1, 8, 32, 128), 32, 20, 3
    t_start = time.time()

    card = gpu_name_and_limit()
    ver = subprocess.run([_build.find_nvcc(), "--version"], text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=ver.stdout.strip().splitlines()[-2:],
         card=card, device=torch.cuda.get_device_name(0))

    _build.load()
    mma = tensor_core_instances(require=not args.baseline)
    emit("build", seconds=_build.build_seconds, library=os.path.relpath(
        str(_build.library_path()), ROOT), flags=list(_build.NVCC_FLAGS),
         baseline=args.baseline,
         k2_int8_imma_instructions=mma["int8"], k2_f32_hmma_instructions=mma["f32"],
         k2_bf16_hmma_instructions=mma["bf16"], k3_f32_hmma_instructions=mma["k3_f32"],
         k3_bf16_hmma_instructions=mma["k3_bf16"], k1_f32_hmma_instructions=mma["k1_f32"],
         k1_bf16_hmma_instructions=mma["k1_bf16"],
         k1_int8_imma_instructions=mma["k1_int8"], k2_int8_sass_sha1=mma["k2_int8_sass"],
         k1_int8_resources=resource_usage(K1_INT8_KERNEL),
         k4_imma_instructions=mma["k4"], k4_resources=resource_usage(K4_KERNEL))
    worst, rep, k2_by_mode = phase_kernels(cfg, device, kernel_batch, reps, plain_reps)
    phase_kernels_f32_train(cfg, device, TRAIN_BATCH, reps, plain_reps, worst, k2_by_mode)
    worst["block_sparse_grad_weight"], rep_gw = phase_kernels_grad_weight(
        cfg, device, TRAIN_BATCH, reps, plain_reps)
    k1_by_mode = {m: k2_by_mode[m] for m in ("streamed", "int8", "f32", "streamed_batch1",
                                             "streamed_batch1_packed")}
    phase_kernels_dx_train(cfg, device, TRAIN_BATCH, reps, plain_reps, worst, k1_by_mode)
    worst["int8_matmul"], rep_i8 = phase_kernels_int8_matmul(device, reps, plain_reps)

    # pruned once on the host, so both servers hold identical weights
    host_model = hapm_model(cfg, 0, N_CU, ref_device)[:2]
    models = {ref_device: host_model,
              device: tuple(tree_map(lambda t: t.to(device), t) for t in host_model)}
    sizes = request_sizes(buckets)
    frames = torch.from_numpy(np.random.RandomState(1).rand(
        sum(sizes), cfg.image_size, cfg.image_size, 3).astype(np.float32))
    devices = (device, ref_device)
    streamed = dict(quantized=True, folded=True, streamed=True,
                    activation_dsb=True, dense_fallback=2.0, n_cu=N_CU)

    # ---- main path 1, serving: every count set to 0 just before, read just after
    kernels.reset_launch_counts()
    srv_u, _ = serve_phase("serve_unpacked", cfg,
                           cnn.ExecSpec(packed=False, **streamed), buckets,
                           models, frames, devices, sizes=sizes,
                           kernel_name="implicit_block_sparse_conv")
    srv_p, _ = serve_phase("serve_packed", cfg,
                           cnn.ExecSpec(packed=True, **streamed), buckets,
                           models, frames, devices, sizes=sizes,
                           kernel_name="implicit_block_sparse_conv")
    # the materializing contract (K1 int8 on the patch rows), both layouts
    materializing = {}
    for label, packed in (("materializing", True), ("materializing_unpacked", False)):
        materializing[label], _ = serve_phase(
            f"serve_{label}", cfg,
            cnn.ExecSpec(packed=packed, quantized=True, folded=True, streamed=True,
                         implicit=False, dense_fallback=2.0, n_cu=N_CU),
            buckets, models, frames, devices, sizes=[sizes[3]],
            kernel_name="block_sparse_matmul")
    paths = {"serve": kernels.launch_counts()}

    phase_default_cli(device)
    phase_ladder(cfg, cnn.ExecSpec(packed=True, **streamed), buckets, models,
                 frames, devices)
    phase_timing({"unpacked": srv_u, "packed": srv_p, **materializing}, buckets, frames,
                 device, reps, card)

    # ---- main path 2, training: the QAT net through trainable binds
    qat = dataclasses.replace(cfg, quantized=True)
    train_model = hapm_model(cfg, 0, N_CU, device)
    batch = train_batch(cfg, 0, device, TRAIN_BATCH)
    kernels.reset_launch_counts()
    train_u = phase_train("train_unpacked", qat, False, train_model, batch, device)
    train_p = phase_train("train_packed", qat, True, train_model, batch, device)
    paths["train"] = kernels.launch_counts()

    phase_train_grad_parity(dataclasses.replace(cfg, quantized=False), train_model,
                            batch, device)
    phase_train_default(qat, train_model, batch, device)
    phase_train_cli(device)
    emit("train_summary", card=card, batch=TRAIN_BATCH, **{
        f"{label}_{k}": out[k] for label, out in (("unpacked", train_u), ("packed", train_p))
        for k in ("step_p50_ms", "step_p99_ms", "device_ms_per_step", "kernel_share")})

    # ---- main path 3, fixed point: K4 under fixed_point_matmul
    kernels.reset_launch_counts()
    phase_fixed_point(device)
    paths["fixed_point"] = kernels.launch_counts()
    phase_fixed_point_timing(device, reps)

    # ---- main path 4, pricing: simulate on the card (counts reset inside,
    # just before the card's runs)
    paths["price"] = phase_price(cfg, device, card)
    phase_quickstart(device)

    # ---- main path 5, the executed-sparsity bench twin (counts reset inside,
    # just before its run); then the execution contracts at full width
    paths["sparse_cnn"] = phase_sparse_cnn_bench(card)
    phase_exec_contracts(cfg, device, card)

    # ---- main path 6, the serving bench twin (counts reset inside, just
    # before its run); then a fixed-bm server at full width in both layouts
    t0 = time.time()
    paths["serving_cnn"] = phase_serving_cnn_bench(card)
    fixed_bm_s = phase_fixed_bm_servers(cfg, buckets, models, frames, devices, sizes)
    emit("serving_summary", card=card, seconds=time.time() - t0, fixed_bm_seconds=fixed_bm_s)

    for path, counts in paths.items():
        for kname in PATH_KERNELS[path]:
            if counts[kname] < 1:
                raise AssertionError(f"the {path} path never launched {kname}")

    emit("done", seconds=time.time() - t_start)
    if args.baseline:
        return 0
    print(card, flush=True)
    print(json.dumps({"kernels": kernels_line(paths, worst, rep, rep_gw, rep_i8,
                                              k2_by_mode, k1_by_mode)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
