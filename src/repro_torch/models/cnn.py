"""The paper's validation network: a ResNet-type CNN with 21 conv layers
for 32×32×3 / 10-class classification (He et al. CIFAR ResNet-20 + two 1×1
projection shortcuts = 21 convs, ≈0.046 GOP/image as in paper §IV-B) — the
default :class:`ResNetConfig` — and the ImageNet ResNets with bottleneck
blocks, a 7×7/2 stem and a 3×3/2 max-pool (``block="bottleneck",
stem="imagenet"``: ResNet-50 v1.5 in ``configs/resnet50_v15.py``). One
walker (:func:`network`) lists every conv of a configuration; every
function here that follows the network's topology reads it.

Plain functions on tensors: params/state are nested dicts with the JAX
package's keys, conv weights in HWIO layout (kx, ky, cin, cout) matching
``core.groups.fpga_conv_groups``, activations NHWC — so every table, plan
and byte count of the JAX package applies unchanged.

:func:`apply` runs inference (``train=False``) and training
(``train=True``: batch-statistics BN, gradients through the block-sparse
kernels under an ``ExecSpec(trainable=True)`` bind); BN folding and the
folded dataflows serve; :func:`bind_execution` binds every conv layer onto
the CUDA block-sparse kernels. Entry points that allocate take a
``device`` and default to the GPU: with no GPU and no explicit
``device="cpu"`` they raise.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import OrderedDict
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from ..accel.cycle_model import ConvLayerDims
from ..core import quant as Q
from ..core.groups import fpga_conv_groups
from ..core.masks import (to_numpy, tree_flatten_with_path, tree_map,
                          tree_map_with_path)
from ..kernels.conv_lowering import pad_nhwc, same_pads

PyTree = Any


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller asks
    for something else. Asking for (or defaulting to) CUDA on a machine
    without one raises — nothing silently lands on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "this entry point runs on a CUDA device and none is "
                "available — pass device=\"cpu\" to run the plain PyTorch "
                "versions on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class BindError(RuntimeError):
    """Base of the bind-failure taxonomy: anything that stops
    :func:`bind_execution` from producing a usable exec. The serving
    resilience ladder (:mod:`repro.launch.resilience`) keys its recovery
    on the subclass — transient failures retry with backoff, permanent
    ones downgrade immediately."""


class TransientBindError(BindError):
    """A bind failure that may succeed on retry (resource pressure,
    injected chaos, a racing invalidation) — the ladder retries it with
    exponential backoff before downgrading."""


class PermanentBindError(BindError, ValueError):
    """A bind failure no retry can fix: the request violates the bind
    contract (non-tensor weights, incompatible quant spec, ...). Also a
    :class:`ValueError` so pre-taxonomy callers catching that keep
    working. The ladder skips retries and downgrades one rung."""


BOTTLENECK_EXPANSION = 4      # a bottleneck block's output channels / its width
_BLOCKS = ("basic", "bottleneck")
_STEMS = ("cifar", "imagenet")


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """``block``: ``"basic"`` (two 3×3 convs) or ``"bottleneck"`` (1×1 →
    3×3 at the block's stride → 1×1 to ``BOTTLENECK_EXPANSION`` × the
    width; v1.5's placement of the stride). ``stem``: ``"cifar"`` (one 3×3
    conv at stride 1) or ``"imagenet"`` (a 7×7 conv at stride 2, then a
    3×3/2 max-pool). The repr leaves both out at their defaults, so the
    default configuration prints (and fingerprints) as the JAX package's."""
    stages: Tuple[int, ...] = (3, 3, 3)
    widths: Tuple[int, ...] = (16, 32, 64)
    num_classes: int = 10
    in_channels: int = 3
    image_size: int = 32
    quantized: bool = False            # QAT with Q2.5 / Q3.4
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    block: str = "basic"
    stem: str = "cifar"

    def __post_init__(self):
        if self.block not in _BLOCKS or self.stem not in _STEMS:
            raise ValueError(f"block must be one of {_BLOCKS} and stem one of "
                             f"{_STEMS}, got {self.block!r}, {self.stem!r}")

    def __repr__(self):
        fields = [f for f in dataclasses.fields(self)
                  if f.name not in ("block", "stem") or getattr(self, f.name) != f.default]
        return (f"{type(self).__name__}("
                + ", ".join(f"{f.name}={getattr(self, f.name)!r}" for f in fields) + ")")


class ConvNode(NamedTuple):
    """One conv of the network: its weight's path, its BN's key, kernel
    size, stride, channels, input size (square), and whether a ReLU
    follows its BN directly."""
    path: Tuple[str, ...]
    bn: str
    k: int
    stride: int
    cin: int
    cout: int
    feat: int
    relu: bool

    @property
    def out(self) -> int:
        return -(-self.feat // self.stride)          # SAME


class BlockNode(NamedTuple):
    """A residual block: its main path's convs in order and its projection
    shortcut (``None`` for the identity)."""
    name: str
    convs: Tuple[ConvNode, ...]
    proj: Optional[ConvNode]


class Network(NamedTuple):
    """The network of a :class:`ResNetConfig`: the stem conv, whether a
    3×3/2 max-pool follows it, the blocks, every conv in execution order
    (each block's main path, then its projection), and the head's input
    channels."""
    stem: ConvNode
    pool: bool
    blocks: Tuple[BlockNode, ...]
    convs: Tuple[ConvNode, ...]
    head_channels: int


def _pool_out(n: int) -> int:
    """Output size of the 3×3/2 max-pool with one pixel of padding."""
    return (n - 1) // 2 + 1


@functools.lru_cache(maxsize=None)
def network(cfg: ResNetConfig) -> Network:
    """The one walk of ``cfg``'s network, derived once a configuration."""
    imagenet = cfg.stem == "imagenet"
    k0, s0 = (7, 2) if imagenet else (3, 1)
    stem = ConvNode(("conv0", "w"), "bn0", k0, s0, cfg.in_channels, cfg.widths[0],
                    cfg.image_size, True)
    feat = _pool_out(stem.out) if imagenet else stem.out
    cin = cfg.widths[0]
    blocks, convs = [], [stem]
    for si, (n_blocks, width) in enumerate(zip(cfg.stages, cfg.widths)):
        for bi in range(n_blocks):
            name = f"s{si}b{bi}"
            stride = 2 if (si > 0 and bi == 0) else 1
            node = lambda conv, bn, k, s, ci, co, f, relu: ConvNode(
                (name, conv, "w"), bn, k, s, ci, co, f, relu)
            out = -(-feat // stride)
            if cfg.block == "basic":
                cout = width
                main = (node("conv1", "bn1", 3, stride, cin, width, feat, True),
                        node("conv2", "bn2", 3, 1, width, width, out, False))
            else:
                cout = BOTTLENECK_EXPANSION * width
                main = (node("conv1", "bn1", 1, 1, cin, width, feat, True),
                        node("conv2", "bn2", 3, stride, width, width, feat, True),
                        node("conv3", "bn3", 1, 1, width, cout, out, False))
            proj = (node("proj", "bnp", 1, stride, cin, cout, feat, False)
                    if stride != 1 or cin != cout else None)
            blocks.append(BlockNode(name, main, proj))
            convs += list(main) + ([proj] if proj is not None else [])
            feat, cin = out, cout
    return Network(stem, imagenet, tuple(blocks), tuple(convs), cin)


def tree_from_numpy(tree: PyTree, device=None) -> PyTree:
    """Nested dict of numpy (or array-like) leaves -> the same dict of f32
    tensors on ``device`` (copies; keys and NHWC/HWIO layouts unchanged)."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dev),
        tree)


def tree_to_numpy(tree: PyTree) -> PyTree:
    return tree_map(to_numpy, tree)


def params_from_numpy(params_np: PyTree, state_np: PyTree = None, *,
                      device=None) -> Tuple[PyTree, PyTree]:
    """Carry weights across from the JAX package: its ``(params, state)``
    trees as nested dicts of numpy arrays -> the port's trees — same keys,
    same NHWC/HWIO layout, f32 tensors on ``device``."""
    params = tree_from_numpy(params_np, device)
    state = None if state_np is None else tree_from_numpy(state_np, device)
    return params, state


def params_to_numpy(params: PyTree, state: PyTree = None):
    """Inverse of :func:`params_from_numpy`."""
    return tree_to_numpy(params), (None if state is None
                                   else tree_to_numpy(state))


def _subtree(tree: dict, keys) -> dict:
    """The dict at ``keys`` in ``tree`` (``tree`` itself for no key), made
    where it is missing."""
    for k in keys:
        tree = tree.setdefault(k, {})
    return tree


def _conv_init(gen, kx, ky, cin, cout):
    fan_in = kx * ky * cin
    return torch.randn((kx, ky, cin, cout), generator=gen) * float(np.sqrt(2.0 / fan_in))


def _bn_init(c):
    return {"scale": torch.ones((c,)), "bias": torch.zeros((c,))}


def _bn_state_init(c):
    return {"mean": torch.zeros((c,)), "var": torch.ones((c,))}


def init(gen, cfg: ResNetConfig, *, device=None) -> Tuple[PyTree, PyTree]:
    """Returns (params, state); state holds BN running stats. ``gen`` is a
    CPU ``torch.Generator`` or an int seed; values are drawn on the host in
    a fixed layer order (so a seed gives the same weights on every device)
    and moved to ``device``. Shapes and key names are the JAX package's;
    the values are not (the two frameworks' random streams differ)."""
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))
    net = network(cfg)
    params: dict = {}
    state: dict = {}
    for c in net.convs:
        p, s = _subtree(params, c.path[:-2]), _subtree(state, c.path[:-2])
        p[c.path[-2]] = {"w": _conv_init(gen, c.k, c.k, c.cin, c.cout)}
        p[c.bn] = _bn_init(c.cout)
        s[c.bn] = _bn_state_init(c.cout)
    cin = net.head_channels
    params["fc"] = {
        "w": torch.randn((cin, cfg.num_classes), generator=gen) * float(np.sqrt(1.0 / cin)),
        "b": torch.zeros((cfg.num_classes,)),
    }
    to_dev = lambda t: t.to(dev)
    return tree_map(to_dev, params), tree_map(to_dev, state)


def _maybe_qw(w, cfg: ResNetConfig):
    return Q.quantize(w, Q.Q2_5) if cfg.quantized else w


def _maybe_qa(x, cfg: ResNetConfig):
    return Q.quantize(x, Q.Q3_4) if cfg.quantized else x


class _DenseConv(torch.autograd.Function):
    """``F.conv2d`` (NCHW/OIHW, no padding): the forward with cuDNN switched
    off (exact sums, see :func:`_conv`), the backward on cuDNN with TF32
    switched off. The backward of a plain ``F.conv2d`` call picks its
    backend again when autograd runs it, outside any ``cudnn.flags`` block
    of the forward, so it ran on cuDNN with TF32 (``allow_tf32`` defaults to
    True): on an H100 the gradients of a 16x16 net's dense training step at
    batch 4 read 4.1e-4 from float64 on the conv0 weight that way."""

    @staticmethod
    def forward(ctx, xn, wn, stride):
        ctx.save_for_backward(xn, wn)
        ctx.stride = stride
        with torch.backends.cudnn.flags(enabled=False):
            return F.conv2d(xn, wn, stride=stride)

    @staticmethod
    def backward(ctx, g):
        xn, wn = ctx.saved_tensors
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, xn, wn, None, [ctx.stride] * 2, [0, 0], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None


def _conv(x, w, stride):
    """Dense NHWC/HWIO SAME convolution through the library — the dense
    rung and the dense-fallback layers. The input is padded explicitly
    (XLA's SAME split; ``conv2d(padding=...)`` is symmetric and differs at
    stride 2). On CUDA the forward runs with cuDNN switched off
    (:class:`_DenseConv`): PyTorch's own convolution is an im2col GEMM in
    full f32 (no TF32, which would flip requantized codes, and no
    Winograd/FFT transform), so on fake-quant operands its sums are exact,
    as the executed-int8 kernels' are; the backward runs on cuDNN in full
    f32 (TF32 off). The operands are copied to contiguous NCHW/OIHW first:
    the backward of oneDNN's CPU convolution on the permuted views corrupts
    the heap (torch 2.13.0+cpu, seen on a ResNet with a stride-2 stage)."""
    kx, ky = int(w.shape[0]), int(w.shape[1])
    xp = pad_nhwc(x, same_pads(x.shape[1], kx, stride),
                  same_pads(x.shape[2], ky, stride))
    xn, wn = xp.permute(0, 3, 1, 2).contiguous(), w.permute(3, 2, 0, 1).contiguous()
    if x.is_cuda:
        y = _DenseConv.apply(xn, wn, stride)
    else:
        y = F.conv2d(xn, wn, stride=stride)
    return y.permute(0, 2, 3, 1)


def _global_avg_pool(h: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C): the mean over the spatial axes, summed image
    by image in a fixed order (pairwise halves, elementwise adds) and
    divided once. ``torch.mean`` on CUDA splits its reduction by the whole
    tensor's shape, so an image's pooled value could change with the batch
    it is served in (an H100 read other bits for 2 frames served in a
    bucket of 8 than in one of 4); here it depends on the image alone, and
    padding a request up to its bucket stays bit-exact at every rung."""
    b, hh, ww, c = h.shape
    n = hh * ww
    s = h.reshape(b, n, c)
    while s.shape[1] > 1:
        half = s.shape[1] // 2
        s = torch.cat([s[:, :half] + s[:, half:2 * half], s[:, 2 * half:]], dim=1)
    return s[:, 0] / n


def _inv_std(var, eps):
    """1/sqrt(var + eps) as a correctly rounded square root and a correctly
    rounded division — the same bits on the CPU and on the GPU, which an
    approximate ``rsqrt`` does not give. BN-folded weights feed per-channel
    calibration and int8 code emission, and BN's output feeds the Q3.4
    activation codes, so a last-bit difference between devices would flip
    codes. ``torch.sqrt`` of an f32 CUDA tensor is not correctly rounded
    (an H100 gave another last bit than the CPU for some values); the root
    is taken in f64 and rounded to f32, which is the correctly rounded f32
    root (53 >= 2 * 24 + 2 bits) and the CPU's f32 ``torch.sqrt`` bit for
    bit. The f32 sum and division are the same bits on both devices."""
    return 1.0 / torch.sqrt((var + eps).double()).float()


def _bn(x, p, s, train: bool, cfg: ResNetConfig):
    """BatchNorm over NHWC -> (y, new running stats). ``train``: batch mean
    and population variance, running stats moved by ``cfg.bn_momentum``
    (outside autograd); otherwise the running stats, returned unchanged."""
    if train:
        mean = torch.mean(x, dim=(0, 1, 2))
        var = torch.var(x, dim=(0, 1, 2), unbiased=False)
        with torch.no_grad():
            m = cfg.bn_momentum
            new_s = {"mean": m * s["mean"] + (1 - m) * mean,
                     "var": m * s["var"] + (1 - m) * var}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    y = (x - mean) * _inv_std(var, cfg.bn_eps) * p["scale"] + p["bias"]
    return y, new_s


def apply(
    params: PyTree,
    state: PyTree,
    x: torch.Tensor,
    cfg: ResNetConfig,
    train: bool = False,
    *,
    sparse: Any = None,
) -> Tuple[torch.Tensor, PyTree]:
    """Forward pass. ``x``: (B, H, W, C) in [0, 1]. Returns (logits,
    new_state): with ``train=False`` the BN state passed in, with
    ``train=True`` a new tree of running statistics.

    Pruning masks are applied to *params* beforehand (``core.apply_masks``),
    keeping this function mask-agnostic.

    ``sparse`` selects the conv execution path:
      - ``None``/``False``: dense library convolution (default);
      - a :class:`SparseConvExec` (from :func:`bind_execution`): every conv
        dispatches through the block-sparse kernel on its bound plan with
        its *bind-time prepacked* weight, except layers the bind left
        dense (density ≈ 1 fallback). Bind with ``quantized=cfg.quantized``
        so the prepacked weights match the dense path's per-call
        quantization.
      - ``True``: bind a :class:`SparseConvExec` from the zero slabs of
        ``params`` on the params' own device. Binds are memoized on the
        identity of ``params``.

    A *prepacked* exec (the default bind) is inference-only with respect
    to the conv weights: they are bind-time constants, so gradients could
    not reach ``params`` through sparse-bound layers — ``train=True`` with
    such an exec raises. An ``ExecSpec(trainable=True)`` bind instead
    passes each layer's weight to its bound conv per call, whose
    ``autograd.Function`` runs the transposed-plan / live-tile backward
    kernels: ``train=True`` is supported, gradients flow, pruned groups get
    exactly zero gradient. Rebind after each HAPM epoch either way.
    """
    with tracing.span("cnn.forward", train=train):
        return _apply(params, state, x, cfg, train, sparse)


def _apply(params, state, x, cfg: ResNetConfig, train: bool, sparse):
    sparse = _resolve_sparse(sparse, params, cfg.quantized)
    if train and sparse is not None and not sparse.trainable:
        raise ValueError(
            "this sparse exec is inference-only: conv weights are prepacked "
            "bind-time constants, so training gradients would silently not "
            "reach params — bind with ExecSpec(trainable=True) to train "
            "through the block-sparse kernels (rebind after each HAPM "
            "epoch), or train dense")

    def conv(path, h, w, stride):
        fn = sparse.table.get(path) if sparse is not None else None
        with tracing.span("cnn.conv", layer=path, kernel=fn is not None):
            if fn is None:
                return _conv(h, w, stride)
            if sparse.trainable:
                return fn(h, w, stride=stride)   # per-call weight
            return fn(h, stride=stride)   # weight prepacked at bind time

    def conv_bn(c, h, p, st, ns):
        y = conv(c.path, h, _maybe_qw(p[c.path[-2]]["w"], cfg), c.stride)
        y, ns[c.bn] = _bn(y, p[c.bn], st[c.bn], train, cfg)
        return _maybe_qa(torch.relu(y), cfg) if c.relu else y

    # the accelerator ingests Q3.4 activations for every layer, the input
    # frame included — quantize it so the executed-int8 path can match the
    # QAT forward exactly on codes (images are 8-bit sources anyway)
    net = network(cfg)
    new_state: dict = {}
    h = conv_bn(net.stem, _maybe_qa(x, cfg), params, state, new_state)
    if net.pool:
        with tracing.span("cnn.pool"):
            h = _max_pool(h)
    for blk in net.blocks:
        p, st = params[blk.name], state[blk.name]
        ns: dict = {}
        y = h
        for c in blk.convs:
            y = conv_bn(c, y, p, st, ns)
        sc = h if blk.proj is None else conv_bn(blk.proj, h, p, st, ns)
        with tracing.span("cnn.residual", block=blk.name):
            h = _maybe_qa(torch.relu(y + sc), cfg)
        new_state[blk.name] = ns
    with tracing.span("cnn.head"):
        pooled = _global_avg_pool(h)
        logits = pooled @ params["fc"]["w"] + params["fc"]["b"]
    return logits, (new_state if train else state)


def _max_pool(h: torch.Tensor) -> torch.Tensor:
    """The ImageNet stem's 3×3/2 max-pool with one pixel of padding, NHWC.
    On int8 wire codes it pools the codes: max commutes with the monotone
    requantization, so this is pool-then-requantize bit for bit (the codes
    pass through float16, which holds every code exactly). Its input
    follows a ReLU, so the library's −∞ padding is zero padding."""
    hn = h.permute(0, 3, 1, 2)
    if h.dtype == torch.int8:
        return F.max_pool2d(hn.to(torch.float16), 3, 2, padding=1).to(
            torch.int8).permute(0, 2, 3, 1)
    return F.max_pool2d(hn, 3, 2, padding=1).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Pruning / accelerator integration
# ---------------------------------------------------------------------------

def is_conv_weight(path, leaf) -> bool:
    """Prunable = 4-D conv kernels (the paper prunes conv layers)."""
    return hasattr(leaf, "ndim") and leaf.ndim == 4


def conv_group_specs(params: PyTree, n_cu: int) -> PyTree:
    """GroupSpec tree for HAPM over every conv weight (None elsewhere)."""
    def f(path, leaf):
        if is_conv_weight(path, leaf):
            return fpga_conv_groups(tuple(leaf.shape), n_cu)
        return None
    return tree_map_with_path(f, params)


def _get_path(tree, keys):
    node = tree
    for k in keys:
        node = node[k]
    return node


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """The execution contract of one bind: every knob that changes the
    compiled artifact :func:`bind_execution` produces. Frozen and hashable
    on purpose — it doubles as the spec component of the serving exec-cache
    key (``launch.exec_cache``: ``(arch fp, sparsity fp, spec, bucket)``),
    so two binds compare equal iff they are interchangeable.

    ``packed``: matrix-unit-shaped multi-group tiles vs one (g, f_block) group per
    tile. ``quantized``: native int8 Q2.5×Q3.4 execution (per-cout
    calibrated scales when ``folded``). ``folded``: the tree is
    ``fold_batchnorm`` output and the bias/ReLU epilogue is fused at the
    kernel flush (consume with :func:`apply_folded`). ``implicit``: the
    in-kernel window-gather data-movement contract (``None`` = auto on
    channel-major layouts). ``bm``: M-blocking policy, ``"auto"`` or a
    fixed int. ``n_cu``: the schedule-group granularity. Layers whose plan
    density reaches ``dense_fallback`` stay on the dense
    library convolution.

    ``trainable``: bound convs take the caller's weight per call and
    carry an ``autograd.Function`` — :func:`apply` with ``train=True`` runs
    the block-sparse kernels forward *and* backward, gradients reach
    ``params``, pruned groups get exactly zero gradient. Incompatible with
    ``quantized``/``folded`` (both are inference contracts; QAT trains
    through the f32 fake-quant view, which this path consumes as-is).
    Rebind after each HAPM epoch, exactly like inference binds.

    ``streamed``: end-to-end int8 activation streaming — every bound
    conv's flush **requantizes in-epilogue** and emits int8 Q3.4 codes,
    which the next layer's gather consumes directly (the wire between
    layers carries 1-byte codes, no f32 round-trip through HBM — the
    paper's accelerator contract). Requires ``quantized`` (the wire is
    int8 codes) **and** ``folded`` (conv → +b → ReLU must complete
    in-kernel for the flushed value to be the final activation);
    inference-only. Consume with :func:`apply_folded`, which runs the
    whole residual dataflow on codes (int32 residual adds) and
    dequantizes once at the head.

    ``activation_dsb``: dual-sided sparsity — every bound implicit-kernel
    conv skips the gather+product pass for activation window blocks that are
    all-zero **int8 codes** (post-ReLU zeros are exact codes, so the
    skip is bit-exact at every density; Zhu et al., arXiv 2001.01955).
    Requires ``quantized`` (the zero test is exact only on codes) and the
    implicit kernel (``implicit`` must not be ``False``). Measure the
    realized skip with :meth:`SparseConvExec.measure_dsb_skip` /
    ``report(dsb_sample=...)``.

    Invalid field combinations raise a single :class:`ValueError` listing
    every violated pair by name — the contract table below is the one
    authority, callers never see layer-dependent messages.
    """

    packed: bool = True
    quantized: bool = False
    folded: bool = False
    implicit: Optional[bool] = None
    bm: Any = "auto"
    n_cu: int = 12
    dense_fallback: float = 0.999
    trainable: bool = False
    streamed: bool = False
    activation_dsb: bool = False

    def __post_init__(self):
        # contract table: collect EVERY violation, raise once, naming the
        # offending fields — not first-failure-wins across layers
        violations = []
        if self.bm != "auto" and not isinstance(self.bm, int):
            violations.append(f"bm must be 'auto' or an int, got {self.bm!r}")
        if self.n_cu < 1:
            violations.append(f"n_cu must be >= 1, got {self.n_cu}")
        if self.trainable and self.quantized:
            violations.append(
                "trainable+quantized: int8-code execution is "
                "inference-only (QAT trains through the fake-quant f32 "
                "view; rebind quantized for serving)")
        if self.trainable and self.folded:
            violations.append(
                "trainable+folded: the fused bias/ReLU epilogue is "
                "inference-only (fold_batchnorm at serving bind time)")
        if self.trainable and self.streamed:
            violations.append(
                "trainable+streamed: activation streaming is "
                "inference-only (the requantizing epilogue has no VJP)")
        if self.streamed and not self.quantized:
            violations.append(
                "streamed without quantized: the wire between layers "
                "carries int8 Q3.4 codes — streaming requires the "
                "int8-code kernels")
        if self.streamed and not self.folded:
            violations.append(
                "streamed without folded: conv → +b → ReLU must complete "
                "in-kernel for the flush to emit the final activation "
                "codes — stream a fold_batchnorm tree")
        if self.activation_dsb and not self.quantized:
            violations.append(
                "activation_dsb without quantized: the zero-block skip is "
                "keyed on exact int8 codes — f32 zeros are a tolerance "
                "question the kernel refuses to answer")
        if self.activation_dsb and self.implicit is False:
            violations.append(
                "activation_dsb with implicit=False: the skip lives in "
                "the implicit kernel's window gather — the materializing "
                "path has no window to test")
        if violations:
            raise ValueError(
                "invalid ExecSpec: " + "; ".join(violations))


@dataclasses.dataclass(frozen=True)
class SparseConvExec:
    """Static dispatch table for the group-sparse conv path: conv param path
    -> bound block-sparse conv (``sparse.conv_plan.make_sparse_conv``, the
    masked weight prepacked at bind time), or ``None`` for layers left on
    the dense library-convolution fallback. ``plans`` keeps every layer's
    BlockSparsePlan (fallback layers included) for grid-step accounting;
    ``layouts`` / ``group_masks`` carry the occupancy-based schedule-group
    accounting that survives multi-group (packed) tiles. Rebuild after HAPM
    prunes more groups."""

    table: Any                       # {path: conv fn | None}
    plans: Any                       # {path: BlockSparsePlan}
    n_cu: int
    layouts: Any = None              # {path: ConvGemmLayout}
    group_masks_np: Any = None       # {path: (num_groups,) float}
    quantized: bool = False          # int8-code operands, int32-accumulate kernels
    folded: bool = False             # bias/ReLU epilogue fused (apply_folded only)
    streamed: bool = False           # in-epilogue requantize: layers exchange
                                     # int8 Q3.4 codes (apply_folded wire mode)
    activation_dsb: bool = False     # dual-sided: implicit kernel skips
                                     # all-zero int8 activation windows
    trainable: bool = False          # convs take per-call weights, autograd.Function
    bound_weights: Any = None        # {path: source weight} — staleness check
    implicit: bool = False           # convs bound to the implicit-im2col kernel
    bm: Any = 128                    # M-blocking policy: int (fixed) or "auto"
    spec: Optional[ExecSpec] = None  # the requested bind contract, if built
                                     # through bind_execution

    def _accounting(self, bm=None, implicit=None, operand_bytes=None,
                    dtype_bytes: int = 4, out_bytes=None):
        """The single default-resolution point for every accounting query:
        ``None`` means "this exec's own policy" — ``bm`` resolves to the
        bind-time M-blocking, ``implicit`` to the bound data-movement
        contract, ``operand_bytes`` to 1 byte for a quantized (int8-code)
        exec and ``dtype_bytes`` otherwise, ``out_bytes`` to 1 byte for a
        streamed exec (the requantizing epilogue writes int8 codes) and
        ``dtype_bytes`` otherwise (the f32 output write)."""
        return (self.bm if bm is None else bm,
                self.implicit if implicit is None else implicit,
                ((1 if self.quantized else dtype_bytes)
                 if operand_bytes is None else operand_bytes),
                ((1 if self.streamed else dtype_bytes)
                 if out_bytes is None else out_bytes))

    def _m_blocks(self, out: int, batch: int, bm=None, implicit=None):
        from ..sparse.conv_plan import conv_m_blocks
        bm, implicit, _, _ = self._accounting(bm, implicit)
        return conv_m_blocks(out, out, batch, bm=bm, implicit=implicit)

    def step_counts(self, cfg: ResNetConfig, batch: int = 1, bm=None):
        """(executed, dense) dispatched grid steps over the whole network —
        what the kernel grid actually visits on *this* exec's tile layout
        and M-blocking policy (``bm=None`` → the exec's own; pass an int
        for the fixed PR-3 blocking). Executed steps per layer =
        M-row-blocks × live tiles."""
        executed = dense = 0
        for path, stride, feat in conv_layer_order(cfg):
            plan = self.plans[path]
            out = -(-feat // stride)
            mb, _ = self._m_blocks(out, batch, bm)
            executed += mb * int(plan.cnt.sum())
            dense += mb * plan.tiles[0] * plan.tiles[1]
        return executed, dense

    def bm_effective(self, cfg: ResNetConfig, batch: int = 1, bm=None,
                     implicit=None):
        """{layer-path: effective bm} under this exec's M-blocking policy
        (``bm``/``implicit`` override it, e.g. the canonical adaptive
        implicit contract regardless of the bind)."""
        return {"/".join(path):
                self._m_blocks(-(-feat // stride), batch, bm, implicit)[1]
                for path, stride, feat in conv_layer_order(cfg)}

    def hbm_bytes(self, cfg: ResNetConfig, batch: int = 1,
                  implicit: Any = None, bm=None, dtype_bytes: int = 4,
                  operand_bytes: Any = None, out_bytes: Any = None) -> int:
        """Analytic HBM bytes one forward moves through the conv layers
        (``sparse.conv_plan.conv_hbm_bytes`` summed over the network) —
        patch-matrix traffic for the materializing path, activation-slab
        streaming for the implicit one. Defaults resolve through
        :meth:`_accounting`: the exec's own contract, M-blocking, operand
        width (1 byte when quantized), and output-write width (1 byte
        when streamed — the requantizing epilogue emits codes)."""
        from ..sparse.conv_plan import conv_hbm_bytes
        bm, use_implicit, operand_bytes, out_bytes = self._accounting(
            bm, implicit, operand_bytes, dtype_bytes, out_bytes)
        total = 0
        for path, stride, feat in conv_layer_order(cfg):
            total += conv_hbm_bytes(
                self.layouts[path], self.group_masks_np[path], batch, feat,
                feat, stride, "SAME", implicit=use_implicit,
                bm=bm, dtype_bytes=dtype_bytes, operand_bytes=operand_bytes,
                out_bytes=out_bytes)
        return total

    def schedule_step_counts(self):
        """(live, total) paper-granularity (g, f_block) schedule steps over
        the network, from per-tile group occupancy — layout-independent, so
        it equals the cycle model's DSB step count even when packed tiles
        cover many groups."""
        live = total = 0
        for path, layout in self.layouts.items():
            occ_live, occ_total = layout.tile_occupancy(self.group_masks_np[path])
            live += int(occ_live.sum())
            total += int(occ_total.sum())
        return live, total

    def mac_utilization(self, cfg: ResNetConfig, batch: int = 1,
                        bm=None) -> float:
        """Network padded-MAC utilization: useful MACs (real output rows ×
        live weight elements) per dispatched MAC area (padded M-blocks ×
        dispatched tile area). M-padding-aware: a batch-1 4×4 tail padded
        to a fixed ``bm=128`` shows up as an 8× utilization hit here,
        which the adaptive (``bm="auto"``) policy removes. At exact
        M-multiples this reduces to the PR-3 (M-cancelling) metric."""
        num = den = 0.0
        for path, stride, feat in conv_layer_order(cfg):
            out = -(-feat // stride)
            mb, bm_eff = self._m_blocks(out, batch, bm)
            live_elems, area = self.layouts[path].mac_accounting(
                self.group_masks_np[path])
            num += batch * out * out * live_elems
            den += mb * bm_eff * area
        return num / den if den else 0.0

    def measure_dsb_skip(self, tree: PyTree, x: torch.Tensor,
                         cfg: ResNetConfig, state: PyTree = None) -> dict:
        """One forward with the kernel-side skip counter on, through the
        real network dataflow (``apply_folded`` for folded execs,
        ``apply`` otherwise — ``state`` required there), summing each
        bound layer's ``conv.skip_counts`` stats.  Returns
        ``{"dsb_skip_frac", "dsb_skipped_steps", "dsb_live_steps",
        "dsb_per_layer"}`` — the *measured* dual-sided skip fraction
        (skipped / dispatched live grid steps; 0.0 for a bind without
        ``activation_dsb``), the number the simulator prices next to its
        ``data_col_nonzero_frac`` prediction.  ``tree`` is the tree the
        exec was bound from (the folded tree for folded execs); the
        forward's outputs are bit-identical to the unmeasured one (the
        counter is a second kernel output, not a different kernel)."""
        if self.trainable:
            raise ValueError("measure_dsb_skip needs a prebound exec — "
                             "trainable binds have no packed weight to "
                             "run the counter against")
        totals = {"skipped": 0, "live": 0}
        per_layer: dict = {}

        def wrap(keys, fn):
            def wrapped(h, stride=1, padding="SAME"):
                y, st = fn.skip_counts(h, stride=stride, padding=padding)
                if st is not None:
                    totals["skipped"] += st["skipped_steps"]
                    totals["live"] += st["live_steps"]
                    agg = per_layer.setdefault(
                        "/".join(keys), {"skipped_steps": 0, "live_steps": 0})
                    agg["skipped_steps"] += st["skipped_steps"]
                    agg["live_steps"] += st["live_steps"]
                return y
            return wrapped

        shadow = dataclasses.replace(self, table={
            k: (wrap(k, fn) if fn is not None else None)
            for k, fn in self.table.items()})
        if self.folded:
            apply_folded(tree, x, cfg, sparse=shadow)
        else:
            if state is None:
                raise ValueError("measure_dsb_skip on a non-folded exec "
                                 "runs apply() — pass the BN state")
            apply(tree, state, x, cfg, sparse=shadow)
        return {
            "dsb_skip_frac": totals["skipped"] / max(totals["live"], 1),
            "dsb_skipped_steps": totals["skipped"],
            "dsb_live_steps": totals["live"],
            "dsb_per_layer": per_layer,
        }

    def report(self, cfg: ResNetConfig, batch: int = 1, *,
               dtype_bytes: int = 4, per_layer: bool = False,
               dsb_sample: Optional[torch.Tensor] = None,
               dsb_tree: PyTree = None,
               dsb_state: PyTree = None) -> dict:
        """Every accounting field in one dict — the single artifact the
        simulator (``accel.simulator``), the benches and the serving program
        (``launch.serve_cnn``) consume instead of each re-assembling the
        same step/HBM/utilization numbers from the individual methods.

        The ``hbm_bytes_{materialized,implicit}[_int8]`` fields price the
        two data-movement contracts at their *defining* M-blocking
        (materializing: fixed ``bm=128``, the PR-3 contract; implicit:
        adaptive ``bm="auto"``) and at f32 / int8 operand widths — they are
        properties of the plans, independent of which contract this exec
        happens to bind. ``hbm_bytes_streamed_int8`` is the end-to-end
        int8 contract on top of the implicit one: 1-byte operands AND
        1-byte output writes (the requantizing epilogue emits Q3.4 codes
        the next layer ingests). ``hbm_bytes`` and the grid-step fields
        describe the exec's *own* policy (own contract, own ``bm``, own
        operand/output widths). ``per_layer=True`` adds the same fields
        per conv layer (keys ``"/".join(path)``), which is what the
        simulator reports next to the cycle model.

        ``dsb_sample`` (with ``dsb_tree``, the tree this exec was bound
        from, and ``dsb_state`` for non-folded execs) additionally runs
        :meth:`measure_dsb_skip` on that input and merges its
        ``dsb_skip_frac`` / ``dsb_skipped_steps`` / ``dsb_live_steps``
        fields — the measured dual-sided skip accounting."""
        executed, dense = self.step_counts(cfg, batch=batch)
        live, total = self.schedule_step_counts()
        hbm = lambda imp, bm, ob, out=None: self.hbm_bytes(
            cfg, batch, implicit=imp, bm=bm, dtype_bytes=dtype_bytes,
            operand_bytes=ob, out_bytes=dtype_bytes if out is None else out)
        rep = {
            "batch": batch,
            "n_cu": self.n_cu,
            "quantized": self.quantized,
            "folded": self.folded,
            "streamed": self.streamed,
            "activation_dsb": self.activation_dsb,
            "implicit": self.implicit,
            "bm": self.bm,
            "executed_grid_steps": executed,
            "dense_grid_steps": dense,
            "grid_step_ratio": executed / max(dense, 1),
            "schedule_steps_live": live,
            "schedule_steps_total": total,
            "schedule_step_ratio": live / max(total, 1),
            "padded_mac_utilization": self.mac_utilization(cfg, batch=batch),
            "dense_fallback_layers": sum(v is None
                                         for v in self.table.values()),
            "bm_effective": self.bm_effective(cfg, batch=batch),
            "hbm_bytes": self.hbm_bytes(cfg, batch, dtype_bytes=dtype_bytes),
            "hbm_bytes_materialized": hbm(False, 128, dtype_bytes),
            "hbm_bytes_implicit": hbm(True, "auto", dtype_bytes),
            "hbm_bytes_materialized_int8": hbm(False, 128, 1),
            "hbm_bytes_implicit_int8": hbm(True, "auto", 1),
            "hbm_bytes_streamed_int8": hbm(True, "auto", 1, 1),
        }
        rep["hbm_bytes_ratio"] = (rep["hbm_bytes_implicit"]
                                  / max(rep["hbm_bytes_materialized"], 1))
        if per_layer:
            rep["per_layer"] = self._per_layer_report(cfg, batch, dtype_bytes)
        if dsb_sample is not None:
            rep.update(self.measure_dsb_skip(dsb_tree, dsb_sample, cfg,
                                             state=dsb_state))
        return rep

    def _per_layer_report(self, cfg: ResNetConfig, batch: int,
                          dtype_bytes: int) -> dict:
        from ..sparse.conv_plan import conv_hbm_bytes
        out = {}
        for path, stride, feat in conv_layer_order(cfg):
            plan = self.plans[path]
            o = -(-feat // stride)
            mb, bm_eff = self._m_blocks(o, batch)
            hbm = lambda imp, bm, ob, out_b=None: conv_hbm_bytes(
                self.layouts[path], self.group_masks_np[path], batch, feat,
                feat, stride, "SAME", implicit=imp, bm=bm,
                dtype_bytes=dtype_bytes, operand_bytes=ob,
                out_bytes=dtype_bytes if out_b is None else out_b)
            out["/".join(path)] = {
                "executed": mb * int(plan.cnt.sum()),
                "dense": mb * plan.tiles[0] * plan.tiles[1],
                "bm_effective": bm_eff,
                "hbm_materialized": hbm(False, 128, dtype_bytes),
                "hbm_implicit": hbm(True, "auto", dtype_bytes),
                "hbm_materialized_int8": hbm(False, 128, 1),
                "hbm_implicit_int8": hbm(True, "auto", 1),
                "hbm_streamed_int8": hbm(True, "auto", 1, 1),
            }
        return out



def _bind_conv_layers(tree: PyTree, specs: PyTree, group_masks: PyTree,
                      n_cu: int, packed: bool, weight_of, bind_one):
    """Shared bind loop: walk the conv weights of ``tree``, derive each
    layer's (spec, group mask, layout, plan), and let
    ``bind_one(keys, w, layout, gm, plan, leaf)`` produce the table entry.
    ``weight_of(leaf)`` is the weight the mask derivation should score
    (e.g. the Q2.5-quantized view); ``leaf`` is the raw tensor for binders
    that quantize themselves (a calibrated QuantSpec must see unclipped
    values — pre-quantizing onto the static grid would double-quantize)."""
    from ..sparse.conv_plan import conv_gemm_layout

    if specs is None:
        specs = conv_group_specs(tree, n_cu)
    table, plans, layouts, gms, bound = {}, {}, {}, {}, {}
    for keys, leaf in tree_flatten_with_path(tree):
        if not is_conv_weight(keys, leaf):
            continue
        if not isinstance(leaf, torch.Tensor):
            raise PermanentBindError(
                "binding a sparse exec needs concrete torch tensors (plans are "
                f"host-side numpy) but got {type(leaf).__name__} at "
                f"{'/'.join(keys)} — convert with params_from_numpy first")
        w = weight_of(leaf)
        spec = _get_path(specs, keys)
        if group_masks is None:
            gm = None
        elif (isinstance(group_masks, dict)
              and all(isinstance(k, tuple) for k in group_masks)):
            # flat {path-tuple: mask} form (exec.group_masks_np /
            # derive_group_masks) alongside the params-shaped tree form
            gm = group_masks.get(keys)
        else:
            gm = _get_path(group_masks, keys)
        if gm is None:
            # tile specs score the 2-D im2col matrix, not the HWIO tensor
            w2 = w.reshape(spec.shape) if tuple(w.shape) != spec.shape else w
            gm = to_numpy(spec.group_scores(w2)) > 0
        gm = np.asarray(to_numpy(gm), np.float32)
        layout = conv_gemm_layout(spec, packed=packed)
        plan = layout.plan(gm)
        plans[keys], layouts[keys], gms[keys] = plan, layout, gm
        bound[keys] = leaf
        table[keys] = bind_one(keys, w, layout, gm, plan, leaf)
    return table, plans, layouts, gms, bound


def _relu_after(tree: PyTree, keys: tuple) -> bool:
    """Whether a ReLU follows the conv at ``keys`` directly after its BN,
    read from the tree's keys where the bind has no config: the stem, and
    every conv of a block's main path but its last (``conv2`` of a basic
    block, ``conv3`` of a bottleneck); never the projection."""
    if len(keys) == 2:
        return True
    if keys[-2] == "proj":
        return False
    last = max(k for k in _get_path(tree, keys[:-2]) if k.startswith("conv"))
    return keys[-2] != last


def derive_group_masks(tree: PyTree, n_cu: int, *,
                       quantized: bool = False,
                       specs: PyTree = None) -> "dict[tuple, np.ndarray]":
    """The bind loop's default mask rule, standalone: per conv layer the
    {0,1} live-group mask from the weights' zero slabs
    (``group_scores(w) > 0``, scored on the Q2.5-quantized view when
    ``quantized`` — a group whose every value quantizes to zero is
    skippable in fixed-point execution even if not exactly zero in f32).
    Returned flat (``{path-tuple: mask}``), ready both for
    ``bind_execution(group_masks=...)`` and for
    :func:`repro_torch.sparse.conv_plan.mask_fingerprint` — the serving
    cache fingerprints the sparsity pattern *without* paying a bind."""
    if specs is None:
        specs = conv_group_specs(tree, n_cu)
    weight_of = ((lambda l: Q.quantize(l, Q.Q2_5)) if quantized
                 else (lambda l: l))
    masks = {}
    for keys, leaf in tree_flatten_with_path(tree):
        if not is_conv_weight(keys, leaf):
            continue
        w = weight_of(leaf)
        spec = _get_path(specs, keys)
        w2 = w.reshape(spec.shape) if tuple(w.shape) != spec.shape else w
        masks[keys] = np.asarray(to_numpy(spec.group_scores(w2)) > 0, np.float32)
    return masks


def _resolve_exec_implicit(implicit: Optional[bool], layouts) -> bool:
    """The exec-level execution contract: what the bind *requested*
    (resolved against layout capability), not which layers happened to
    bind — an all-dense-fallback exec must still price/report the
    contract its kernels would run."""
    capable = any(lo.implicit_geometry() is not None
                  for lo in layouts.values())
    return capable if implicit is None else bool(implicit) and capable


def bind_execution(
    params: PyTree,
    cfg: Optional[ResNetConfig] = None,
    *,
    spec: Optional[ExecSpec] = None,
    specs: PyTree = None,
    group_masks: PyTree = None,
    quant_spec: Any = None,
    bind_kernels: bool = True,
    device=None,
) -> SparseConvExec:
    """The one bind entry point: every conv layer of ``params`` onto the
    block-sparse kernels under the execution contract ``spec`` (an
    :class:`ExecSpec`; default: packed layout, auto-implicit kernel,
    adaptive M-blocking, f32).

    ``spec.folded=False`` (plain bind): ``params`` is the raw param tree.
    With ``spec.quantized`` every bound layer prepacks **int8 Q2.5 weight
    codes** (pruned groups stay zero codes) plus the per-cout dequant
    scale row, quantizes its input activation to int8 Q3.4 codes per
    call, and runs int8-operand / int32-accumulate kernels with the
    dequant fused at the flush — bit-exact vs a ``cfg.quantized`` dense
    forward. ``quant_spec`` overrides the static formats with a custom
    :class:`repro_torch.core.quant.QuantSpec`. Consume with :func:`apply`.

    ``spec.folded=True``: ``params`` is ``fold_batchnorm`` output (per-conv
    ``{"w", "b"}``) and the bias — plus ReLU where the network applies it
    directly after BN (conv0, every conv1) — is fused at the kernel's
    flush step. With ``spec.quantized`` each layer gets **per-cout
    calibrated** weight scales (BN folding scales channels arbitrarily, so
    the static Q2.5 grid would clip); ``quant_spec`` is rejected here.
    Consume with :func:`apply_folded`.

    ``spec.streamed=True`` (implies ``quantized`` + ``folded``): every
    bound layer's flush additionally **requantizes in-epilogue** to the
    uniform Q3.4 wire scale and emits int8 codes, and its ingest skips
    the per-call quantize when the input is already codes.
    :func:`apply_folded` detects the streamed exec and runs the whole
    residual dataflow on codes.

    ``cfg``: the network the tree holds; a folded bind reads each conv's
    ReLU from its walk (:func:`network`), and without it from the tree's
    keys. ``specs``: GroupSpec tree (default:
    ``conv_group_specs(params, spec.n_cu)``). ``group_masks``:
    (num_groups,) {0,1} per conv leaf (e.g. ``HAPMState.group_masks``);
    ``None`` derives masks from the weights' zero slabs.
    ``bind_kernels=False`` builds an **accounting-only** exec: plans,
    layouts and group masks for :meth:`SparseConvExec.report`, with every
    table entry ``None`` — no kernel closures, no weight packing, and no
    device needed.

    ``device``: where the packed weights, epilogue rows and dispatch
    tables live and where the bound convs run — the GPU by default
    (raises without one); ``device="cpu"`` binds the plain PyTorch
    versions explicitly. Weights on another device are copied at bind
    time. On CUDA an int ``spec.bm`` above the kernels' cap (128) raises
    :class:`PermanentBindError` before any layer binds; the CPU takes any.

    ``spec.trainable=True`` (plain trees only): nothing is prepacked — each
    bound conv re-packs the weight ``apply`` hands it per call, so the exec
    stays valid while an epoch's optimizer steps move the weights, and its
    ``autograd.Function`` runs the backward kernels. Rebind when the group
    masks change (a HAPM epoch).

    A prepacked exec is pinned to these exact weight tensors — ``apply`` rejects a
    params tree whose conv leaves differ (rebind after updates, or serve
    through ``launch.exec_cache`` which re-keys on the sparsity
    fingerprint).

    Every call counts in the recorder's always-on counters ``cnn.binds`` and
    ``cnn.bind_ns`` (its host time), and is the span ``cnn.bind``.
    """
    t0 = time.perf_counter_ns()
    try:
        with tracing.span("cnn.bind"):
            return _bind_execution(params, cfg, spec, specs, group_masks, quant_spec,
                                   bind_kernels, device)
    finally:
        tracing.count("cnn.binds")
        tracing.count("cnn.bind_ns", time.perf_counter_ns() - t0)


def _bind_execution(params, cfg, spec, specs, group_masks, quant_spec, bind_kernels,
                    device) -> SparseConvExec:
    from ..kernels.block_sparse_matmul import KERNEL_MAX_BM
    from ..sparse.conv_plan import make_sparse_conv

    spec = ExecSpec() if spec is None else spec
    dev = resolve_device(device) if bind_kernels else None
    if (dev is not None and dev.type == "cuda" and isinstance(spec.bm, int)
            and spec.bm > KERNEL_MAX_BM):
        # refused here, before any layer binds: the CUDA kernels take at
        # most KERNEL_MAX_BM rows per M-block, and an exec bound past it
        # would fail at its first call (the CPU's plain versions take any)
        raise PermanentBindError(
            f"ExecSpec.bm={spec.bm} exceeds the CUDA kernels' cap of "
            f"bm <= {KERNEL_MAX_BM} rows per M-block on {dev} — use "
            f"bm='auto' or an int <= {KERNEL_MAX_BM}")
    if spec.folded:
        if quant_spec is not None:
            raise PermanentBindError(
                "folded binds calibrate per-cout scales per layer — a "
                "global quant_spec would clip BN-scaled channels; it is "
                "plain-exec only")
        tree = {k: v for k, v in params.items() if k != "fc"}
        weight_of = lambda l: l
        # streamed wire: every layer emits AND ingests the same static
        # Q3.4 activation scale (the per-layer chain is uniform — folded
        # binds calibrate weight scales only, activations stay on the
        # paper's fixed grid)
        out_q = Q.QuantSpec() if spec.streamed else None
        relu_of = (None if cfg is None
                   else {c.path: c.relu for c in network(cfg).convs})

        def bind_one(keys, w, layout, gm, plan, leaf):
            if not bind_kernels or plan.density >= spec.dense_fallback:
                return None
            bias = _get_path(params, keys[:-1])["b"]
            relu = (_relu_after(params, keys) if relu_of is None
                    else relu_of[keys])
            quant = Q.QuantSpec.calibrate(w) if spec.quantized else None
            if out_q is not None and quant.act_scale != out_q.act_scale:
                raise PermanentBindError(
                    f"streamed wire scale mismatch at {'/'.join(keys)}: "
                    f"layer ingests activation scale {quant.act_scale} but "
                    f"the wire emits {out_q.act_scale} — streaming needs a "
                    "uniform per-layer scale chain")
            return make_sparse_conv(layout, gm, bm=spec.bm, weight=w,
                                    bias=bias, relu=relu,
                                    implicit=spec.implicit, quant=quant,
                                    out_quant=out_q,
                                    activation_dsb=spec.activation_dsb,
                                    device=dev)
    else:
        if quant_spec is not None and not spec.quantized:
            raise PermanentBindError(
                "quant_spec without quantized=True would be "
                "silently ignored — pass quantized=True")
        qspec = (quant_spec or Q.QuantSpec()) if spec.quantized else None
        tree = params
        weight_of = ((lambda l: Q.quantize(l, Q.Q2_5)) if spec.quantized
                     else (lambda l: l))

        def bind_one(keys, w, layout, gm, plan, leaf):
            # quantized: bind the RAW weight — the quant spec emits the
            # codes itself, and a calibrated spec must not see values
            # pre-clipped to the static Q2.5 grid (for the static spec the
            # two are identical: round(fake_quant(w)·2^5) == round(w·2^5))
            if not bind_kernels or plan.density >= spec.dense_fallback:
                return None
            if spec.trainable:
                # no prepack: the conv re-packs the caller's weight every
                # call, so mid-epoch updates are never stale
                return make_sparse_conv(layout, gm, bm=spec.bm,
                                        implicit=spec.implicit,
                                        trainable=True, device=dev)
            return make_sparse_conv(layout, gm, bm=spec.bm,
                                    weight=leaf if spec.quantized else w,
                                    implicit=spec.implicit, quant=qspec,
                                    activation_dsb=spec.activation_dsb,
                                    device=dev)

    table, plans, layouts, gms, bound = _bind_conv_layers(
        tree, specs, group_masks, spec.n_cu, spec.packed, weight_of,
        bind_one)
    return SparseConvExec(table=table, plans=plans, n_cu=spec.n_cu,
                          layouts=layouts, group_masks_np=gms,
                          quantized=spec.quantized, folded=spec.folded,
                          streamed=spec.streamed,
                          activation_dsb=spec.activation_dsb,
                          trainable=spec.trainable,
                          bound_weights=None if spec.trainable else bound,
                          implicit=_resolve_exec_implicit(spec.implicit,
                                                          layouts),
                          bm=spec.bm, spec=spec)


# sparse=True builds are memoized on params identity: the cache holds a
# strong reference to the keyed params tree, which pins its id() for the
# lifetime of the entry. A true LRU with an explicit bound.
_SPARSE_EXEC_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_SPARSE_EXEC_CACHE_MAX = 4


def _resolve_sparse(sparse, params, quantized: bool = False) -> Optional[SparseConvExec]:
    if sparse is None or sparse is False:
        return None
    if sparse is True:
        key = (id(params), quantized)
        hit = _SPARSE_EXEC_CACHE.get(key)
        if hit is not None and hit[0] is params:
            _SPARSE_EXEC_CACHE.move_to_end(key)
            return hit[1]
        # one-group-per-tile layout for the memoized path — its grid-step
        # accounting is what tests pin down; bound where the params live
        exec_ = bind_execution(
            params, spec=ExecSpec(packed=False, quantized=quantized,
                                  implicit=None),
            device=params["conv0"]["w"].device)
        while len(_SPARSE_EXEC_CACHE) >= _SPARSE_EXEC_CACHE_MAX:
            _SPARSE_EXEC_CACHE.popitem(last=False)
        _SPARSE_EXEC_CACHE[key] = (params, exec_)
        return exec_
    if isinstance(sparse, SparseConvExec):
        if sparse.folded:
            raise ValueError(
                "this SparseConvExec fuses the folded-BN bias/ReLU epilogue "
                "(ExecSpec(folded=True)) — apply() would run BN on top of "
                "it; consume it with apply_folded()")
        if sparse.trainable:
            # per-call weights: nothing is prepacked, so there is nothing
            # to go stale and no code/float mismatch — under cfg.quantized
            # the f32 kernels consume the caller's fake-quant view (QAT)
            return sparse
        if sparse.quantized != quantized:
            raise ValueError(
                f"SparseConvExec prepacked with quantized={sparse.quantized} "
                f"but cfg.quantized={quantized} — rebind with "
                f"bind_execution(..., spec=ExecSpec(quantized={quantized}))")
        # staleness guard: the exec's convs compute with the weights packed
        # at bind time, so a params tree with different conv leaves would
        # silently be ignored
        if sparse.bound_weights is not None:
            for keys, bound in sparse.bound_weights.items():
                try:
                    leaf = _get_path(params, keys[:-1])[keys[-1]]
                except (KeyError, TypeError):
                    leaf = None
                if leaf is not bound and leaf is not None:
                    raise ValueError(
                        f"SparseConvExec is stale for {'/'.join(keys)}: its "
                        "prepacked bind-time weight is not the tensor in "
                        "params — rebuild the exec after weight updates")
        return sparse
    raise TypeError(f"sparse must be None/bool/SparseConvExec, got {type(sparse)}")


def conv_layer_order(cfg: ResNetConfig):
    """Execution-order list of (param-path, stride, input_feature_size) for
    every conv layer (21 for the default config, 53 for ResNet-50)."""
    return [(c.path, c.stride, c.feat) for c in network(cfg).convs]


def layer_dims(cfg: ResNetConfig, params: PyTree):
    """ConvLayerDims (padded sizes) per conv layer, execution order —
    feeds the Eq.-3 cycle model."""
    dims = []
    for path, stride, feat in conv_layer_order(cfg):
        kx, ky, cin, cout = (int(d) for d in _get_path(params, path).shape)
        out = -(-feat // stride)           # SAME conv output
        padded = (out - 1) * stride + kx   # input size incl. padding (Alg. 1 note)
        dims.append((path, ConvLayerDims(
            n_ix=max(padded, feat), n_iy=max(padded, feat),
            n_if=cin, n_of=cout, kx=kx, ky=ky, sx=stride, sy=stride)))
    return dims


def network_ops(cfg: ResNetConfig, params: PyTree) -> int:
    return sum(d.ops for _, d in layer_dims(cfg, params))


def fold_batchnorm(params: PyTree, state: PyTree, cfg: ResNetConfig) -> PyTree:
    """Inference-time BN folding: w' = w·γ/√(σ²+ε) (per cout), b' = β − μ·γ/√(σ²+ε).

    Scaling per output channel preserves zero groups, so HAPM masks survive
    folding unchanged — this is what the accelerator executes.
    """
    folded = {}
    for c in network(cfg).convs:
        blk, st = _get_path(params, c.path[:-2]), _get_path(state, c.path[:-2])
        g = blk[c.bn]["scale"] * _inv_std(st[c.bn]["var"], cfg.bn_eps)
        _subtree(folded, c.path[:-2])[c.path[-2]] = {
            "w": blk[c.path[-2]]["w"] * g[None, None, None, :],
            "b": blk[c.bn]["bias"] - st[c.bn]["mean"] * g}
    folded["fc"] = dict(params["fc"])
    return folded


def apply_folded(
    folded: PyTree,
    x: torch.Tensor,
    cfg: ResNetConfig,
    *,
    sparse: Optional[SparseConvExec] = None,
    wire_quantize: Optional[bool] = None,
) -> torch.Tensor:
    """Inference on BN-folded params (:func:`fold_batchnorm`): conv → +b →
    ReLU, no BN state. With ``sparse`` (a folded :class:`SparseConvExec`)
    every non-fallback conv runs through the block-sparse kernel with the
    bias/ReLU epilogue *fused at the flush step* — the accelerator's
    folded-BN execution, in one kernel per layer. Returns logits only.

    **Wire-quantized dataflow** (``ExecSpec(streamed=True)`` execs, or
    ``wire_quantize=True`` explicitly): every conv layer emits int8 Q3.4
    codes onto the wire — in-epilogue for streamed kernels, host-side
    ``round_sat`` at the identical program point otherwise — the first
    layer ingests the f32 frame, residual adds run on codes in exact
    int32 arithmetic (``clip(y + sc, 0, 127)`` *is*
    ``requantize(relu(dequant(y) + dequant(sc)))`` because Q3.4 codes
    dequantize exactly in f32), and the head dequantizes once before the
    average pool. ``wire_quantize=True`` on a **non-streamed** quantized
    folded exec is therefore the bit-exact reference for the streamed
    path: same kernels, same program points, requantization outside the
    kernel instead of inside — the bench gates their end-to-end code
    parity. The default float dataflow (f32 residual adds) is unchanged.
    """
    with tracing.span("cnn.forward", train=False):
        return _apply_folded(folded, x, cfg, sparse, wire_quantize)


def _apply_folded(folded, x, cfg: ResNetConfig, sparse, wire_quantize):
    if sparse is not None and not sparse.folded:
        raise ValueError(
            "apply_folded needs a folded SparseConvExec (ExecSpec("
            "folded=True)) — this one has no fused bias/ReLU epilogue, its "
            "convs would silently drop the folded bias")
    streamed = sparse is not None and sparse.streamed
    if streamed and wire_quantize is False:
        raise ValueError(
            "this exec's kernels requantize in-epilogue (streamed=True) — "
            "the wire dataflow cannot be disabled; bind streamed=False "
            "for the f32-output folded path")
    if wire_quantize and sparse is not None and not sparse.quantized:
        raise ValueError(
            "wire_quantize puts int8 codes on the wire — the bound f32 "
            "kernels cannot ingest them; use a quantized folded exec "
            "(the streamed-parity reference) or sparse=None")
    wire = streamed or bool(wire_quantize)
    # Q3.4 wire: the uniform activation scale every layer emits/ingests
    wire_scale = float(Q.Q3_4.scale)
    max_code = float(Q.Q3_4.max_code)

    def requant(y):
        return Q.round_sat(y * wire_scale, max_code).to(torch.int8)

    def conv(path, h, stride, relu):
        fn = sparse.table.get(path) if sparse is not None else None
        with tracing.span("cnn.conv", layer=path, kernel=fn is not None):
            if fn is not None:
                y = fn(h, stride=stride)      # bias/ReLU fused at bind time
                if not wire or y.dtype == torch.int8:   # streamed: already codes
                    return y
                return requant(y)             # wire reference: requantize here
            node = _get_path(folded, path[:-1])
            if h.dtype == torch.int8:           # fallback layer on the wire:
                h = h.to(torch.float32) / wire_scale    # exact f32 dequant
            y = _conv(h, node["w"], stride) + node["b"]
            y = torch.relu(y) if relu else y
            return requant(y) if wire else y

    net = network(cfg)
    h = conv(net.stem.path, x, net.stem.stride, relu=True)
    if net.pool:
        with tracing.span("cnn.pool"):
            h = _max_pool(h)
    for blk in net.blocks:
        y = h
        for c in blk.convs:
            y = conv(c.path, y, c.stride, c.relu)
        sc = h if blk.proj is None else conv(blk.proj.path, h, blk.proj.stride, False)
        with tracing.span("cnn.residual", block=blk.name):
            if wire:
                # residual add + ReLU on codes: int32 widen, clamp to the
                # post-ReLU code range — exact integer arithmetic
                h = torch.clamp(y.to(torch.int32) + sc.to(torch.int32),
                                0, int(max_code)).to(torch.int8)
            else:
                h = torch.relu(y + sc)
    with tracing.span("cnn.head"):
        if wire:
            h = h.to(torch.float32) / wire_scale        # head: exact dequant
        pooled = _global_avg_pool(h)
        return pooled @ folded["fc"]["w"] + folded["fc"]["b"]
