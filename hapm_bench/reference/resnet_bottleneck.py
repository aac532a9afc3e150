"""The plain reference of the ImageNet ResNets with bottleneck blocks
(ResNet-50 v1.5: He et al., arXiv:1512.03385, Table 1, the stride on each
block's 3×3 conv), in plain PyTorch: every convolution an explicit im2col
and one matrix product, nothing batched or cached, no kernel of the
program. Imports only ``torch`` and the helpers of :mod:`.resnet` and
:mod:`.prune_hapm`.

The network of a configuration's ``model`` group (``block:
"bottleneck"``, ``stem: "imagenet"``): a 7×7/2 conv, ReLU, a 3×3/2
max-pool with one pixel of padding, then stages of blocks, each 1×1 (ReLU)
→ 3×3 at the block's stride (ReLU) → 1×1 to four times the width, plus a
1×1 projection of the input at the block's stride on each stage's first
block, added and put through a ReLU; the average pool and the classifier.
Convolutions pad as XLA's SAME does (:func:`.resnet.same_pads`).

- :func:`served_logits`: the served contract, as :func:`.resnet.served_logits`
  defines it, on this network, with the max-pool on the stem's codes. The
  sums pass 2**24 here (K up to 4608 rows of codes up to 127 × 127): float64
  holds each exactly, and the served side's int32 sum is exact too; both
  sides round that integer to float32 once, to nearest, so they give the
  same float32 value.
- :func:`f32_logits`: the float32 network with BatchNorm on its running
  statistics, or, with ``state=None``, on each BatchNorm's batch statistics,
  which it returns: how the benchmark measures a state in which every BN
  output is standardized.
- :func:`hapm_masks`: HAPM's one-epoch group selection over this network's
  layer list.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .prune_hapm import expand, group_scores
from .resnet import INT4_ACT, Q34, act_codes, conv, get, inv_std, weight_codes

EXPANSION = 4
BN_OF = {"conv0": "bn0", "conv1": "bn1", "conv2": "bn2", "conv3": "bn3", "proj": "bnp"}


def pool_out(n: int) -> int:
    """Output size of the 3×3/2 max-pool with one pixel of padding."""
    return (n - 1) // 2 + 1


def layers(model: dict) -> list:
    """Every conv, in execution order (a block's main path, then its
    projection): ``{"path", "k", "stride", "cin", "cout", "h", "ho",
    "relu"}``, ``h``/``ho`` the input and output height."""
    feat = model["image_size"]
    ho = -(-feat // 2)
    out = [dict(path=("conv0", "w"), k=7, stride=2, cin=model["in_channels"],
                cout=model["widths"][0], h=feat, ho=ho, relu=True)]
    feat, cin = pool_out(ho), model["widths"][0]
    for si, (n_blocks, width) in enumerate(zip(model["stages"], model["widths"])):
        for bi in range(n_blocks):
            s = 2 if (si > 0 and bi == 0) else 1
            o, cout, name = -(-feat // s), EXPANSION * width, f"s{si}b{bi}"
            out += [dict(path=(name, "conv1", "w"), k=1, stride=1, cin=cin, cout=width,
                         h=feat, ho=feat, relu=True),
                    dict(path=(name, "conv2", "w"), k=3, stride=s, cin=width, cout=width,
                         h=feat, ho=o, relu=True),
                    dict(path=(name, "conv3", "w"), k=1, stride=1, cin=width, cout=cout,
                         h=o, ho=o, relu=False)]
            if s != 1 or cin != cout:
                out.append(dict(path=(name, "proj", "w"), k=1, stride=s, cin=cin,
                                cout=cout, h=feat, ho=o, relu=False))
            feat, cin = o, cout
    return out


def blocks(model: dict) -> list:
    """[(block name, [its main path's layers], its projection or None)]."""
    out: dict = {}
    for layer in layers(model)[1:]:
        main, proj = out.setdefault(layer["path"][0], ([], []))
        (proj if layer["path"][1] == "proj" else main).append(layer)
    return [(name, main, proj[0] if proj else None) for name, (main, proj) in out.items()]


def max_pool(h: torch.Tensor) -> torch.Tensor:
    """3×3/2 max-pool of (B, H, W, C) with one pixel of −∞ padding: the
    maximum of nine strided slices."""
    b, n, w, c = h.shape
    ho, wo = pool_out(n), pool_out(w)
    hp = F.pad(h, (0, 0, 1, 1, 1, 1), value=float("-inf"))
    taps = [hp[:, i:i + 2 * (ho - 1) + 1:2, j:j + 2 * (wo - 1) + 1:2, :]
            for i in range(3) for j in range(3)]
    return torch.stack(taps).amax(dim=0)


def fold(params: dict, state: dict, masks: dict, model: dict) -> dict:
    """{conv path: (w', b')} of the pruned network, as :func:`.resnet.fold`."""
    out = {}
    for layer in layers(model):
        path = layer["path"]
        bn = path[:-2] + (BN_OF[path[-2]],)
        p, s = get(params, bn), get(state, bn)
        g = p["scale"] * inv_std(s["var"], model["bn_eps"])
        out[path] = (get(params, path) * masks[path] * g, p["bias"] - s["mean"] * g)
    return out


def served_logits(params: dict, state: dict, masks: dict, model: dict,
                  frames: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Logits (float64) of the served network for ``frames`` (B, H, W, C)
    in [0, 1]: exact integer sums, the float32 epilogue, the max-pool on
    codes, residual adds on codes clamped to the post-ReLU range, the head
    in float64. ``bits=4``: the same network in int4."""
    grid = Q34 if bits == 8 else INT4_ACT
    a_scale = torch.tensor(grid[0], dtype=torch.float32, device=frames.device)
    folded = fold(params, state, masks, model)

    def layer(spec, h):
        w, b = folded[spec["path"]]
        codes, scales = weight_codes(w, bits)
        acc = conv(h, codes, spec["stride"]).float()    # the exact sum, rounded once
        y = acc * (1.0 / (scales * a_scale)) + b
        if spec["relu"]:
            y = torch.clamp(y, min=0.0)
        return act_codes(y, grid).double()

    h = layer(layers(model)[0], act_codes(frames.float(), grid).double())
    h = max_pool(h)
    for _, main, proj in blocks(model):
        y = h
        for spec in main:
            y = layer(spec, y)
        sc = h if proj is None else layer(proj, h)
        h = torch.clamp(y + sc, 0, grid[1])
    pooled = h.mean(dim=(1, 2)) / grid[0]
    return pooled @ params["fc"]["w"].double() + params["fc"]["b"].double()


def f32_logits(params: dict, state, model: dict, frames: torch.Tensor,
               masks: dict = None):
    """(logits, state) of the float32 network (``masks`` prune the convs'
    weights when given). BatchNorm uses ``state``'s running statistics; with
    ``state=None`` it uses each BN's batch statistics (mean, population
    variance) and returns them as the state."""
    measure = state is None
    out_state: dict = {}

    def conv_bn(spec, h):
        path = spec["path"]
        w = get(params, path) * (1.0 if masks is None else masks[path])
        y = conv(h, w, spec["stride"])
        bn = path[:-2] + (BN_OF[path[-2]],)
        if measure:
            s = {"mean": torch.mean(y, dim=(0, 1, 2)),
                 "var": torch.var(y, dim=(0, 1, 2), unbiased=False)}
        else:
            s = get(state, bn)
        node = out_state
        for key in bn[:-1]:
            node = node.setdefault(key, {})
        node[bn[-1]] = s
        p = get(params, bn)
        y = (y - s["mean"]) * inv_std(s["var"], model["bn_eps"]) * p["scale"] + p["bias"]
        return torch.relu(y) if spec["relu"] else y

    h = max_pool(conv_bn(layers(model)[0], frames.float()))
    for _, main, proj in blocks(model):
        y = h
        for spec in main:
            y = conv_bn(spec, y)
        sc = h if proj is None else conv_bn(proj, h)
        h = torch.relu(y + sc)
    logits = h.mean(dim=(1, 2)) @ params["fc"]["w"] + params["fc"]["b"]
    return logits, (out_state if measure else state)


def hapm_masks(params: dict, model: dict, pruning: dict) -> dict:
    """{conv path: element mask} after one epoch of HAPM on ``params``: the
    schedule groups of every conv pooled (in sorted path order), ranked by
    their absolute sums, the lowest ``min(ceil(s·total), round(s·total))``
    pruned (:mod:`.prune_hapm`'s rule over this network)."""
    n_cu, sparsity = pruning["n_cu"], pruning["group_sparsity"]
    paths = sorted(layer["path"] for layer in layers(model))
    scores = [group_scores(get(params, p), n_cu).double().cpu() for p in paths]
    total = sum(int(s.numel()) for s in scores)
    n_prune = min(math.ceil(sparsity * total), int(round(sparsity * total)))
    order = torch.sort(torch.cat(scores), stable=True).indices[:n_prune]
    keep = torch.ones(total)
    keep[order] = 0.0
    out, off = {}, 0
    for p, s in zip(paths, scores):
        w = get(params, p)
        out[p] = expand(keep[off:off + s.numel()], tuple(w.shape), n_cu).to(w.device)
        off += s.numel()
    return out
