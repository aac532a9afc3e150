"""The plain reference of the paper's ResNet, in plain PyTorch: every
convolution an explicit im2col and one matrix product, nothing batched or
cached, no kernel of the program. Imports only ``torch``.

Two forwards:

- :func:`served_logits`: the served contract. BatchNorm folded into the
  convs, per-output-channel weight scales calibrated from each folded
  weight's absolute maximum, the int8 Q2.5 x Q3.4 products summed exactly
  (float64 holds every such sum), the epilogue (dequantize, add the bias,
  ReLU after conv0 and every conv1, requantize onto the Q3.4 wire) as
  separately rounded float32 operations, residual adds on codes clamped to
  the post-ReLU range, and the head in float64. ``bits=4`` computes the
  same network in int4 (codes up to 7 and an activation grid of whole
  units), the precision below the configuration's.
- :func:`qat_logits`: the training forward of the quantization-aware
  network. Weights fake-quantized on the static Q2.5 grid, activations on
  Q3.4, BatchNorm on batch statistics, gradients by autograd (the
  straight-through estimator passes where the value lies on the grid's
  range).

Weights are nested dicts with HWIO conv weights and NHWC activations.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Q25 = (32.0, 127)      # weights: codes per unit, largest code
Q34 = (16.0, 127)      # activations
INT4_ACT = (1.0, 7)    # activations in int4: the same range, whole units


def layers(model: dict) -> list:
    """(path, k, stride) of every conv, in execution order."""
    out = [(("conv0", "w"), 3, 1)]
    cin = model["widths"][0]
    for si, (n_blocks, width) in enumerate(zip(model["stages"], model["widths"])):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            name = f"s{si}b{bi}"
            out.append(((name, "conv1", "w"), 3, stride))
            out.append(((name, "conv2", "w"), 3, 1))
            if stride != 1 or cin != width:
                out.append(((name, "proj", "w"), 1, stride))
            cin = width
    return out


def get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def same_pads(n: int, k: int, stride: int):
    """SAME padding as XLA splits it: the smaller half first."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, Ho, Wo, k * k * C), taps ordered (kx, ky, c) as a
    HWIO weight flattens."""
    b, h, w, c = x.shape
    (t, bo), (le, r) = same_pads(h, k, stride), same_pads(w, k, stride)
    xp = F.pad(x, (0, 0, le, r, t, bo))
    ho, wo = -(-h // stride), -(-w // stride)
    taps = [xp[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride, :]
            for i in range(k) for j in range(k)]
    return torch.cat(taps, dim=-1)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME convolution, NHWC x HWIO, in the operands' dtype."""
    k, cout = w.shape[0], w.shape[-1]
    return im2col(x, k, stride) @ w.reshape(-1, cout)


# ---------------------------------------------------------------------------
# the served contract
# ---------------------------------------------------------------------------

def inv_std(var: torch.Tensor, eps: float) -> torch.Tensor:
    """1 / sqrt(var + eps): the root taken in float64 and rounded to
    float32 (the correctly rounded float32 root), then a float32 division."""
    return 1.0 / torch.sqrt((var + eps).double()).float()


def fold(params: dict, state: dict, masks: dict, model: dict) -> dict:
    """{conv path: (w', b')} of the pruned network: w' = w * mask * scale /
    sqrt(var + eps) per output channel, b' = bias - mean * scale /
    sqrt(var + eps)."""
    out = {}
    for path, _, _ in layers(model):
        bn = {"conv0": "bn0", "conv1": "bn1", "conv2": "bn2", "proj": "bnp"}[path[-2]]
        p = get(params, path[:-2] + (bn,))
        s = get(state, path[:-2] + (bn,))
        g = p["scale"] * inv_std(s["var"], model["bn_eps"])
        out[path] = (get(params, path) * masks[path] * g, p["bias"] - s["mean"] * g)
    return out


def weight_codes(w: torch.Tensor, bits: int):
    """Per-output-channel calibration: (codes as float64, scale row f32).
    Each channel's absolute maximum maps to the largest code; an all-zero
    channel takes the static Q2.5 scale."""
    top = 2 ** (bits - 1) - 1
    cout = w.shape[-1]
    absmax = torch.amax(torch.abs(w.reshape(-1, cout)), dim=0).double()
    scales = torch.where(absmax > 0, top / torch.clamp(absmax, min=1e-30),
                         torch.full_like(absmax, Q25[0])).float()
    codes = torch.clamp(torch.round(w * scales), -top, top)
    return codes.double(), scales


def act_codes(x: torch.Tensor, grid) -> torch.Tensor:
    scale, top = grid
    return torch.clamp(torch.round(x * scale), -top, top)


def served_logits(params: dict, state: dict, masks: dict, model: dict,
                  frames: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Logits (float64) of the served network for ``frames`` (B, H, W, C)
    in [0, 1]; ``masks`` {conv path: element mask} prunes the raw weights
    before folding."""
    grid = Q34 if bits == 8 else INT4_ACT
    a_scale = torch.tensor(grid[0], dtype=torch.float32, device=frames.device)
    folded = fold(params, state, masks, model)
    stride_of = {path: s for path, _, s in layers(model)}

    def layer(path, h, relu):
        w, b = folded[path]
        codes, scales = weight_codes(w, bits)
        acc = conv(h, codes, stride_of[path]).float()       # exact: |acc| < 2**24
        row = 1.0 / (scales * a_scale)
        y = acc * row + b
        if relu:
            y = torch.clamp(y, min=0.0)
        return act_codes(y, grid).double()

    h = layer(("conv0", "w"), act_codes(frames.float(), grid).double(), True)
    for si, n_blocks in enumerate(model["stages"]):
        for bi in range(n_blocks):
            name = f"s{si}b{bi}"
            y = layer((name, "conv1", "w"), h, True)
            y = layer((name, "conv2", "w"), y, False)
            sc = layer((name, "proj", "w"), h, False) if (name, "proj", "w") in folded else h
            h = torch.clamp(y + sc, 0, grid[1])
    pooled = h.mean(dim=(1, 2)) / grid[0]
    return pooled @ params["fc"]["w"].double() + params["fc"]["b"].double()


# ---------------------------------------------------------------------------
# the quantization-aware training forward
# ---------------------------------------------------------------------------

class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, top):
        ctx.save_for_backward(x)
        ctx.bound = top / scale
        return torch.clamp(torch.round(x * scale), -top, top) / scale

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        inside = (x >= -ctx.bound) & (x <= ctx.bound)
        return torch.where(inside, g, torch.zeros_like(g)), None, None


def fake_quant(x: torch.Tensor, grid) -> torch.Tensor:
    return _FakeQuant.apply(x, grid[0], grid[1])


def batch_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    mean = torch.mean(x, dim=(0, 1, 2))
    var = torch.var(x, dim=(0, 1, 2), unbiased=False)
    return (x - mean) * inv_std(var, eps) * p["scale"] + p["bias"]


def qat_logits(params: dict, frames: torch.Tensor, model: dict) -> torch.Tensor:
    """Training-mode logits of the QAT network (params already masked)."""
    eps = model["bn_eps"]

    def cbr(h, blk, conv_name, bn_name, stride):
        return batch_norm(conv(h, fake_quant(blk[conv_name]["w"], Q25), stride),
                          blk[bn_name], eps)

    h = fake_quant(frames, Q34)
    h = fake_quant(torch.relu(cbr(h, params, "conv0", "bn0", 1)), Q34)
    for si, n_blocks in enumerate(model["stages"]):
        for bi in range(n_blocks):
            blk = params[f"s{si}b{bi}"]
            stride = 2 if (si > 0 and bi == 0) else 1
            y = fake_quant(torch.relu(cbr(h, blk, "conv1", "bn1", stride)), Q34)
            y = cbr(y, blk, "conv2", "bn2", 1)
            sc = cbr(h, blk, "proj", "bnp", stride) if "proj" in blk else h
            h = fake_quant(torch.relu(y + sc), Q34)
    pooled = h.mean(dim=(1, 2))
    return pooled @ params["fc"]["w"] + params["fc"]["b"]
