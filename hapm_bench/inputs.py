"""What the benchmark makes from ``--seed`` and hands to both the program
and the plain reference: the raw weights and BN state of the network, and
labelled frames. Imports only ``torch``.

Everything is drawn on the given device by a ``torch.Generator`` of that
device, in a few large calls, so the same seed gives the same values on the
same kind of device. The key names and layouts (HWIO conv weights, NHWC
frames) are the ones the port's ``models/cnn.py`` consumes.
"""
from __future__ import annotations

import hashlib

import torch


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed (any
    whole number, of any size or sign) and the stream's name."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(subseed(seed, tag))
    return gen


def conv_layers(model: dict) -> list:
    """Every conv layer of the ResNet of ``model`` (the configuration's
    ``model`` group), in execution order: ``{"path", "k", "cin", "cout",
    "stride", "h", "ho"}`` with ``h``/``ho`` the input and output height."""
    feat, cin = model["image_size"], model["in_channels"]
    widths = model["widths"]
    out = [dict(path=("conv0", "w"), k=3, cin=cin, cout=widths[0], stride=1,
                h=feat, ho=feat)]
    cin = widths[0]
    for si, (n_blocks, width) in enumerate(zip(model["stages"], widths)):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            ho = -(-feat // stride)
            name = f"s{si}b{bi}"
            out.append(dict(path=(name, "conv1", "w"), k=3, cin=cin,
                            cout=width, stride=stride, h=feat, ho=ho))
            out.append(dict(path=(name, "conv2", "w"), k=3, cin=width,
                            cout=width, stride=1, h=ho, ho=ho))
            if stride != 1 or cin != width:
                out.append(dict(path=(name, "proj", "w"), k=1, cin=cin,
                                cout=width, stride=stride, h=feat, ho=ho))
            feat, cin = ho, width
    return out


def _bn_name(conv: str) -> str:
    return {"conv0": "bn0", "conv1": "bn1", "conv2": "bn2", "proj": "bnp"}[conv]


def make_weights(model: dict, seed: int, device):
    """(params, state) of the network: He-normal conv weights, a head drawn
    with std sqrt(1/width), a zero head bias, and BatchNorm as initialized
    (scale 1, bias 0, running mean 0, running variance 1). One normal draw
    on ``device`` covers every weight."""
    layers = conv_layers(model)
    width, classes = model["widths"][-1], model["num_classes"]
    sizes = [l["k"] * l["k"] * l["cin"] * l["cout"] for l in layers]
    z = torch.randn(sum(sizes) + width * classes,
                    generator=generator(seed, "weights", device), device=device)
    params: dict = {}
    state: dict = {}
    off = 0
    for layer, n in zip(layers, sizes):
        k, cin, cout = layer["k"], layer["cin"], layer["cout"]
        w = z[off:off + n].reshape(k, k, cin, cout) * (2.0 / (k * k * cin)) ** 0.5
        off += n
        block, conv = (None, "conv0") if layer["path"][0] == "conv0" else layer["path"][:2]
        p = params if block is None else params.setdefault(block, {})
        s = state if block is None else state.setdefault(block, {})
        p[conv] = {"w": w}
        p[_bn_name(conv)] = {"scale": torch.ones(cout, device=device),
                             "bias": torch.zeros(cout, device=device)}
        s[_bn_name(conv)] = {"mean": torch.zeros(cout, device=device),
                             "var": torch.ones(cout, device=device)}
    params["fc"] = {"w": z[off:].reshape(width, classes) * (1.0 / width) ** 0.5,
                    "b": torch.zeros(classes, device=device)}
    return params, state


def make_frames(n: int, model: dict, seed: int, tag: str, device):
    """``n`` labelled frames in [0, 1], (n, H, W, C) f32 and (n,) int64
    labels: each class has a smooth template (a 4 x 4 random image scaled
    up), each frame is its class's template with pixel noise. Drawn on
    ``device`` in one call per kind."""
    h, c, classes = model["image_size"], model["in_channels"], model["num_classes"]
    gen = generator(seed, tag, device)
    coarse = torch.rand((classes, c, 4, 4), generator=gen, device=device)
    templates = torch.nn.functional.interpolate(
        coarse, size=(h, h), mode="bilinear", align_corners=False)
    templates = templates.permute(0, 2, 3, 1).contiguous()
    labels = torch.randint(classes, (n,), generator=gen, device=device)
    noise = torch.randn((n, h, h, c), generator=gen, device=device)
    frames = torch.clamp(0.2 + 0.6 * templates[labels] + 0.15 * noise, 0.0, 1.0)
    return frames, labels
