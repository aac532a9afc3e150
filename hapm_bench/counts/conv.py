"""The benchmark's own count of the work each conv layer needs: operations
from the layer's real output rows and its live weights (the nonzero entries
of the run's pruned weights), bytes with every input byte read once and
every output byte written once. It never reads a kernel's tiles, blocks or
launch grid, so a roofline or an ``mfu`` read from it counts the same work
whatever kernel implements the layer. Imports nothing.

The arithmetic is the needed bound of the port's kernel table (the layer's
real rows, its live input channels and its live weights; bytes once).
"""
from __future__ import annotations


def live_counts(layers: list, weights: dict) -> list:
    """Each layer of ``layers`` (``inputs.conv_layers``) with ``live``, the
    nonzero weights, and ``live_cin``, the input channels with a nonzero
    weight, of ``weights`` {conv path: (kx, ky, cin, cout) tensor}."""
    out = []
    for layer in layers:
        w = weights[layer["path"]]
        nz = w != 0
        out.append(dict(layer, live=int(nz.sum()),
                        live_cin=int(nz.any(dim=3).any(dim=1).any(dim=0).sum())))
    return out


def macs(layer: dict, live: bool = True) -> int:
    """Multiply-adds a frame: output pixels x weights (live or all)."""
    per_pixel = layer["live"] if live else (layer["k"] ** 2 * layer["cin"] * layer["cout"])
    return layer["ho"] ** 2 * per_pixel


def head_ops(model: dict) -> int:
    """Operations of the head a frame: the average pool's adds and the
    classifier's multiply-adds."""
    h = model["image_size"]
    for si in range(1, len(model["stages"])):
        h = -(-h // 2)
    c = model["widths"][-1]
    return h * h * c + 2 * c * model["num_classes"]


def served_launch(layer: dict, batch: int) -> dict:
    """One int8 launch of the served contract at ``batch`` frames: int8
    codes in (the live input channels), int8 weights, int8 codes out, and
    three f32 epilogue rows (dequantize, bias, requantize)."""
    ops = 2 * batch * macs(layer)
    nbytes = (batch * layer["h"] ** 2 * layer["live_cin"] + layer["live"]
              + batch * layer["ho"] ** 2 * layer["cout"] + 3 * 4 * layer["cout"])
    return {"ops": ops, "bytes": nbytes}


def train_launches(layer: dict, batch: int, first: bool) -> list:
    """The f32 launches one training step needs for a layer at ``batch``:
    the forward (x, w in; y out), the input gradient (dy, w in; dx out; not
    for the first layer, whose input needs none) and the weight gradient
    (x, dy in; the live dw out)."""
    x = batch * layer["h"] ** 2 * layer["live_cin"]
    y = batch * layer["ho"] ** 2 * layer["cout"]
    dx = batch * layer["h"] ** 2 * layer["cin"]
    ops = 2 * batch * macs(layer)
    out = [{"ops": ops, "bytes": 4 * (x + layer["live"] + y)}]
    if not first:
        out.append({"ops": ops, "bytes": 4 * (y + layer["live"] + dx)})
    out.append({"ops": ops, "bytes": 4 * (x + y + layer["live"])})
    return out


def bound_s(launch: dict, peak_ops: float, peak_bytes: float) -> float:
    """The least time a launch can take: the larger of its operations over
    the peak rate and its bytes over the memory rate."""
    return max(launch["ops"] / peak_ops, launch["bytes"] / peak_bytes)


def weights_of(tree: dict, layers: list) -> dict:
    out = {}
    for layer in layers:
        node = tree
        for key in layer["path"]:
            node = node[key]
        out[layer["path"]] = node.detach()
    return out

