"""The path rule of K2's int8 instance, on the CPU.

``implicit_conv.takes_resident_path`` chooses, from the launch's geometry
alone, between the resident body (weight-stationary blocks, as many as the
card holds at once, each converting its column's weight units once and
walking M-blocks) and the per-block body (one block per M-block and column).
The resident body runs on compacted K operands only (each column's tap rows
in 128-row units, ``implicit_conv.compact_k``), so the rule counts the
widest column's compacted units; every launch on padded operands takes the
per-block body. The rule lives in Python alone: the launcher takes its
choice and refuses only a resident launch on padded operands or past a
block's shared memory, which the GPU tests hold on the card. Here, on an
H100's 132 SMs:

- every conv of the benchmark's configurations of the 21-conv network
  (``hapm_bench/configs``), in both layouts, takes the resident path at
  batch 2048, with every tile of its column live, the most units a column
  can hold: the rule only gets easier with fewer;
- batch 1, a window too large to hold twice with all its channels, and
  a column with more compacted units than a block holds take the per-block
  path; a wide 1x1's column of two units fits;
- the rule's shared-memory count fits the card where it says resident, and
  grows by a unit's 17 KB and its 128 window offsets a unit; each resident
  block walks at least two M-blocks;
- the resident window's pixels are padded to an odd number of 16-byte groups;
- a window of all channels too large for a block beside the weight ring
  keeps the padded tiles.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import groups as TG
from repro_torch.kernels import implicit_conv as IC
from repro_torch.kernels.conv_lowering import conv_out_size
from repro_torch.sparse import conv_plan as TP

H100_SMS = 132
# the configurations of the 21-conv network, which the benchmark serves at
# batch 2048 (ResNet-50's, served at 128, is held in test_torch_cnn_bottleneck.py)
CONFIGS = sorted(
    p for p in (Path(__file__).resolve().parents[1] / "hapm_bench" / "configs").glob("*.json")
    if json.loads(p.read_text())["model"].get("block", "basic") == "basic")


def _convs(model: dict):
    """(k, cin, cout, stride, h) of every conv of the ResNet, in order."""
    feat, cin = model["image_size"], model["in_channels"]
    out = [(3, cin, model["widths"][0], 1, feat)]
    cin = model["widths"][0]
    for si, n_blocks in enumerate(model["stages"]):
        width = model["widths"][si]
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            out.append((3, cin, width, stride, feat))
            o = -(-feat // stride)
            out.append((3, width, width, 1, o))
            if stride != 1 or cin != width:
                out.append((1, cin, width, stride, feat))
            feat, cin = o, width
    return out


def _launch(k, cin, cout, stride, h, batch, n_cu=12, packed=True):
    """The rule's arguments for one conv's K2 launch on compacted K operands
    (bm 'auto', every group live), without the SM count: (M-blocks, bm,
    window bytes, the widest column's 128-row units)."""
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), n_cu), packed=packed)
    plan = layout.plan(np.ones(layout.spec.num_groups, np.float32))
    geo = layout.implicit_geometry()
    ho = conv_out_size(h, k, stride, "SAME")
    mb = IC.choose_m_block(ho, ho)
    rows, cols = IC.window_shape(mb, k, k, stride)
    window = rows * cols * IC.window_pitch(layout.tiles[0] * geo["cpk"])
    return (batch * mb.bpi, mb.bm, window, _k_units(k, cin, cout, n_cu, packed))


def _k_units(k, cin, cout, n_cu=12, packed=True):
    """128-row units of the widest column on compacted K operands, every
    group live."""
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), n_cu), packed=packed)
    plan = layout.plan(np.ones(layout.spec.num_groups, np.float32))
    geo = layout.implicit_geometry()
    ck = IC.compact_k(torch.zeros(layout.k_packed, layout.n_packed, dtype=torch.int8), plan.idx,
                      plan.cnt, kx=k, ky=k, cin=cin, cpk=geo["cpk"], slot=geo["slot"],
                      block=layout.block)
    # compaction only drops rows: never more units than the padded tiles
    assert ck.k_units <= -(-int(plan.cnt.max()) * layout.block[0] // 128)
    return ck.k_units


def _resident(n_blocks, bm, window, units):
    return IC.takes_resident_path(n_blocks, bm, window, H100_SMS, units)


SERVED = [(path.stem, conv) for path in CONFIGS
          for conv in _convs(json.loads(path.read_text())["model"])]


def test_the_served_configurations_are_found():
    assert len(CONFIGS) == 2 and len(SERVED) == 42


@pytest.mark.parametrize("layout", ["bound", "other"])
@pytest.mark.parametrize("config,conv", SERVED, ids=[f"{c}-{i % 21}" for i, (c, _) in
                                                     enumerate(SERVED)])
def test_served_convs_at_batch_2048_take_the_resident_path(config, conv, layout):
    """The served convs at batch 2048 on compacted K operands, in the layout
    their configuration binds and in the other one: resident, within the
    card, and on compacted operands at all (the window of all channels fits
    beside the per-block body's ring); at batch 1, per block."""
    spec = json.loads(next(p for p in CONFIGS if p.stem == config).read_text())["exec_spec"]
    packed = spec["packed"] == (layout == "bound")
    n_blocks, bm, window, units = _launch(*conv, 2048, n_cu=spec["n_cu"], packed=packed)
    assert _resident(n_blocks, bm, window, units)
    assert IC.resident_smem_bytes(bm, window, units) <= IC.CARD_SHARED_BYTES
    assert not _resident(n_blocks // 2048, bm, window, units)
    k, cin, cout, stride, h = conv
    mb = IC.choose_m_block(*(conv_out_size(h, k, stride, "SAME"),) * 2)
    cpk = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), spec["n_cu"]),
                              packed=packed).implicit_geometry()["cpk"]
    assert IC.takes_compact_path(*IC.window_shape(mb, k, k, stride), -(-cin // cpk) * cpk)


@pytest.mark.parametrize("conv", sorted(set(c for _, c in SERVED)),
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("packed", [False, True])
def test_batch_one_takes_the_per_block_path(conv, packed):
    assert not _resident(*_launch(*conv, 1, packed=packed))
    # the served batch takes the resident path in both layouts
    assert _resident(*_launch(*conv, 2048, packed=packed))


def test_a_window_too_large_to_hold_takes_the_per_block_path():
    # 3x3, stride 7, 40 channels at 77x77: one M-block's window of all
    # channels is 213 KB packed, two of them do not fit
    launch = _launch(3, 40, 8, 7, 77, 4096, n_cu=4)
    assert 2 * launch[2] > IC.CARD_SHARED_BYTES
    assert not _resident(*launch)


def test_a_column_too_large_to_hold_takes_the_per_block_path():
    # 3x3, 256 input channels packed: 2304 tap rows, 18 compacted units of
    # 17 KB in one column
    launch = _launch(3, 256, 64, 1, 8, 4096)
    assert launch[3] == 18
    assert IC.resident_smem_bytes(*launch[1:]) > IC.CARD_SHARED_BYTES
    assert not _resident(*launch)


def test_a_wide_1x1_column_fits():
    # 1x1, 256 input channels packed: 16 K-tiles of 128 rows, 256 tap rows
    # compacted into 2 units, which a block holds
    launch = _launch(1, 256, 64, 1, 56, 128)
    assert launch[3] == 2
    assert _resident(*launch)


@pytest.mark.parametrize("units,bm,per_sm", [(1, 128, 2), (2, 128, 2), (4, 32, 2), (5, 16, 2),
                                             (6, 128, 1), (8, 64, 1)])
def test_each_resident_block_walks_two_m_blocks(units, bm, per_sm):
    """At the threshold: resident from two M-blocks for each block the card
    holds at once (two an SM where two fit, one where one does). A unit
    adds its 17 KB and 128 window offsets to the count (and its n8 mask, in
    16-byte rows)."""
    window = 10 * 680
    need = IC.resident_smem_bytes(bm, window, units)
    grown = need - IC.resident_smem_bytes(bm, window, units - 1)
    assert grown == IC._UNIT_BYTES + 128 * 4 + 16 * (units % 4 == 1)
    assert min(2, IC.SM_SHARED_BYTES // (need + 1024)) == per_sm
    edge = 2 * H100_SMS * per_sm
    assert _resident(edge, bm, window, units)
    assert not _resident(edge - 1, bm, window, units)


@pytest.mark.parametrize("cp,pitch", [(3, 3), (8, 8), (16, 16), (24, 48), (32, 48), (40, 48),
                                      (64, 80), (128, 144)])
def test_window_pixels_pad_to_an_odd_number_of_16_byte_groups(cp, pitch):
    assert IC.window_pitch(cp) == pitch


def test_a_window_too_large_beside_the_ring_keeps_the_padded_tiles():
    # the compacted per-block body holds two packed units, a raw ring of
    # three units with their table entries and two units' offsets (86.5 KB)
    # beside its window of all channels
    room = IC.CARD_SHARED_BYTES - IC._COMPACT_BESIDE_WINDOW_BYTES - IC._IMMA_STATIC_BYTES
    assert IC._COMPACT_BESIDE_WINDOW_BYTES == 86528
    assert IC.takes_compact_path(1, room // 64, 64)
    assert not IC.takes_compact_path(1, room // 64 + 1, 64)
