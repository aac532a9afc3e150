"""ResNet-50 v1.5 in the port (``models/cnn.py``: bottleneck blocks, the
7×7/2 stem and the 3×3/2 max-pool; ``configs/resnet50_v15.py``), on the CPU:

- the walker lists the 53 published convs, and ``init`` holds the published
  25 557 032 parameters;
- the default configuration is the 21-conv network as before: the same conv
  order, the same seed-0 draws, the same repr;
- at a tiny bottleneck size the streamed int8 ``apply_folded`` through the
  kernels' plain versions equals the benchmark's plain reference
  (``hapm_bench/reference/resnet_bottleneck.py``), which its int4 forward
  misses, and ``apply`` in f32 equals the reference's f32 forward;
- the max-pool on codes is pool-then-requantize bit for bit;
- every conv of ResNet-50 takes K2's implicit path at buckets 1 and 128,
  all on compacted K operands, 21 on the resident path at 128 on an H100
  and none at 1, and the bound convs count K2's K rows and tap rows.

The ``gpu`` tests run K2 int8 at each distinct ResNet-50 geometry at batch
128 against the plain version on the card, on compacted and padded K
operands, and a served chunk's launches.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels, tracing
from repro_torch.configs import resnet50_v15
from repro_torch.core import groups as TG, quant as TQ
from repro_torch.core.masks import tree_leaves, tree_map_with_path
from repro_torch.kernels import implicit_conv as IC
from repro_torch.kernels.conv_lowering import conv_out_size
from repro_torch.launch.serve_cnn import CnnServer
from repro_torch.models import cnn
from repro_torch.sparse import conv_plan as TP

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from hapm_bench.reference import resnet_bottleneck as ref  # noqa: E402

R50 = resnet50_v15.CONFIG
H100_SMS = 132
STREAMED = dict(packed=True, quantized=True, folded=True, streamed=True, dense_fallback=2.0)

# (k, stride, cin, cout, input size) of ResNet-50 v1.5's 53 convs in execution
# order (a block's 1x1, 3x3, 1x1, then its projection), written out by hand
# from He et al., Table 1
_STAGE = {  # stage: (width, input size of its first block, blocks, the first's cin)
    0: (64, 56, 3, 64), 1: (128, 56, 4, 256), 2: (256, 28, 6, 512), 3: (512, 14, 3, 1024)}
R50_CONVS = [(7, 2, 3, 64, 224)]
for _si, (_w, _h, _n, _cin) in _STAGE.items():
    _s = 1 if _si == 0 else 2
    _o = _h // _s
    R50_CONVS += [(1, 1, _cin, _w, _h), (3, _s, _w, _w, _h), (1, 1, _w, 4 * _w, _o),
                  (1, _s, _cin, 4 * _w, _h)]
    R50_CONVS += [(1, 1, 4 * _w, _w, _o), (3, 1, _w, _w, _o), (1, 1, _w, 4 * _w, _o)] * (_n - 1)

TINY = cnn.ResNetConfig(block="bottleneck", stem="imagenet", stages=(1, 1), widths=(4, 8),
                        image_size=32)
TINY_MODEL = {"block": "bottleneck", "stem": "imagenet", "stages": [1, 1], "widths": [4, 8],
              "num_classes": 10, "in_channels": 3, "image_size": 32, "bn_eps": 1e-5}


def test_the_table_is_53_convs():
    assert len(R50_CONVS) == 53
    assert sum(k * k * cin * cout * (-(-h // s)) ** 2
               for k, s, cin, cout, h in R50_CONVS) == 4_087_136_256


@pytest.mark.parametrize("i", range(53))
def test_walker_lists_the_published_convs(i):
    c = cnn.network(R50).convs[i]
    assert (c.k, c.stride, c.cin, c.cout, c.feat) == R50_CONVS[i]
    assert cnn.conv_layer_order(R50)[i] == (c.path, c.stride, c.feat)
    # ReLU after the stem and each block's 1x1 and 3x3, not after the last
    # 1x1 or the projection
    assert c.relu == (c.path[-2] in ("conv0", "conv1", "conv2"))


def test_init_holds_the_published_parameter_count():
    params, state = cnn.init(0, R50, device="meta")
    assert sum(t.numel() for t in tree_leaves(params)) == 25_557_032
    assert params["fc"]["w"].shape == (2048, 1000)
    blk = params["s1b0"]
    assert set(blk) == {"conv1", "bn1", "conv2", "bn2", "conv3", "bn3", "proj", "bnp"}
    assert "proj" not in params["s1b1"] and set(state["s1b0"]) == {"bn1", "bn2", "bn3", "bnp"}
    assert cnn.network(R50).pool and cnn.network(R50).head_channels == 2048


@pytest.mark.parametrize("name", ["default", "tiny", "r50"])
def test_the_bind_reads_the_walkers_relu(name):
    """A folded bind takes each conv's ReLU from ``network(cfg)`` where it
    has the config, and from the tree's keys where it has none: both rules
    give the same answer at every conv of the folded tree."""
    cfg = {"default": cnn.ResNetConfig(), "tiny": TINY, "r50": R50}[name]
    params, state = cnn.init(0, cfg, device="meta")
    folded = cnn.fold_batchnorm(params, state, cfg)
    relu = {c.path: c.relu for c in cnn.network(cfg).convs}
    paths = [c.path for c in cnn.network(cfg).convs]
    assert all(cnn._relu_after(folded, p) == relu[p] for p in paths)
    assert sum(relu.values()) == {"default": 10, "tiny": 5, "r50": 33}[name]


def _basic_init(seed, cfg):
    """The 21-conv network's draws as written before the walker: conv0,
    then each block's conv1, conv2 and projection, then the head."""
    gen = torch.Generator().manual_seed(seed)
    draw = lambda k, cin, cout: torch.randn((k, k, cin, cout), generator=gen) * float(
        np.sqrt(2.0 / (k * k * cin)))
    out = [(("conv0", "w"), draw(3, cfg.in_channels, cfg.widths[0]))]
    cin = cfg.widths[0]
    for si, (n_blocks, width) in enumerate(zip(cfg.stages, cfg.widths)):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            name = f"s{si}b{bi}"
            out.append(((name, "conv1", "w"), draw(3, cin, width)))
            out.append(((name, "conv2", "w"), draw(3, width, width)))
            if stride != 1 or cin != width:
                out.append(((name, "proj", "w"), draw(1, cin, width)))
            cin = width
    out.append((("fc", "w"), torch.randn((cin, cfg.num_classes), generator=gen)
                * float(np.sqrt(1.0 / cin))))
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_the_default_network_is_unchanged(seed):
    cfg = cnn.ResNetConfig()
    order = cnn.conv_layer_order(cfg)
    assert len(order) == 21
    assert [p for p, _ in _basic_init(seed, cfg)][:-1] == [p for p, _, _ in order]
    assert [(s, f) for _, s, f in order] == (
        [(1, 32)] + [(1, 32)] * 6 + [(2, 32), (1, 16), (2, 32)] + [(1, 16)] * 4
        + [(2, 16), (1, 8), (2, 16)] + [(1, 8)] * 4)
    params, state = cnn.init(seed, cfg, device="cpu")
    for path, want in _basic_init(seed, cfg):
        got = params
        for k in path:
            got = got[k]
        assert torch.equal(got, want), path
    assert list(params) == ["conv0", "bn0"] + [f"s{s}b{b}" for s in range(3) for b in range(3)] + ["fc"]
    assert list(params["s1b0"]) == ["conv1", "bn1", "conv2", "bn2", "proj", "bnp"]
    assert repr(cfg) == ("ResNetConfig(stages=(3, 3, 3), widths=(16, 32, 64), num_classes=10, "
                         "in_channels=3, image_size=32, quantized=False, bn_momentum=0.9, "
                         "bn_eps=1e-05)")
    assert "block='bottleneck', stem='imagenet'" in repr(R50)


def test_unknown_block_or_stem_is_refused():
    with pytest.raises(ValueError, match="block must be one of"):
        cnn.ResNetConfig(block="wide")
    with pytest.raises(ValueError, match="block must be one of"):
        cnn.ResNetConfig(stem="vit")


def _tiny(seed):
    """(params, calibrated state, masks, pruned params, frames) of the tiny
    bottleneck net: HAPM at half the groups (n_cu 4) by the reference, BN
    statistics the reference's f32 forward measures on 16 frames."""
    torch.manual_seed(seed)
    params, _ = cnn.init(seed, TINY, device="cpu")
    masks = ref.hapm_masks(params, TINY_MODEL, {"n_cu": 4, "group_sparsity": 0.5})
    gen = torch.Generator().manual_seed(seed + 1)
    calib = torch.rand((16, 32, 32, 3), generator=gen)
    with torch.no_grad():
        state = ref.f32_logits(params, None, TINY_MODEL, calib, masks)[1]
    pruned = tree_map_with_path(
        lambda p, t: t * masks[p] if p in masks else t, params)
    frames = torch.rand((6, 32, 32, 3), generator=gen)
    return params, state, masks, pruned, frames


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_streamed_int8_equals_the_reference(seed):
    torch.set_num_threads(2)
    params, state, masks, pruned, frames = _tiny(seed)
    folded = cnn.fold_batchnorm(pruned, state, TINY)
    exec_ = cnn.bind_execution(folded, TINY, spec=cnn.ExecSpec(**STREAMED, n_cu=4),
                               device="cpu")
    assert all(fn is not None and fn.implicit for fn in exec_.table.values())
    assert len(exec_.table) == len(cnn.network(TINY).convs) == 9
    got = cnn.apply_folded(folded, frames, TINY, sparse=exec_).double()
    with torch.no_grad():
        want = ref.served_logits(params, state, masks, TINY_MODEL, frames)
        low = ref.served_logits(params, state, masks, TINY_MODEL, frames, bits=4)
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * top
    assert float((low - want).abs().max()) > 1e-2 * top


@pytest.mark.parametrize("seed", [0, 5])
def test_f32_apply_equals_the_reference(seed):
    torch.set_num_threads(2)
    params, state, masks, pruned, frames = _tiny(seed)
    got, _ = cnn.apply(pruned, state, frames, TINY)
    with torch.no_grad():
        want, _ = ref.f32_logits(params, state, TINY_MODEL, frames, masks)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("size", [(112, 112), (9, 9), (8, 10), (1, 3)])
def test_max_pool_on_codes_is_pool_then_requantize(size):
    gen = torch.Generator().manual_seed(sum(size))
    y = torch.relu(torch.randn((3, *size, 5), generator=gen) * 4)
    y[:, 0, :] = 9.0                                    # the borders saturate
    y[:, :, -1] = torch.rand((3, size[0], 5), generator=gen)
    codes = TQ.round_sat(y * 16.0, 127).to(torch.int8)
    got = cnn._max_pool(codes)
    want = TQ.round_sat(cnn._max_pool(y) * 16.0, 127).to(torch.int8)
    assert got.dtype == torch.int8 and got.shape == (3, ref.pool_out(size[0]),
                                                      ref.pool_out(size[1]), 5)
    assert torch.equal(got, want)
    assert torch.equal(got.double(), ref.max_pool(codes.double()))


def _launch(c, batch, group_mask=None):
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((c.k, c.k, c.cin, c.cout), 12),
                                 packed=True)
    gm = np.ones(layout.spec.num_groups, np.float32) if group_mask is None else group_mask
    plan = layout.plan(gm)
    geo = layout.implicit_geometry()
    mb = IC.choose_m_block(c.out, c.out)
    rows, cols = IC.window_shape(mb, c.k, c.k, c.stride)
    return layout, plan, geo, mb, rows, cols


def _k_units(layout, plan, geo):
    """128-row units of the widest column on compacted K operands."""
    k, _, cin, _ = layout.spec.shape
    taps = IC.column_tap_rows(plan.idx, plan.cnt, kx=k, ky=k, cin=cin, cpk=geo["cpk"])
    return int(-(-taps.max() // 128))


@pytest.mark.parametrize("i", range(53))
def test_every_conv_takes_the_implicit_path(i):
    """The bound conv's own per-call test (``make_sparse_conv._run``) holds
    at every bucket: the M-block is whole output rows or row segments of
    one image, so it does not depend on the batch."""
    c = cnn.network(R50).convs[i]
    layout, plan, geo, mb, rows, cols = _launch(c, 1)
    assert mb is not None and mb.bm <= IC.KERNEL_MAX_BM
    assert 2 * rows * cols * geo["cpk"] <= IC.SLAB_VMEM_BUDGET
    assert IC.window_fits_card(rows, cols, geo["cpk"])
    assert layout.block[0] <= 128 and plan.idx.shape[1] <= 128


def test_twenty_one_convs_are_resident_at_batch_128():
    """On an H100 at bucket 128, every group live (the most units a column
    holds), on compacted K operands: the stem, stage 1, and stage 2's 1x1s
    and stage 3's first (their columns of 256 or 512 input channels now 2
    or 4 units) and stage 2's projection (at stride 1 on every second
    pixel); stages 3 and 4 have too few M-blocks otherwise, stage 2's 3x3s
    (9 units) columns too large. At bucket 1 none is. The three strided
    projections run compacted at stride 1 on every second pixel (at stride
    2, two of them have windows of all channels no block holds)."""
    resident, resident_at_1, strided = [], [], []
    for c in cnn.network(R50).convs:
        layout, plan, geo, mb, rows, cols = _launch(c, 128)
        cp = layout.tiles[0] * geo["cpk"]
        name = "/".join(c.path[:-1])
        if c.k == 1 and c.stride > 1:
            rows, cols = IC.window_shape(mb, 1, 1, 1)
            strided.append(name)
        assert IC.takes_compact_path(rows, cols, cp)
        args = (mb.bm, rows * cols * IC.window_pitch(cp), H100_SMS,
                _k_units(layout, plan, geo))
        if IC.takes_resident_path(128 * mb.bpi, *args):
            resident.append(name)
        if IC.takes_resident_path(mb.bpi, *args):
            resident_at_1.append(name)
    assert resident == ["conv0", "s0b0/conv1", "s0b0/conv2", "s0b0/conv3", "s0b0/proj",
                        "s0b1/conv1", "s0b1/conv2", "s0b1/conv3", "s0b2/conv1", "s0b2/conv2",
                        "s0b2/conv3", "s1b0/conv1", "s1b0/conv3", "s1b0/proj", "s1b1/conv1",
                        "s1b1/conv3", "s1b2/conv1", "s1b2/conv3", "s1b3/conv1", "s1b3/conv3", "s2b0/conv1"]
    assert resident_at_1 == []
    assert strided == ["s1b0/proj", "s2b0/proj", "s3b0/proj"]


@pytest.mark.parametrize("k,cin,live", [(7, 3, None), (1, 64, None), (3, 20, "half")])
def test_bound_conv_counts_k_rows_and_tap_rows(k, cin, live):
    """A bound int8 conv runs on compacted K operands: it counts, per
    M-block, each column's tap rows rounded up to 32 as K rows; the tap
    rows are those of the padded tiles it no longer multiplies."""
    rs = np.random.RandomState(k + cin)
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, 24), 12), packed=True)
    gm = np.ones(layout.spec.num_groups, np.float32)
    if live == "half":
        gm = (rs.rand(layout.spec.num_groups) < 0.5).astype(np.float32)
    w = torch.from_numpy(rs.randn(k, k, cin, 24).astype(np.float32))
    conv = TP.make_sparse_conv(layout, gm, weight=w, quant=TQ.QuantSpec.calibrate(w),
                               device="cpu")
    x = torch.from_numpy(np.maximum(rs.randn(2, 14, 14, cin), 0).astype(np.float32))
    before = {n: tracing.counter(n) for n in (IC.K_ROWS, IC.TAP_ROWS)}
    conv(x, stride=2)
    mb = IC.choose_m_block(7, 7)
    geo, plan = layout.implicit_geometry(), conv.plan
    cols = [[int(t) for t in plan.idx[j, :plan.cnt[j]]] for j in range(plan.idx.shape[0])]
    col_taps = [sum(min(geo["cpk"], cin - t * geo["cpk"]) for t in ts) * k * k for ts in cols]
    assert conv.compact is not None
    assert conv.compact.rows.tolist() == [-(-n // 32) * 32 for n in col_taps]
    k_rows = tracing.counter(IC.K_ROWS) - before[IC.K_ROWS]
    assert k_rows == 2 * mb.bpi * sum(-(-n // 32) * 32 for n in col_taps)
    assert tracing.counter(IC.TAP_ROWS) - before[IC.TAP_ROWS] == 2 * mb.bpi * sum(col_taps)
    assert sum(col_taps) < sum(len(ts) for ts in cols) * 128
    assert sum(col_taps) > 0.8 * k_rows / (2 * mb.bpi)


def _r50_geometries():
    seen = []
    for c in cnn.network(R50).convs:
        if (c.k, c.stride, c.cin, c.cout, c.feat) not in seen:
            seen.append((c.k, c.stride, c.cin, c.cout, c.feat))
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("operands", ["compact", "padded"])
@pytest.mark.parametrize("geom", _r50_geometries(), ids=lambda g: "x".join(map(str, g)))
def test_k2_int8_at_resnet50_geometries_on_the_card(geom, operands):
    """K2 int8, streamed, at batch 128 and half the groups live, on
    compacted K operands where the rule takes them and on the padded tiles:
    bit-equal to the plain version on the card, one launch counted, the body
    the rule gives on compacted operands and the per-block body on padded
    ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    k, stride, cin, cout, h = geom
    rs = np.random.RandomState(sum(geom))
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), 12), packed=True)
    gm = (rs.rand(layout.spec.num_groups) < 0.5).astype(np.float32)
    w = torch.from_numpy((rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))
                          ).astype(np.float32)).to(dev)
    q = TQ.QuantSpec.calibrate(w)
    wp = layout.pack_weight(q.weight_codes(layout.spec.expand(gm).to(dev) * w)).contiguous()
    x = torch.relu(torch.randn((128, h, h, cin), device=dev,
                               generator=torch.Generator(dev).manual_seed(sum(geom))))
    ho = conv_out_size(h, k, stride, "SAME")
    mb = IC.choose_m_block(ho, ho)
    geo = layout.implicit_geometry()
    xp = IC.pad_input(q.act_codes(x), k, k, stride, "SAME", mb,
                      layout.tiles[0] * geo["cpk"]).contiguous()
    plan = layout.plan(gm)
    idx, cnt = (torch.from_numpy(a).to(dev) for a in (plan.idx, plan.cnt))
    rows_ = (layout.pack_bias(torch.from_numpy(rs.randn(cout).astype(np.float32)).to(dev)),
             layout.pack_bias(q.dequant_row(cout, dev)),
             layout.pack_bias(torch.full((cout,), 16.0, device=dev)))
    kw = dict(kx=k, ky=k, stride=stride, mb=mb, block=layout.block, cpk=geo["cpk"],
              slot=geo["slot"], relu=True)
    kg = dict(cpk=geo["cpk"], slot=geo["slot"], block=layout.block)
    rows, cols = IC.window_shape(mb, k, k, stride)
    ck, xk, kk = None, xp, kw
    if operands == "compact":
        ck = IC.compact_k(wp, plan.idx, plan.cnt, kx=k, ky=k, cin=cin, **kg)
        if k == 1 and stride > 1:
            # a strided projection runs as the bind runs it, at stride 1 on
            # every second pixel; at stride 2 the two wide ones are refused
            if not IC.takes_compact_path(rows, cols, xp.shape[3]):
                assert (k, stride, cin) in [(1, 2, 512), (1, 2, 1024)]
                with pytest.raises(ValueError, match="compacted K operands need it"):
                    IC.implicit_block_sparse_conv(xp, wp, idx, cnt, *rows_, **kw, compact=ck)
            xk = IC.pad_input(q.act_codes(x)[:, ::2, ::2], 1, 1, 1, "SAME", mb,
                              xp.shape[3]).contiguous()
            kk = {**kw, "stride": 1}
            rows, cols = IC.window_shape(mb, 1, 1, 1)
        assert IC.takes_compact_path(rows, cols, xp.shape[3])
    resident = ck is not None and IC.takes_resident_path(
        128 * mb.bpi, mb.bm, rows * cols * IC.window_pitch(xp.shape[3]),
        torch.cuda.get_device_properties(dev).multi_processor_count, ck.k_units)
    before = (kernels.launch_counts()["implicit_block_sparse_conv"],
              tracing.counter(IC.RESIDENT), tracing.counter(IC.COMPACT))
    got = IC.implicit_block_sparse_conv(xk, wp, idx, cnt, *rows_, **kk, compact=ck)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["implicit_block_sparse_conv"] == before[0] + 1
    assert tracing.counter(IC.RESIDENT) == before[1] + int(resident)
    assert tracing.counter(IC.COMPACT) == before[2] + int(ck is not None)
    want = IC.implicit_block_sparse_conv_plain(xp, wp, idx, cnt, *rows_, **kw)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    if ck is not None:
        assert torch.equal(IC.implicit_block_sparse_conv_plain(xk, wp, idx, cnt, *rows_, **kk,
                                                               compact=ck), want)


@pytest.mark.gpu
def test_a_served_resnet50_chunk_launches_k2_once_a_conv():
    """``CnnServer`` answers 224×224×3 frames of ResNet-50 on K2 int8: 53
    launches a chunk, none of K1, no dense layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    params, state = cnn.init(0, R50, device="cuda")
    server = CnnServer(params, state, R50, spec=cnn.ExecSpec(**STREAMED, n_cu=12),
                       buckets=(1, 4), device="cuda")
    server.warmup()
    exec_ = server._bind()
    assert all(fn is not None and fn.implicit for fn in exec_.table.values())
    frames = torch.rand((5, 224, 224, 3), device="cuda")
    before = kernels.launch_counts()
    y = server.infer(frames)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert y.shape == (5, 1000) and bool(torch.isfinite(y).all())
    assert after["implicit_block_sparse_conv"] - before["implicit_block_sparse_conv"] == 2 * 53
    assert after["block_sparse_matmul"] == before["block_sparse_matmul"]
