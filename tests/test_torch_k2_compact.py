"""K2 int8 on compacted K operands (``kernels/implicit_conv.py``:
``compact_k``, and the plain version on them), on the CPU.

A packed K-tile gives each input channel a slot of ``ceil8(kx·ky)`` rows;
the bind lists, per output column, only the rows of its live tiles that hold
a channel's tap and gathers them into a dense weight beside a table of each
row's (channel, dy, dx). Here:

- the plain version on the compacted operands is bit-equal to the plain
  version on the padded tiles and to the JAX package's int8 conv oracle, at
  1×1, 3×3 and 7×7, stride 1 and 2, ``cin`` no multiple of the tile's
  channels, a column with no live tile, half the groups live, columns whose
  rows end inside a 32-row step, and every distinct ResNet-50 v1.5 geometry
  at a small spatial size;
- the table lists each column's live tiles in the dispatch table's order,
  their channels below ``cin`` and the taps row-major, and the weight holds
  exactly the packed weight's rows it names;
- the plan, the tile mask, the implicit index table, the fingerprint and
  the byte count stay the JAX package's;
- a bind with ``activation_dsb`` keeps the padded tiles and counts them; a
  strided 1x1 runs compacted on every s-th pixel at stride 1, also where
  its strided window of all channels no block holds; any other conv whose
  window no block holds runs on the padded tiles and counts them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.core import groups as JG
from repro.kernels import ref as JR
from repro.sparse import conv_plan as JP
from repro_torch import tracing
from repro_torch.configs import resnet50_v15
from repro_torch.core import groups as TG, quant as TQ
from repro_torch.kernels import implicit_conv as IC
from repro_torch.kernels.conv_lowering import conv_out_size
from repro_torch.models import cnn
from repro_torch.sparse import conv_plan as TP

CASES = [  # (k, stride, cin, cout, h, n_cu, packed, live)
    (1, 1, 40, 24, 6, 12, True, "half"),     # cin 40 over tiles of 16 channels: 16 + 16 + 8
    (1, 2, 20, 24, 8, 12, True, "all"),      # 20 rows a column: ends inside a 32-row step
    (3, 1, 5, 12, 6, 4, True, "all"),        # 45 rows a column
    (3, 2, 20, 16, 8, 4, True, "half"),      # 3x3 stride 2, the last tile 4 of 8 channels
    (7, 2, 3, 16, 16, 12, True, "all"),      # the stem: 147 of 2 tiles' 256 rows
    (7, 1, 6, 8, 8, 4, True, "half"),        # 7x7 stride 1
    (3, 1, 8, 16, 6, 4, False, "half"),      # one channel a tile (the unpacked layout)
    (1, 1, 48, 48, 4, 12, True, "dead_column"),  # output column 0 has no live tile
    (3, 1, 16, 16, 6, 4, False, "dead_column"),
]


def _r50_cases():
    seen = []
    for c in cnn.network(resnet50_v15.CONFIG).convs:
        g = (c.k, c.stride, c.cin, c.cout, 16 if c.k == 7 else 4, 12, True, "half")
        if g not in seen:
            seen.append(g)
    return seen


def _operands(case, seed=0):
    k, stride, cin, cout, h, n_cu, packed, live = case
    rs = np.random.RandomState(seed + sum(case[:6]))
    shape = (k, k, cin, cout)
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups(shape, n_cu), packed=packed)
    gm = np.ones(layout.spec.num_groups, np.float32)
    if live == "half":
        gm = (rs.rand(layout.spec.num_groups) < 0.5).astype(np.float32)
    elif live == "dead_column":
        fpn = layout.block[1] // n_cu if packed else 1   # f_blocks a column
        gm.reshape(cin, -1)[:, :fpn] = 0
    w = torch.from_numpy((rs.randn(*shape) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32))
    q = TQ.QuantSpec.calibrate(w)
    w_codes = q.weight_codes(layout.spec.expand(gm) * w)
    wp = layout.pack_weight(w_codes)
    x = torch.from_numpy(np.maximum(rs.randn(2, h, h, cin), 0).astype(np.float32))
    ho = conv_out_size(h, k, stride, "SAME")
    mb = IC.choose_m_block(ho, ho)
    geo = layout.implicit_geometry()
    codes = q.act_codes(x)
    xp = IC.pad_input(codes, k, k, stride, "SAME", mb, layout.tiles[0] * geo["cpk"])
    plan = layout.plan(gm)
    ck = IC.compact_k(wp, plan.idx, plan.cnt, kx=k, ky=k, cin=cin, cpk=geo["cpk"],
                      slot=geo["slot"], block=layout.block)
    kw = dict(kx=k, ky=k, stride=stride, mb=mb, block=layout.block, cpk=geo["cpk"],
              slot=geo["slot"])
    return layout, gm, plan, wp, w_codes, codes, xp, ck, kw, ho


def _unpack(layout, out2d, mb, ho):
    o = IC.crop_output(out2d, mb, 2, ho, ho)
    return layout.unpack_output(o.reshape(2 * ho * ho, -1), (2, ho, ho))


@pytest.mark.parametrize("case", CASES + _r50_cases(), ids=lambda c: "x".join(map(str, c)))
def test_compacted_equals_padded_and_jax(case):
    layout, gm, plan, wp, w_codes, codes, xp, ck, kw, ho = _operands(case)
    idx, cnt = torch.from_numpy(plan.idx), torch.from_numpy(plan.cnt)
    n = layout.n_packed
    ones = torch.ones(n)
    # int32 sums through a unit scale row: the f32 outputs are the sums
    got = IC.implicit_block_sparse_conv(xp, wp, idx, cnt, scale=ones, compact=ck, **kw)
    pad = IC.implicit_block_sparse_conv(xp, wp, idx, cnt, scale=ones, **kw)
    assert torch.equal(got, pad)
    jax = JR.int8_conv_ref(jnp.asarray(codes.numpy()), jnp.asarray(w_codes.numpy()), 1.0,
                           kw["stride"], "SAME")
    np.testing.assert_array_equal(_unpack(layout, got, kw["mb"], ho).numpy(), np.asarray(jax))
    # streamed: requantized codes with bias and ReLU, bit-equal
    rs = np.random.RandomState(1)
    rows = (layout.pack_bias(torch.from_numpy(rs.randn(case[3]).astype(np.float32))),
            layout.pack_bias(torch.full((case[3],), 2.0 ** -9)),
            layout.pack_bias(torch.full((case[3],), 16.0)))
    got = IC.implicit_block_sparse_conv(xp, wp, idx, cnt, *rows, relu=True, compact=ck, **kw)
    pad = IC.implicit_block_sparse_conv(xp, wp, idx, cnt, *rows, relu=True, **kw)
    assert got.dtype == torch.int8 and torch.equal(got, pad)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_the_table_lists_each_columns_tap_rows(case):
    layout, gm, plan, wp, w_codes, codes, xp, ck, kw, ho = _operands(case)
    k, _, cin = case[:3]
    cpk, slot, (bk, bn) = kw["cpk"], kw["slot"], layout.block
    assert ck.w.shape[0] == 128 * ck.k_units and ck.w.dtype == torch.int8
    for j in range(plan.idx.shape[0]):
        want_k, want_e = [], []
        for t in plan.idx[j, :plan.cnt[j]]:
            for c in range(min(cpk, cin - int(t) * cpk)):
                for dy in range(k):
                    for dx in range(k):
                        want_k.append(int(t) * bk + c * slot + dy * k + dx)
                        want_e.append((int(t) * cpk + c) << 16 | dy << 8 | dx)
        r = len(want_k)
        assert int(ck.rows[j]) == -(-r // 32) * 32
        assert ck.tab[j, :r].tolist() == want_e and bool((ck.tab[j, r:] == -1).all())
        lanes = slice(j * bn, (j + 1) * bn)
        assert torch.equal(ck.w[:r, lanes], wp[want_k, lanes])
        assert not ck.w[r:, lanes].any()
    if case[-1] == "dead_column":
        assert int(plan.cnt[0]) == 0 and int(ck.rows[0]) == 0
    if case[-1] == "all" and case[1] == 2 and case[0] == 1:
        assert ck.rows.tolist() == [32]           # 20 taps a column end inside the step


@pytest.mark.parametrize("case", CASES[:5], ids=lambda c: "x".join(map(str, c)))
def test_plans_tables_and_accounting_stay_the_jax_packages(case):
    """The bind compacts only K2's own operands: the bound conv's plan, the
    layout's tile mask, implicit index table and fingerprint, and the byte
    count are the JAX package's."""
    k, stride, cin, cout, h, n_cu, packed, live = case
    layout, gm, plan, wp, w_codes, codes, xp, ck, kw, ho = _operands(case)
    jl = JP.conv_gemm_layout(JG.fpga_conv_groups((k, k, cin, cout), n_cu), packed=packed)
    w = torch.zeros(k, k, cin, cout)
    conv = TP.make_sparse_conv(layout, gm, weight=w, quant=TQ.QuantSpec(), device="cpu")
    assert conv.compact is not None
    jp = jl.plan(gm)
    np.testing.assert_array_equal(conv.plan.idx, np.asarray(jp.idx))
    np.testing.assert_array_equal(conv.plan.cnt, np.asarray(jp.cnt))
    np.testing.assert_array_equal(layout.tile_mask(gm), np.asarray(jl.tile_mask(gm)))
    for a, b in zip(layout.implicit_index_table(gm), jl.implicit_index_table(gm)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert TP.mask_fingerprint({("c",): gm}) == JP.mask_fingerprint({("c",): gm})
    kb = dict(implicit=True, operand_bytes=1, out_bytes=1)
    assert (TP.conv_hbm_bytes(layout, gm, 2, h, h, stride, **kb)
            == JP.conv_hbm_bytes(jl, gm, 2, h, h, stride, **kb))


def _counts(conv, x, stride):
    before = {n: tracing.counter(n) for n in (IC.K_ROWS, IC.TAP_ROWS)}
    y = conv(x, stride=stride)
    return y, {n: tracing.counter(n) - before[n] for n in before}


@pytest.mark.parametrize("case", CASES[:4], ids=lambda c: "x".join(map(str, c)))
def test_activation_dsb_binds_keep_the_padded_tiles(case):
    """A bind with activation_dsb (skips decided per K-tile window) has no
    compacted operands and counts every live tile's rows; the same bind
    without it counts the compacted rows, the same taps and the same codes."""
    k, stride, cin, cout, h = case[:5]
    layout, gm, plan, *_ = _operands(case)
    rs = np.random.RandomState(3)
    w = torch.from_numpy(rs.randn(k, k, cin, cout).astype(np.float32))
    x = torch.from_numpy(np.maximum(rs.randn(2, h, h, cin), 0).astype(np.float32))
    bind = lambda dsb: TP.make_sparse_conv(layout, gm, weight=w, quant=TQ.QuantSpec.calibrate(w),
                                           out_quant=TQ.QuantSpec(), activation_dsb=dsb,
                                           device="cpu")
    dsb, plain = bind(True), bind(False)
    assert dsb.compact is None and plain.compact is not None
    y_dsb, c_dsb = _counts(dsb, x, stride)
    y, c = _counts(plain, x, stride)
    assert torch.equal(y, y_dsb)
    ho = conv_out_size(h, k, stride, "SAME")
    n_mb = 2 * IC.choose_m_block(ho, ho).bpi
    assert c_dsb[IC.K_ROWS] == n_mb * int(plan.cnt.sum()) * layout.block[0]
    assert c[IC.K_ROWS] == n_mb * int(plain.compact.rows.sum()) < c_dsb[IC.K_ROWS]
    assert c[IC.TAP_ROWS] == c_dsb[IC.TAP_ROWS]
    _, stats = dsb.skip_counts(x, stride=stride)
    _, stats_plain = plain.skip_counts(x, stride=stride)
    assert stats_plain == {"skipped_steps": 0, "live_steps": stats["live_steps"]}


@pytest.mark.parametrize("cin,h,stride", [(512, 28, 2), (1024, 14, 2), (1024, 21, 3)])
def test_a_strided_1x1_too_wide_to_hold_runs_on_its_tapped_pixels(cin, h, stride):
    """1x1 at stride 2, 512 channels at 28x28 and 1024 at 14x14 (ResNet-50's
    s2b0/proj and s3b0/proj), and at stride 3: the strided window of all
    channels does not fit a block beside the weight ring; the stride-1
    window of every s-th pixel does, so the call runs there on compacted
    operands, counts their rows, and answers the padded tiles' codes."""
    k, cout = 1, 24
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), 12), packed=True)
    gm = (np.random.RandomState(cin).rand(layout.spec.num_groups) < 0.5).astype(np.float32)
    ho = conv_out_size(h, k, stride, "SAME")
    mb = IC.choose_m_block(ho, ho)
    assert IC.takes_compact_path(*IC.window_shape(mb, 1, 1, 1), cin)
    assert not IC.takes_compact_path(*IC.window_shape(mb, k, k, stride), cin)
    rs = np.random.RandomState(4)
    w = torch.from_numpy(rs.randn(k, k, cin, cout).astype(np.float32))
    bind = lambda dsb: TP.make_sparse_conv(layout, gm, weight=w, quant=TQ.QuantSpec.calibrate(w),
                                           out_quant=TQ.QuantSpec(), activation_dsb=dsb,
                                           device="cpu")
    conv, padded = bind(False), bind(True)
    x = torch.from_numpy(np.maximum(rs.randn(1, h, h, cin), 0).astype(np.float32))
    y, c = _counts(conv, x, stride)
    y_pad, c_pad = _counts(padded, x, stride)
    assert torch.equal(y, y_pad)
    assert c[IC.K_ROWS] == mb.bpi * int(conv.compact.rows.sum()) < c_pad[IC.K_ROWS]
    assert c[IC.TAP_ROWS] == c_pad[IC.TAP_ROWS]


def test_a_window_no_block_holds_runs_on_the_padded_tiles():
    """3x3 at stride 7, 40 channels at 77x77: one M-block's window of all
    channels (213 KB) does not fit a block beside the weight ring, so the
    call runs on the padded tiles (the kernel's slow path), counts their
    rows, and answers the same codes as the padded bind."""
    k, stride, cin, cout, h = 3, 7, 40, 8, 77
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), 4), packed=True)
    gm = np.ones(layout.spec.num_groups, np.float32)
    ho = conv_out_size(h, k, stride, "SAME")
    mb = IC.choose_m_block(ho, ho)
    cp = layout.tiles[0] * layout.implicit_geometry()["cpk"]
    assert not IC.takes_compact_path(*IC.window_shape(mb, k, k, stride), cp)
    rs = np.random.RandomState(5)
    w = torch.from_numpy(rs.randn(k, k, cin, cout).astype(np.float32))
    conv = TP.make_sparse_conv(layout, gm, weight=w, quant=TQ.QuantSpec.calibrate(w),
                               out_quant=TQ.QuantSpec(), device="cpu")
    padded = TP.make_sparse_conv(layout, gm, weight=w, quant=TQ.QuantSpec.calibrate(w),
                                 out_quant=TQ.QuantSpec(), activation_dsb=True, device="cpu")
    x = torch.from_numpy(np.maximum(rs.randn(1, h, h, cin), 0).astype(np.float32))
    y, c = _counts(conv, x, stride)
    assert conv.compact is not None
    assert c[IC.K_ROWS] == mb.bpi * int(conv.plan.cnt.sum()) * layout.block[0]
    assert torch.equal(y, padded(x, stride=stride))


def test_compacted_operands_are_refused_off_their_contract():
    case = CASES[0]
    layout, gm, plan, wp, w_codes, codes, xp, ck, kw, ho = _operands(case)
    idx, cnt = torch.from_numpy(plan.idx), torch.from_numpy(plan.cnt)
    with pytest.raises(TypeError, match="without activation_dsb"):
        IC.implicit_block_sparse_conv(xp, wp, idx, cnt, compact=ck, activation_dsb=True, **kw)
    with pytest.raises(TypeError, match="without activation_dsb"):
        IC.implicit_block_sparse_conv(xp.float(), wp.float(), idx, cnt, compact=ck, **kw)
    short = IC.CompactK(ck.w[:, :-1], ck.tab, ck.rows, ck.k_rows)
    with pytest.raises(ValueError, match="compacted K operands off-grid"):
        IC.implicit_block_sparse_conv(xp, wp, idx, cnt, compact=short, **kw)
    with pytest.raises(ValueError, match="channels < 32768"):
        IC.compact_k(wp, plan.idx, plan.cnt, kx=1, ky=1, cin=1 << 15, cpk=16, slot=8,
                     block=layout.block)
