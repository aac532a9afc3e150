"""Port vs JAX package: the implicit-im2col conv's module
(``kernels/implicit_conv.py``) through ``sparse.conv_plan.make_sparse_conv``.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode. Same numpy inputs through both.

Tolerances: f32 <= 1e-5 (summation order). int8 contracts accumulate exact
integers: requantized (streamed) codes and skip counters must be
**bit-equal**; the f32 output of a quantized conv with a fused bias is held
to one unit in the last place against JAX (XLA's CPU backend fuses the
epilogue's multiply and add into one rounding, the port keeps two — see
``test_torch_block_sparse_matmul.py``) and **exactly** to the port's own
two-rounding integer oracle."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.core import groups as JG, quant as JQ
from repro.kernels import implicit_conv as JI
from repro.sparse import conv_plan as JP
from repro_torch.core import groups as TG, quant as TQ
from repro_torch.kernels import implicit_conv as TI, ref as TR
from repro_torch.sparse import conv_plan as TP

N_CU = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer(k, cin, cout, packed, seed, h=12, w_=None, batch=2, density=0.5):
    rs = np.random.RandomState(seed)
    shape = (k, k, cin, cout)
    js, ts = JG.fpga_conv_groups(shape, N_CU), TG.fpga_conv_groups(shape, N_CU)
    jl = JP.conv_gemm_layout(js, packed=packed)
    tl = TP.conv_gemm_layout(ts, packed=packed)
    gm = (rs.rand(js.num_groups) < density).astype(np.float32)
    gm.reshape(cin, -1)[:, -1] = 0          # one fully pruned f_block column
    w = (rs.randn(*shape) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
    b = (0.2 * rs.randn(cout)).astype(np.float32)
    x = np.maximum(rs.randn(batch, h, w_ or h, cin), 0).astype(np.float32)
    return jl, tl, gm, w, b, x


def _bind(jl, tl, gm, w, b, mode, relu=True, dsb=False, implicit=None, bm="auto",
          bias=True):
    jq = tq = jo = to = None
    if mode != "f32":
        jq, tq = JQ.QuantSpec.calibrate(jnp.asarray(w)), TQ.QuantSpec.calibrate(_t(w))
    if mode == "streamed":
        jo, to = JQ.QuantSpec(), TQ.QuantSpec()
    jc = JP.make_sparse_conv(jl, gm, weight=jnp.asarray(w),
                             bias=jnp.asarray(b) if bias else None, relu=relu,
                             quant=jq, out_quant=jo, activation_dsb=dsb,
                             implicit=implicit, bm=bm)
    tc = TP.make_sparse_conv(tl, gm, weight=_t(w), bias=_t(b) if bias else None,
                             relu=relu, quant=tq, out_quant=to, activation_dsb=dsb,
                             implicit=implicit, bm=bm)
    return jc, tc


CONVS = [  # (k, cin, cout, stride)
    (3, 8, 16, 1), (3, 8, 16, 2), (1, 8, 16, 2), (1, 6, 10, 1), (3, 5, 10, 1),
]


@pytest.mark.parametrize("k,cin,cout,stride", CONVS)
@pytest.mark.parametrize("packed", [False, True])
def test_f32_matches_jax_and_dense(k, cin, cout, stride, packed):
    jl, tl, gm, w, b, x = _layer(k, cin, cout, packed, 0)
    jc, tc = _bind(jl, tl, gm, w, b, "f32")
    assert tc.implicit and jc.implicit
    jy = np.asarray(jc(jnp.asarray(x), stride=stride))
    ty = tc(_t(x), stride=stride).numpy()
    np.testing.assert_allclose(ty, jy, atol=1e-5)
    from repro_torch.models.cnn import _conv
    wm = tl.spec.expand(gm) * _t(w)
    dense = torch.relu(_conv(_t(x), wm, stride) + _t(b)).numpy()
    np.testing.assert_allclose(ty, dense, atol=1e-4)
    # the same answer with the weight passed per call (unbound closure)
    tc2 = TP.make_sparse_conv(tl, gm, bias=_t(b), relu=True)
    np.testing.assert_array_equal(tc2(_t(x), _t(w), stride=stride).numpy(), ty)


@pytest.mark.parametrize("k,cin,cout,stride", CONVS)
@pytest.mark.parametrize("packed", [False, True])
def test_streamed_codes_bit_equal(k, cin, cout, stride, packed):
    jl, tl, gm, w, b, x = _layer(k, cin, cout, packed, 1)
    jc, tc = _bind(jl, tl, gm, w, b, "streamed")
    jy = np.asarray(jc(jnp.asarray(x), stride=stride))
    ty = tc(_t(x), stride=stride).numpy()
    assert ty.dtype == jy.dtype == np.int8
    np.testing.assert_array_equal(ty, jy)
    # an activation that is already codes skips the ingest quantize
    codes = TQ.QuantSpec().act_codes(_t(x))
    np.testing.assert_array_equal(tc(codes, stride=stride).numpy(), ty)


@pytest.mark.parametrize("k,cin,cout,stride", CONVS)
@pytest.mark.parametrize("packed", [False, True])
def test_int8_f32_output(k, cin, cout, stride, packed):
    jl, tl, gm, w, b, x = _layer(k, cin, cout, packed, 2)
    # no bias: one rounding in the epilogue -> bit-equal to JAX
    jc, tc = _bind(jl, tl, gm, w, b, "int8", relu=False, bias=False)
    np.testing.assert_array_equal(tc(_t(x), stride=stride).numpy(),
                                  np.asarray(jc(jnp.asarray(x), stride=stride)))
    # bias + ReLU: equal to the two-rounding integer oracle, 1 ulp from JAX/CPU
    jc, tc = _bind(jl, tl, gm, w, b, "int8")
    ty = tc(_t(x), stride=stride).numpy()
    np.testing.assert_allclose(ty, np.asarray(jc(jnp.asarray(x), stride=stride)),
                               rtol=2.5e-7, atol=1e-7)
    q = tc.quant
    wm = tl.spec.expand(gm) * _t(w)
    oracle = TR.int8_conv_ref(q.act_codes(_t(x)), q.weight_codes(wm),
                              q.dequant_row(cout), stride, "SAME", bias=_t(b), relu=True)
    np.testing.assert_array_equal(ty, oracle.numpy())


@pytest.mark.parametrize("k,cin,cout,stride", CONVS)
@pytest.mark.parametrize("packed", [False, True])
def test_activation_dsb_bit_exact_and_skip_counts_equal(k, cin, cout, stride, packed):
    jl, tl, gm, w, b, x = _layer(k, cin, cout, packed, 3, batch=3)
    x[0] = 0.0                       # a whole frame of zero codes
    x[1, :, :, : cin // 2] = 0.0     # dead channels -> dead K-tiles (unpacked)
    x[2, 6:] = 0.0                   # dead lower half -> dead M-blocks
    jc, tc = _bind(jl, tl, gm, w, b, "streamed", dsb=True)
    _, tc_off = _bind(jl, tl, gm, w, b, "streamed", dsb=False)
    jy, jstats = jc.skip_counts(jnp.asarray(x), stride=stride)
    ty, tstats = tc.skip_counts(_t(x), stride=stride)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tstats == jstats and tstats["skipped_steps"] > 0
    np.testing.assert_array_equal(tc(_t(x), stride=stride).numpy(), ty.numpy())
    y_off, s_off = tc_off.skip_counts(_t(x), stride=stride)
    np.testing.assert_array_equal(y_off.numpy(), ty.numpy())    # the skip is exact
    assert s_off == {"skipped_steps": 0, "live_steps": tstats["live_steps"]}


def test_stride2_window_nonzero_only_at_untapped_pixels():
    """The skip tests the WHOLE window, not the tapped pixels: with stride 2
    and a 1x1 kernel only even pixels are tapped, so an input that is
    non-zero at odd pixels only contributes nothing — and still must not
    count as a skip."""
    jl, tl, gm, w, b, x = _layer(1, 8, 16, False, 4, h=8)
    gm[:] = 1.0
    x[:] = 0.0
    x[:, 1::2, 1::2, :] = 1.0
    jc, tc = _bind(jl, tl, gm, w, b, "streamed", dsb=True, relu=False)
    jy, jstats = jc.skip_counts(jnp.asarray(x), stride=2)
    ty, tstats = tc.skip_counts(_t(x), stride=2)
    assert tstats == jstats and tstats["skipped_steps"] == 0 and tstats["live_steps"] > 0
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    x[:] = 0.0                       # now truly all zero: every live step skips
    _, tstats = tc.skip_counts(_t(x), stride=2)
    _, jstats = jc.skip_counts(jnp.asarray(x), stride=2)
    assert tstats == jstats and tstats["skipped_steps"] == tstats["live_steps"]


def test_column_segmented_wide_row():
    """wo > 128: one output row splits into column segments (spi > 1)."""
    jl, tl, gm, w, b, x = _layer(3, 4, 8, True, 5, h=3, w_=150, batch=1)
    jc, tc = _bind(jl, tl, gm, w, b, "streamed", dsb=True)
    assert TI.choose_m_block(3, 150).spi == 2
    jy, jstats = jc.skip_counts(jnp.asarray(x))
    ty, tstats = tc.skip_counts(_t(x))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tstats == jstats
    jf, tf = _bind(jl, tl, gm, w, b, "f32")
    np.testing.assert_allclose(tf(_t(x)).numpy(), np.asarray(jf(jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("mode", ["f32", "streamed"])
def test_materializing_path_and_fixed_bm(mode):
    jl, tl, gm, w, b, x = _layer(3, 8, 16, True, 6)
    jc, tc = _bind(jl, tl, gm, w, b, mode, implicit=False, bm=64)
    assert not tc.implicit
    jy, ty = np.asarray(jc(jnp.asarray(x), stride=2)), tc(_t(x), stride=2).numpy()
    if mode == "f32":
        np.testing.assert_allclose(ty, jy, atol=1e-5)
    else:
        np.testing.assert_array_equal(ty, jy)
    y2, stats = tc.skip_counts(_t(x), stride=2)
    assert stats is None and np.array_equal(y2.numpy(), ty)
    # the implicit kernel agrees with its materializing oracle
    _, ti = _bind(jl, tl, gm, w, b, mode)
    if mode == "f32":
        np.testing.assert_allclose(ti(_t(x), stride=2).numpy(), ty, atol=1e-5)
    else:
        np.testing.assert_array_equal(ti(_t(x), stride=2).numpy(), ty)


def test_per_call_fallback_rule():
    """No whole-row M-block under the cap, or a window over the accounting
    budget, sends the call to the materializing path — results unchanged."""
    jl, tl, gm, w, b, x = _layer(3, 4, 8, False, 7, h=5)
    jc, tc = _bind(jl, tl, gm, w, b, "streamed", dsb=True, bm=4)   # cap 4 < 8 pixels
    assert TI.choose_m_block(5, 5, cap=4) is None
    y, stats = tc.skip_counts(_t(x))
    assert stats is None
    np.testing.assert_array_equal(y.numpy(), np.asarray(jc(jnp.asarray(x))))


def test_raw_kernel_function_equal():
    """The module's function itself, on packed operands, incl. the skip map."""
    jl, tl, gm, w, b, x = _layer(3, 8, 16, False, 8, h=8)
    q = TQ.QuantSpec.calibrate(_t(w))
    wm = tl.spec.expand(gm) * _t(w)
    wp = tl.pack_weight(q.weight_codes(wm))
    mb = TI.choose_m_block(8, 8)
    xp = TI.pad_input(q.act_codes(_t(x)), 3, 3, 1, "SAME", mb, tl.tiles[0])
    plan = tl.plan(gm)
    rows = [tl.pack_bias(r) for r in (_t(b), q.dequant_row(16), torch.full((16,), 16.0))]
    kw = dict(kx=3, ky=3, stride=1, block=tl.block, cpk=1, slot=tl.block[0], relu=True,
              activation_dsb=True, count_skips=True)
    ty, tsk = TI.implicit_block_sparse_conv(xp, wp, _t(plan.idx), _t(plan.cnt), *rows,
                                            mb=mb, **kw)
    jy, jsk = JI.implicit_block_sparse_conv(
        jnp.asarray(xp.numpy()), jnp.asarray(wp.numpy()), jnp.asarray(plan.idx),
        jnp.asarray(plan.cnt), *[jnp.asarray(r.numpy()) for r in rows],
        mb=JI.MBlock(*mb), interpret=True, **kw)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tsk.numpy(), np.asarray(jsk))
    assert tsk.dtype == torch.int32 and tuple(tsk.shape) == (2 * mb.bpi, tl.tiles[1])


def test_bind_contract_errors():
    jl, tl, gm, w, b, x = _layer(3, 8, 16, False, 9)
    q = TQ.QuantSpec()
    with pytest.raises(ValueError, match="out_quant requantizes"):
        TP.make_sparse_conv(tl, gm, weight=_t(w), out_quant=q)
    with pytest.raises(ValueError, match="activation_dsb skips on exact int8"):
        TP.make_sparse_conv(tl, gm, weight=_t(w), activation_dsb=True)
    with pytest.raises(ValueError, match="activation_dsb lives in the implicit"):
        TP.make_sparse_conv(tl, gm, weight=_t(w), quant=q, activation_dsb=True,
                            implicit=False)
    with pytest.raises(ValueError, match="inference-only"):
        TP.make_sparse_conv(tl, gm, weight=_t(w), relu=True, trainable=True)
    assert TP.make_sparse_conv(tl, gm, trainable=True).trainable
    with pytest.raises(ValueError, match="no weight bound"):
        TP.make_sparse_conv(tl, gm)(_t(x))
    tile = TP.conv_gemm_layout(TG.tpu_tile_groups((72, 16), (16, 128)))
    with pytest.raises(ValueError, match="implicit=True needs a channel-major"):
        TP.make_sparse_conv(tile, np.ones(tile.spec.num_groups), implicit=True)
    with pytest.raises(TypeError, match="activation_dsb keys the skip"):
        TI.implicit_block_sparse_conv(
            torch.zeros(1, 10, 10, 8), torch.zeros(128, 128), torch.zeros(1, 1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), kx=3, ky=3, stride=1,
            mb=TI.choose_m_block(8, 8), block=(16, 128), cpk=1, slot=16,
            activation_dsb=True)


def test_tile_layout_runs_materializing():
    rs = np.random.RandomState(10)
    w = rs.randn(3, 3, 8, 16).astype(np.float32)
    x = rs.randn(2, 6, 6, 8).astype(np.float32)
    js, ts = JG.tpu_tile_groups((72, 16), (16, 128)), TG.tpu_tile_groups((72, 16), (16, 128))
    gm = (rs.rand(js.num_groups) > 0.4).astype(np.float32)
    jc = JP.make_sparse_conv(JP.conv_gemm_layout(js), gm, weight=jnp.asarray(w))
    tc = TP.make_sparse_conv(TP.conv_gemm_layout(ts), gm, weight=_t(w))
    assert not tc.implicit
    np.testing.assert_allclose(tc(_t(x)).numpy(), np.asarray(jc(jnp.asarray(x))), atol=1e-5)
