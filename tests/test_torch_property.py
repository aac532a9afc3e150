"""Property tests of the port, twinned with ``tests/test_property.py``.

Each case draws its input as the JAX package's property test does, runs
the same function through ``repro`` and through ``repro_torch``, asserts
the reference's property on the port's result and asserts port == JAX on
the drawn input (tables, plans, counts and masks equal; float scores within
the reference test's own tolerance).

The draws are deterministic (``derandomize=True``) and no example database
is read or written (``database=None``), so every run runs the same
examples and counts the same tests."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="hypothesis not installed")
from hypothesis import given, settings, strategies as st

from repro import accel as JA
from repro.accel.cycle_model import schedule_counts as j_schedule_counts
from repro.core import Q2_5 as J_Q2_5, Q3_4 as J_Q3_4, apply_masks as j_apply_masks
from repro.core import fpga_conv_groups as j_fpga, quantize as j_quantize
from repro.core import tpu_tile_groups as j_tpu
from repro.core.groups import apply_group_mask as j_apply_group_mask
from repro.core.uniform import magnitude_masks as j_magnitude_masks
from repro.sparse import block_mask as JB
from repro.sparse.conv_plan import conv_gemm_layout as j_layout
from repro_torch import accel as TA
from repro_torch.accel.cycle_model import schedule_counts as t_schedule_counts
from repro_torch.core import Q2_5, Q3_4, apply_masks, fpga_conv_groups, quantize
from repro_torch.core import tpu_tile_groups
from repro_torch.core.groups import apply_group_mask
from repro_torch.core.uniform import magnitude_masks
from repro_torch.sparse import block_mask as TB
from repro_torch.sparse.conv_plan import conv_gemm_layout

SETTINGS = dict(max_examples=25, deadline=None, derandomize=True, database=None)


def _plans_equal(a, b):
    """A port plan equals a JAX plan: geometry, counts and index table."""
    assert a.block == b.block and a.tiles == b.tiles and a.max_nnz == b.max_nnz
    np.testing.assert_array_equal(a.cnt, np.asarray(b.cnt))
    np.testing.assert_array_equal(a.idx, np.asarray(b.idx))


@given(kx=st.integers(1, 4), cin=st.integers(1, 6), cout=st.integers(1, 20),
       n_cu=st.integers(1, 8))
@settings(**SETTINGS)
def test_fpga_groups_partition_weights(kx, cin, cout, n_cu):
    spec = fpga_conv_groups((kx, kx, cin, cout), n_cu)
    jspec = j_fpga((kx, kx, cin, cout), n_cu)
    assert spec.group_elem_counts().sum() == kx * kx * cin * cout
    m0 = spec.expand(torch.zeros(spec.num_groups)).numpy()
    m1 = spec.expand(torch.ones(spec.num_groups)).numpy()
    assert (m0 == 0).all() and (m1 == 1).all()
    assert spec.num_groups == jspec.num_groups
    np.testing.assert_array_equal(spec.group_elem_counts(), jspec.group_elem_counts())
    gm = (np.arange(spec.num_groups) % 3 == 0).astype(np.float32)
    np.testing.assert_array_equal(spec.expand(torch.from_numpy(gm)).numpy(),
                                  np.asarray(jspec.expand(jnp.asarray(gm))))


@given(K=st.integers(1, 400), N=st.integers(1, 400),
       bk=st.sampled_from([32, 128]), bn=st.sampled_from([32, 128]))
@settings(**SETTINGS)
def test_tile_groups_partition(K, N, bk, bn):
    spec = tpu_tile_groups((K, N), (bk, bn))
    jspec = j_tpu((K, N), (bk, bn))
    assert spec.group_elem_counts().sum() == K * N
    assert spec.num_groups == -(-K // bk) * (-(-N // bn)) == jspec.num_groups
    np.testing.assert_array_equal(spec.group_elem_counts(), jspec.group_elem_counts())


@given(data=st.data())
@settings(**SETTINGS)
def test_group_mask_expand_score_consistency(data):
    """Pruned groups score exactly zero after masking; kept groups keep
    their score; the scores are JAX's."""
    cin = data.draw(st.integers(1, 4))
    cout = data.draw(st.integers(1, 12))
    spec, jspec = fpga_conv_groups((3, 3, cin, cout), 3), j_fpga((3, 3, cin, cout), 3)
    rng = np.random.RandomState(data.draw(st.integers(0, 100)))
    w = rng.randn(3, 3, cin, cout).astype(np.float32)
    gm = (rng.rand(spec.num_groups) > 0.5).astype(np.float32)
    wm = torch.from_numpy(w) * spec.expand(torch.from_numpy(gm))
    s = spec.group_scores(wm).numpy()
    s0 = spec.group_scores(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(s, s0 * gm, rtol=1e-5, atol=1e-6)
    jwm = jnp.asarray(w) * jspec.expand(jnp.asarray(gm))
    np.testing.assert_array_equal(wm.numpy(), np.asarray(jwm))
    np.testing.assert_allclose(s, np.asarray(jspec.group_scores(jwm)), rtol=1e-5, atol=1e-6)


@given(st.lists(st.floats(-50, 50, allow_nan=False), min_size=1, max_size=64))
@settings(**SETTINGS)
def test_quantize_idempotent_and_bounded(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    for fmt, jfmt in ((Q2_5, J_Q2_5), (Q3_4, J_Q3_4)):
        q = quantize(x, fmt)
        np.testing.assert_array_equal(quantize(q, fmt).numpy(), q.numpy())
        assert float(q.max()) <= fmt.max_val
        assert float(q.min()) >= fmt.min_val
        inside = (x >= fmt.min_val) & (x <= fmt.max_val)
        assert float(((q - x).abs() * inside).max()) <= 0.5 / fmt.scale + 1e-6
        np.testing.assert_array_equal(
            q.numpy(), np.asarray(j_quantize(jnp.asarray(x.numpy()), jfmt)))


@given(sparsity=st.floats(0.0, 0.99), n=st.integers(4, 300))
@settings(**SETTINGS)
def test_magnitude_mask_count_equals_jax(sparsity, n):
    """The port prunes exactly as many weights as the JAX function does (not
    ``round(sparsity * n)``, which the JAX function does not compute), and
    the same ones."""
    w = np.random.RandomState(n).randn(n).astype(np.float32)
    m = magnitude_masks({"w": torch.from_numpy(w)}, {"w": torch.ones(n)}, sparsity)["w"]
    jm = np.asarray(j_magnitude_masks({"w": jnp.asarray(w)}, {"w": jnp.ones(n)},
                                      sparsity)["w"])
    assert int((m == 0).sum()) == int((jm == 0).sum())
    np.testing.assert_array_equal(m.numpy(), jm)


@pytest.mark.parametrize("sparsity,n,pruned,f64_round", [(0.35, 170, 60, 59),
                                                         (0.6250000000000001, 4, 2, 3)])
def test_magnitude_mask_count_rounding_edge(sparsity, n, pruned, f64_round):
    """Where ``sparsity * n`` lies next to a half in float64 and on it in
    float32, both packages round the float32 value half to even, which is
    not ``round(sparsity * n)``: 0.35 * 170 = 59.49999999999999 prunes 60,
    and 0.6250000000000001 * 4 = 2.5000000000000004 prunes 2."""
    w = np.random.RandomState(n).randn(n).astype(np.float32)
    m = magnitude_masks({"w": torch.from_numpy(w)}, {"w": torch.ones(n)}, sparsity)["w"]
    jm = np.asarray(j_magnitude_masks({"w": jnp.asarray(w)}, {"w": jnp.ones(n)},
                                      sparsity)["w"])
    assert int((m == 0).sum()) == int((jm == 0).sum()) == pruned
    assert int(round(sparsity * n)) == f64_round


@given(nKb=st.integers(1, 6), nNb=st.integers(1, 6), seed=st.integers(0, 99))
@settings(**SETTINGS)
def test_plan_indices_cover_live_tiles(nKb, nNb, seed):
    tm = np.random.RandomState(seed).rand(nKb, nNb) < 0.5
    plan = TB.plan_from_tile_mask(tm, (128, 128))
    for j in range(nNb):
        assert set(plan.idx[j, :plan.cnt[j]]) == set(np.nonzero(tm[:, j])[0])
    assert plan.cnt.sum() == tm.sum()
    _plans_equal(plan, JB.plan_from_tile_mask(tm, (128, 128)))


@given(nif=st.integers(1, 16), ratio_seed=st.integers(0, 50))
@settings(**SETTINGS)
def test_dsb_cycles_monotone_in_mask(nif, ratio_seed):
    """More pruned groups can never cost more cycles; the cycle counts are
    JAX's."""
    accel, jaccel = TA.AcceleratorConfig(n_cu=4), JA.AcceleratorConfig(n_cu=4)
    layer, jlayer = TA.ConvLayerDims(18, 18, nif, 8), JA.ConvLayerDims(18, 18, nif, 8)
    n = t_schedule_counts(layer, accel).n_steps
    assert n == j_schedule_counts(jlayer, jaccel).n_steps
    gm = (np.random.RandomState(ratio_seed).rand(n) > 0.5).astype(np.float32)
    gm2 = gm.copy()
    nz = np.nonzero(gm2)[0]
    if len(nz):
        gm2[nz[0]] = 0
    c1, c2 = TA.dsb_cycles(layer, accel, gm), TA.dsb_cycles(layer, accel, gm2)
    assert c2 <= c1 <= TA.min_cycles(layer, accel)
    assert (c1, c2, TA.min_cycles(layer, accel)) == (
        JA.dsb_cycles(jlayer, jaccel, gm), JA.dsb_cycles(jlayer, jaccel, gm2),
        JA.min_cycles(jlayer, jaccel))


@given(nKb=st.integers(1, 6), nNb=st.integers(1, 6), seed=st.integers(0, 99),
       bk=st.sampled_from([16, 128]), bn=st.sampled_from([32, 128]))
@settings(**SETTINGS)
def test_transpose_plan_roundtrip(nKb, nNb, seed, bk, bn):
    tm = np.random.RandomState(seed).rand(nKb, nNb) < 0.5
    plan = TB.plan_from_tile_mask(tm, (bk, bn))
    tp = TB.transpose_plan(plan, tm)
    assert tp.block == (bn, bk) and tp.tiles == (nNb, nKb)
    for j in range(nKb):
        assert set(tp.idx[j, :tp.cnt[j]]) == set(np.nonzero(tm.T[:, j])[0])
    assert tp.cnt.sum() == plan.cnt.sum() == tm.sum()
    assert tp.density == pytest.approx(plan.density)
    back = TB.transpose_plan(tp, tm.T)
    _plans_equal(back, plan)
    _plans_equal(tp, JB.transpose_plan(JB.plan_from_tile_mask(tm, (bk, bn)), tm))


@given(kx=st.integers(1, 4), cin=st.integers(1, 5), cout=st.integers(1, 20),
       n_cu=st.integers(1, 8), seed=st.integers(0, 99))
@settings(**SETTINGS)
def test_apply_group_mask_matches_expand_fpga(kx, cin, cout, n_cu, seed):
    spec, jspec = fpga_conv_groups((kx, kx, cin, cout), n_cu), j_fpga((kx, kx, cin, cout), n_cu)
    rng = np.random.RandomState(seed)
    w = rng.randn(kx, kx, cin, cout).astype(np.float32)
    gm = (rng.rand(spec.num_groups) > 0.5).astype(np.float32)
    fused = apply_group_mask(spec, torch.from_numpy(w), torch.from_numpy(gm)).numpy()
    np.testing.assert_array_equal(fused, w * spec.expand(torch.from_numpy(gm)).numpy())
    np.testing.assert_array_equal(
        fused, np.asarray(j_apply_group_mask(jspec, jnp.asarray(w), jnp.asarray(gm))))


@given(K=st.integers(1, 300), N=st.integers(1, 300), lead=st.integers(0, 3),
       bk=st.sampled_from([32, 128]), bn=st.sampled_from([32, 128]),
       seed=st.integers(0, 99))
@settings(**SETTINGS)
def test_apply_group_mask_matches_expand_tpu(K, N, lead, bk, bn, seed):
    shape = (lead, K, N) if lead else (K, N)
    spec, jspec = tpu_tile_groups(shape, (bk, bn)), j_tpu(shape, (bk, bn))
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    gm = (rng.rand(spec.num_groups) > 0.5).astype(np.float32)
    fused = apply_group_mask(spec, torch.from_numpy(w), torch.from_numpy(gm)).numpy()
    np.testing.assert_array_equal(fused, w * spec.expand(torch.from_numpy(gm)).numpy())
    np.testing.assert_array_equal(
        fused, np.asarray(j_apply_group_mask(jspec, jnp.asarray(w), jnp.asarray(gm))))


@given(kx=st.integers(1, 3), cin=st.integers(1, 5), cout=st.integers(1, 20),
       n_cu=st.integers(1, 8), seed=st.integers(0, 99))
@settings(**SETTINGS)
def test_conv_plan_tiles_are_groups(kx, cin, cout, n_cu, seed):
    """One tile per (g, f_block) group: live tiles == live groups."""
    spec = fpga_conv_groups((kx, kx, cin, cout), n_cu)
    gm = (np.random.RandomState(seed).rand(spec.num_groups) > 0.5).astype(np.float32)
    layout = conv_gemm_layout(spec)
    plan = layout.plan(gm)
    assert plan.tiles == (cin, spec.n_fblocks)
    assert int(plan.cnt.sum()) == int(gm.sum())
    assert layout.k_packed % 8 == 0 and layout.n_packed % 128 == 0
    jlayout = j_layout(j_fpga((kx, kx, cin, cout), n_cu))
    assert (layout.k_packed, layout.n_packed) == (jlayout.k_packed, jlayout.n_packed)
    _plans_equal(plan, jlayout.plan(gm))


@given(kx=st.integers(1, 3), cin=st.integers(1, 40), cout=st.integers(1, 40),
       n_cu=st.integers(1, 16), seed=st.integers(0, 99))
@settings(**SETTINGS)
def test_packed_conv_plan_occupancy_exact(kx, cin, cout, n_cu, seed):
    """Packed layout: occupancy keeps the schedule-step accounting exact and
    never dispatches more tiles than one group per tile."""
    spec = fpga_conv_groups((kx, kx, cin, cout), n_cu)
    gm = (np.random.RandomState(seed).rand(spec.num_groups) > 0.5).astype(np.float32)
    packed, pergroup = conv_gemm_layout(spec, packed=True), conv_gemm_layout(spec)
    live, total = packed.tile_occupancy(gm)
    assert int(live.sum()) == int(gm.sum())
    assert int(total.sum()) == spec.num_groups
    assert (packed.tile_mask(gm) == (live > 0)).all()
    p_plan, g_plan = packed.plan(gm), pergroup.plan(gm)
    assert int(p_plan.cnt.sum()) <= int(g_plan.cnt.sum())
    assert np.prod(p_plan.tiles) <= np.prod(g_plan.tiles)
    assert packed.k_packed % 8 == 0 and packed.n_packed % 128 == 0
    jpacked = j_layout(j_fpga((kx, kx, cin, cout), n_cu), packed=True)
    jlive, jtotal = jpacked.tile_occupancy(gm)
    np.testing.assert_array_equal(live, np.asarray(jlive))
    np.testing.assert_array_equal(total, np.asarray(jtotal))
    _plans_equal(p_plan, jpacked.plan(gm))


@given(seed=st.integers(0, 99))
@settings(**SETTINGS)
def test_apply_masks_idempotent(seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(8, 8).astype(np.float32)
    ma = (rng.rand(8, 8) > 0.3).astype(np.float32)
    p = {"a": torch.from_numpy(a), "b": torch.ones(3)}
    m = {"a": torch.from_numpy(ma), "b": None}
    once = apply_masks(p, m)
    twice = apply_masks(once, m)
    jonce = j_apply_masks({"a": jnp.asarray(a), "b": jnp.ones(3)},
                          {"a": jnp.asarray(ma), "b": None})
    for k in p:
        np.testing.assert_array_equal(once[k].numpy(), twice[k].numpy())
        np.testing.assert_array_equal(once[k].numpy(), np.asarray(jonce[k]))
