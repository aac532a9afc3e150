"""Port vs JAX package: the pricing slice (``accel/``) — the Eq. 3–9 cycle
model, the Algorithm-2 schedule, the board configurations, ``layer_dims``
and ``simulate`` — plus the quickstart twin.

``config``, ``cycle_model`` and ``scheduler`` are copies (pure Python and
numpy): every output is held *equal* to the JAX package's. ``simulate``
runs the port on the CPU (the kernels' plain versions) and the JAX package
with Pallas in interpret mode, on the same weights (``cnn.init`` in JAX,
``np.asarray``, ``params_from_numpy``) and the same numpy frames: every
integer, byte count, time, fraction and accuracy is equal, not close —
the fractions are exact counts divided once in f32 on both sides, and the
conv inputs they count are exact fake-quant sums."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro import accel as JA
from repro.accel import simulator as JS
from repro.core import (HAPMConfig, apply_masks, full_masks, global_sparsity,
                        hapm_element_masks, hapm_epoch_update, hapm_init)
from repro.core.uniform import magnitude_masks
from repro.models import cnn as JC
from repro_torch import accel as TA
from repro_torch.accel import simulator as TS
from repro_torch.configs import resnet21_cifar as TRC
from repro_torch.models import cnn as TC

TINY = dict(stages=(1, 1), widths=(8, 16), image_size=16)
N_CU = 4

ACCEL_KW = dict(cu_x=2, cu_y=3, n_cu=12)
LAYER_KW = dict(n_ix=34, n_iy=34, n_if=12, n_of=12, kx=3, ky=3)


def _both(kw_accel=None, kw_layer=None):
    ja = JA.AcceleratorConfig(**(kw_accel or ACCEL_KW))
    ta = TA.AcceleratorConfig(**(kw_accel or ACCEL_KW))
    jl = JA.ConvLayerDims(**(kw_layer or LAYER_KW))
    tl = TA.ConvLayerDims(**(kw_layer or LAYER_KW))
    return ja, ta, jl, tl


def _to_port_accel(a):
    return TA.AcceleratorConfig(**dataclasses.asdict(a))


# --- copies: config, cycle model, scheduler -----------------------------------

def test_boards_equal():
    assert list(JA.BOARDS) == list(TA.BOARDS)
    for name, board in JA.BOARDS.items():
        tb = TA.BOARDS[name]
        assert dataclasses.asdict(board) == dataclasses.asdict(tb)
        assert (board.cu_h, board.dsps, board.fifo_efficiency) == \
            (tb.cu_h, tb.dsps, tb.fifo_efficiency)
    for name in ("ZYBO_70", "ZEDBOARD_100", "ZEDBOARD_83_144"):
        assert dataclasses.asdict(getattr(JA, name)) == dataclasses.asdict(getattr(TA, name))
        assert getattr(TRC, name) is getattr(TA, name)   # configs re-exports them
    assert TRC.BOARDS is TA.BOARDS


def test_paper_worked_example_exact():
    ja, ta, jl, tl = _both()
    assert TA.min_cycles(tl, ta) == JA.min_cycles(jl, ja) == 12288


def test_schedule_counts_worked_example():
    ja, ta, jl, tl = _both()
    sc = TA.schedule_counts(tl, ta)
    assert dataclasses.asdict(sc) == dataclasses.asdict(JA.schedule_counts(jl, ja))
    assert (sc.p_x, sc.g_cu, sc.ratio, sc.n_steps, sc.cycles_per_step) == (32, 2, 1, 12, 1024)


def test_dsb_group_skip_arithmetic():
    ja, ta, jl, tl = _both()
    gm = np.ones(12, np.float32)
    gm[:6] = 0
    assert TA.dsb_cycles(tl, ta, gm) == JA.dsb_cycles(jl, ja, gm) == 12288 // 2
    jn = JA.AcceleratorConfig(dsb=False, **ACCEL_KW)
    tn = TA.AcceleratorConfig(dsb=False, **ACCEL_KW)
    assert TA.dsb_cycles(tl, tn, gm) == JA.dsb_cycles(jl, jn, gm) == 12288
    for frac in (0.37, 0.5, 1.0):
        assert TA.dsb_cycles(tl, ta, gm, frac) == JA.dsb_cycles(jl, ja, gm, frac)


def test_dsb_empty_and_full_masks():
    ja, ta, jl, tl = _both()
    for gm, want in ((np.zeros(12, np.float32), 0), (np.ones(12, np.float32), 12288),
                     (None, 12288)):
        assert TA.dsb_cycles(tl, ta, gm) == JA.dsb_cycles(jl, ja, gm) == want


def test_more_cus_never_slower():
    base = None
    for n_cu in (4, 6, 12):
        kw = dict(cu_x=2, cu_y=3, n_cu=n_cu)
        ja, ta, jl, tl = _both(kw, dict(n_ix=34, n_iy=34, n_if=12, n_of=12))
        c = TA.min_cycles(tl, ta)
        assert c == JA.min_cycles(jl, ja)
        if base is not None:
            assert c <= base
        base = c


def test_network_cycles_and_gops():
    ja, ta, jl, tl = _both()
    second = dict(n_ix=18, n_iy=18, n_if=12, n_of=24)
    rs = np.random.RandomState(0)
    masks = [(rs.rand(12) > 0.5).astype(np.float32), (rs.rand(24) > 0.3).astype(np.float32)]
    for gms, fracs in ((None, None), (masks, None), (masks, [0.9, 0.61])):
        jn = JA.network_cycles([jl, JA.ConvLayerDims(**second)], ja, gms, fracs)
        tn = TA.network_cycles([tl, TA.ConvLayerDims(**second)], ta, gms, fracs)
        assert dataclasses.asdict(jn) == dataclasses.asdict(tn)
        for dsb in (False, True):
            for stalls in (False, True):
                assert tn.seconds(ta, dsb, stalls) == jn.seconds(ja, dsb, stalls)
                assert tn.gops(ta, dsb, stalls) == jn.gops(ja, dsb, stalls)
    tn = TA.network_cycles([tl, TA.ConvLayerDims(**second)], ta)
    assert tn.seconds(ta, False, True) > tn.seconds(ta, False, False)


def test_theoretical_gops_increases_with_parallelism():
    layers = [dict(n_ix=34, n_iy=34, n_if=16, n_of=32), dict(n_ix=18, n_iy=18, n_if=32, n_of=32)]
    got = {}
    for n_cu in (12, 24):
        j = JA.theoretical_gops([JA.ConvLayerDims(**d) for d in layers],
                                JA.AcceleratorConfig(n_cu=n_cu))
        t = TA.theoretical_gops([TA.ConvLayerDims(**d) for d in layers],
                                TA.AcceleratorConfig(n_cu=n_cu))
        assert j == t
        got[n_cu] = t
    assert got[24] > got[12]


def test_writeback_penalty():
    ja, ta, jl, tl = _both()
    wb = TA.writeback_cycles(tl, ta)
    assert wb == JA.writeback_cycles(jl, ja) == int(np.ceil(
        tl.out_x * tl.out_y * tl.n_of / ta.writeback_words_per_cycle))
    assert (tl.out_x, tl.out_y, tl.macs, tl.ops) == (jl.out_x, jl.out_y, jl.macs, jl.ops)


@pytest.mark.parametrize("stride,cin,cout,n_cu", [(1, 5, 7, 4), (2, 3, 8, 4), (1, 2, 3, 12)])
def test_algorithm2_equals_conv(stride, cin, cout, n_cu):
    rng = np.random.RandomState(0)
    x = rng.randn(11, 9, cin).astype(np.float32)
    k = rng.randn(3, 3, cin, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    out = TA.conv_schedule_reference(x, k, b, stride, TA.AcceleratorConfig(n_cu=n_cu))
    np.testing.assert_array_equal(
        out, JA.conv_schedule_reference(x, k, b, stride, JA.AcceleratorConfig(n_cu=n_cu)))
    ref = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(2, 0, 1)[None], torch.from_numpy(k).permute(3, 2, 0, 1),
        torch.from_numpy(b), stride=stride)[0].permute(1, 2, 0)
    np.testing.assert_allclose(out, ref.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cin,cout,n_cu", [(3, 8, 4), (16, 64, 12), (5, 7, 24)])
def test_schedule_trace_matches_group_ids(cin, cout, n_cu):
    steps = TA.schedule_step_trace(cin=cin, cout=cout, accel=TA.AcceleratorConfig(n_cu=n_cu))
    assert steps == JA.schedule_step_trace(cin=cin, cout=cout,
                                           accel=JA.AcceleratorConfig(n_cu=n_cu))
    if (cin, cout, n_cu) == (3, 8, 4):
        assert len(steps) == 6 and steps[0] == (0, 0, 0)
        assert steps[1] == (0, 1, 2) and steps[3] == (1, 0, 1)


# --- layer_dims on the paper's network ------------------------------------------

def test_layer_dims_equal_on_resnet21():
    cfg = JC.ResNetConfig()
    params, _ = JC.init(jax.random.PRNGKey(0), cfg)
    tparams, _ = TC.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                      device="cpu")
    jd, td = JC.layer_dims(cfg, params), TC.layer_dims(TC.ResNetConfig(), tparams)
    assert len(td) == len(jd) == 21                     # the paper's 21 conv layers
    for (jp, jl), (tp, tl) in zip(jd, td):
        assert jp == tp
        assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
    ops = TC.network_ops(TC.ResNetConfig(), tparams)
    assert ops == JC.network_ops(cfg, params)
    assert 0.03e9 < ops < 0.1e9


# --- the data-column fraction -------------------------------------------------

@pytest.mark.parametrize("shape,cu_h", [((2, 16, 16, 8), 4), ((3, 15, 9, 5), 4),
                                        ((2, 7, 5, 3), 3), ((1, 8, 8, 16), 6)])
def test_data_col_nonzero_frac_equal(shape, cu_h):
    """Non-overlapping blocks of cu_h rows; the last H mod cu_h rows count
    nowhere (H = 15 with cu_h = 4 drops row 14)."""
    rs = np.random.RandomState(sum(shape))
    a = np.round(np.maximum(rs.randn(*shape), 0) * 2 - 1.2).astype(np.float32) / 16
    a[0, : shape[1] // 2] = 0.0
    got = TS._data_col_nonzero_frac(torch.from_numpy(a), cu_h)
    assert got == JS._data_col_nonzero_frac(jnp.asarray(a), cu_h)
    if shape[1] % cu_h:
        b = a.copy()
        b[:, (shape[1] // cu_h) * cu_h:] = 1.0      # rows past the last column
        assert TS._data_col_nonzero_frac(torch.from_numpy(b), cu_h) == got


# --- simulate -------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny net, HAPM-pruned at group sparsity 0.5 (n_cu = 4), and
    its port twin on the CPU; uniform magnitude masks at the same element
    sparsity; 16 frames with a dead lower half and their labels."""
    jcfg = JC.ResNetConfig(**TINY)
    params, state = JC.init(jax.random.PRNGKey(0), jcfg)
    specs = JC.conv_group_specs(params, N_CU)
    hcfg = HAPMConfig(0.5, 1)
    st = hapm_epoch_update(hapm_init(specs, hcfg), specs, params, hcfg)
    hmasks = hapm_element_masks(specs, st)
    pruned = apply_masks(params, hmasks)
    uniform = apply_masks(params, magnitude_masks(
        params, full_masks(params, JC.is_conv_weight), global_sparsity(hmasks)))
    rs = np.random.RandomState(1)
    imgs = rs.rand(16, 16, 16, 3).astype(np.float32)
    imgs[:, 8:] = 0.0
    labels = rs.randint(0, 10, 16).astype(np.int32)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    port = {name: TC.params_from_numpy(np_tree(p), np_tree(state), device="cpu")
            for name, p in (("dense", params), ("hapm", pruned), ("uniform", uniform))}
    return {"jcfg": jcfg, "tcfg": TC.ResNetConfig(**TINY), "state": state,
            "jax": {"dense": params, "hapm": pruned, "uniform": uniform},
            "port": port, "imgs": imgs, "labels": labels}


def _assert_reports_equal(j, t):
    for f in dataclasses.fields(j):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if f.name == "accel":
            assert dataclasses.asdict(jv) == dataclasses.asdict(tv)
        elif f.name in ("cycles", "cycles_dual") and jv is not None:
            assert dataclasses.asdict(jv) == dataclasses.asdict(tv), f.name
        else:
            assert jv == tv, (f.name, jv, tv)
    assert j.row() == t.row()
    for prop in ("hbm_bytes_ratio", "hbm_bytes_int8_ratio", "hbm_bytes_streamed_ratio",
                 "grid_step_ratio", "packed_grid_step_ratio", "dsb_cycle_ratio",
                 "dual_dsb_cycle_ratio"):
        assert getattr(j, prop) == getattr(t, prop), prop


def _sim_both(tiny, model, board, with_images=True, **kw):
    ja = dataclasses.replace(JA.BOARDS[board], n_cu=N_CU) if isinstance(board, str) else board
    args_j = (jnp.asarray(tiny["imgs"]), jnp.asarray(tiny["labels"])) if with_images else ()
    args_t = (tiny["imgs"], tiny["labels"]) if with_images else ()
    j = JA.simulate(tiny["jax"][model], tiny["state"], tiny["jcfg"], ja, *args_j, **kw)
    tp, ts = tiny["port"][model]
    t = TA.simulate(tp, ts, tiny["tcfg"], _to_port_accel(ja), *args_t, device="cpu", **kw)
    return j, t


def test_simulate_equal_with_measured_dsb(tiny):
    """HAPM-pruned, images + labels, ``measure_dsb``: the kernel's skip
    counter (plain version here) runs on the fully pruned convs; every field
    equal to the JAX package's."""
    j, t = _sim_both(tiny, "hapm", "zedboard_100mhz_72dsp", measure_dsb=True, dsb_sample=2)
    _assert_reports_equal(j, t)
    assert t.accuracy is not None and t.cycles_dual is not None
    assert 0.0 < t.dsb_skip_frac_predicted < 1.0
    assert any("measured_skip" in d for d in t.dsb_skip_per_layer.values())


@pytest.mark.parametrize("model,board,kw", [
    ("dense", "zedboard_100mhz_72dsp", {}),
    ("uniform", "zybo_70mhz_72dsp", {}),
    ("hapm", "zedboard_83mhz_144dsp", {"data_bypass": True}),
])
def test_simulate_equal_with_images(tiny, model, board, kw):
    _assert_reports_equal(*_sim_both(tiny, model, board, **kw))


@pytest.mark.parametrize("model", ["dense", "hapm"])
def test_simulate_equal_without_images(tiny, model):
    nodsb = dataclasses.replace(JA.BOARDS["zedboard_100mhz_72dsp"], n_cu=N_CU, dsb=False)
    for board in ("zedboard_100mhz_72dsp", nodsb):
        j, t = _sim_both(tiny, model, board, with_images=False)
        _assert_reports_equal(j, t)
        assert t.accuracy is None and t.cycles_dual is None


def test_simulator_hapm_speedup_and_accuracy_fields(tiny):
    """``test_accel_sim.py``'s ordering, on the port."""
    accel = dataclasses.replace(TA.BOARDS["zedboard_100mhz_72dsp"], n_cu=N_CU)
    cfg, (dense, state), (pruned, _) = tiny["tcfg"], tiny["port"]["dense"], tiny["port"]["hapm"]
    imgs, labels = torch.from_numpy(tiny["imgs"]), torch.from_numpy(tiny["labels"])
    base = TA.simulate(dense, state, cfg, accel, imgs, labels, device="cpu")
    rep = TA.simulate(pruned, state, cfg, accel, imgs, labels, device="cpu")
    assert base.accuracy is not None and base.mean_time_per_image_s > 0
    assert rep.mean_time_per_image_s < 0.72 * base.mean_time_per_image_s
    assert rep.gops > base.gops
    no_dsb = dataclasses.replace(accel, dsb=False)
    assert TA.simulate(pruned, state, cfg, no_dsb).mean_time_per_image_s == \
        pytest.approx(TA.simulate(dense, state, cfg, no_dsb).mean_time_per_image_s)


def test_fifo_depth_improves_time(tiny):
    cfg, (params, state) = tiny["tcfg"], tiny["port"]["dense"]
    t = {d: TA.simulate(params, state, cfg, dataclasses.replace(
        TA.BOARDS["zedboard_100mhz_72dsp"], fifo_depth=d)).mean_time_per_image_s
        for d in (8, 32)}
    assert t[32] < t[8]


def test_hapm_dsb_cycles_beat_uniform_at_equal_element_sparsity(tiny):
    """``test_hapm_dsb_regression.py``'s Fig.-6 ordering on the port, on
    the same masks as the JAX package's run (which it equals)."""
    j_h, t_h = _sim_both(tiny, "hapm", "zedboard_100mhz_72dsp", with_images=False)
    j_u, t_u = _sim_both(tiny, "uniform", "zedboard_100mhz_72dsp", with_images=False)
    _assert_reports_equal(j_u, t_u)
    assert t_h.cycles.total_dsb < t_u.cycles.total_dsb
    assert t_h.mean_time_per_image_s < t_u.mean_time_per_image_s
    assert t_h.executed_grid_steps < t_u.executed_grid_steps
    assert t_u.cycles.total_dsb > 0.9 * t_u.cycles.total_min


def test_simulate_refusals(tiny):
    cfg, (params, state) = tiny["tcfg"], tiny["port"]["hapm"]
    board = TA.BOARDS["zedboard_100mhz_72dsp"]
    with pytest.raises(ValueError, match="images"):
        TA.simulate(params, state, cfg, board, measure_dsb=True)
    if not torch.cuda.is_available():       # the card by default, no silent CPU
        with pytest.raises(RuntimeError, match="none is available"):
            TA.simulate(params, state, cfg, board, tiny["imgs"], tiny["labels"])


# --- the entry points -----------------------------------------------------------

def test_quickstart_twin_on_cpu(capsys):
    from repro_torch.launch import quickstart
    base, fast, no_dsb = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "21-conv ResNet" in out and "pruned 50% of groups" in out
    assert "HAPM 50% no DSB" in out
    assert fast.mean_time_per_image_s < base.mean_time_per_image_s
    assert no_dsb.mean_time_per_image_s == base.mean_time_per_image_s
    assert base.cycles.total_ops == TC.network_ops(
        TC.ResNetConfig(), TC.init(0, TC.ResNetConfig(), device="cpu")[0])
