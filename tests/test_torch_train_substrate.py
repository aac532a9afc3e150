"""Port vs JAX package: the training substrate — optimizers, schedules,
the train-step factory (grad accumulation, mask discipline), gradient
compression with error feedback, checkpoints (interchangeable with the JAX
package's in both directions), the watchdog, and the ``CnnServer``
snapshot / warm restart built on the checkpoints. Mirrors
``tests/test_train_substrate.py`` (its elastic restore is twinned in
``tests/test_torch_data_pipeline.py``, beside the port of ``dist/``) and the
snapshot cases of ``tests/test_resilience.py``.

Same numpy inputs to both; f32 results within 1e-6 (the same operations in
the same order), checkpoint arrays equal."""
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import hapm as JH, masks as JM
from repro.models import cnn as JC
from repro.train import checkpoint as JCK
from repro.train import compression as JCOMP
from repro.train.optimizer import adamw as j_adamw, sgd as j_sgd
from repro_torch.launch.serve_cnn import CnnServer
from repro_torch.models import cnn as TC
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import compression as COMP
from repro_torch.train.loop import (EpochCallbacks, StepConfig, StepWatchdog,
                                    make_train_step, run_epochs)
from repro_torch.train.optimizer import (ReduceLROnPlateau, adamw, apply_updates,
                                         cosine_schedule, sgd)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_sgd_momentum_closed_form():
    init, update = sgd(momentum=0.5)
    p = {"w": torch.tensor([1.0])}
    g = {"w": torch.tensor([2.0])}
    st = init(p)
    u1, st = update(g, st, p, lr=0.1)
    assert float(u1["w"][0]) == pytest.approx(-0.2)          # m=2, step=-lr*m
    u2, st = update(g, st, p, lr=0.1)
    assert float(u2["w"][0]) == pytest.approx(-0.1 * (0.5 * 2 + 2))


@pytest.mark.parametrize("opt", ["sgd", "sgd_nesterov", "adamw"])
def test_optimizers_match_jax_over_steps(opt):
    rs = np.random.RandomState(0)
    p0 = {"a": rs.randn(3, 4).astype(np.float32), "b": {"c": rs.randn(5).astype(np.float32)}}
    grads = [{"a": rs.randn(3, 4).astype(np.float32),
              "b": {"c": rs.randn(5).astype(np.float32)}} for _ in range(4)]
    if opt == "adamw":
        (ji, ju), (ti, tu) = j_adamw(weight_decay=0.1), adamw(weight_decay=0.1)
    else:
        nest = opt == "sgd_nesterov"
        (ji, ju), (ti, tu) = (j_sgd(0.9, nest, 1e-4), sgd(0.9, nest, 1e-4))
    jp = jax.tree.map(jnp.asarray, p0)
    tp = {"a": _t(p0["a"]), "b": {"c": _t(p0["b"]["c"])}}
    js, ts = ji(jp), ti(tp)
    for g in grads:
        ju_, js = ju(jax.tree.map(jnp.asarray, g), js, jp, 0.05)
        tu_, ts = tu({"a": _t(g["a"]), "b": {"c": _t(g["b"]["c"])}}, ts, tp, 0.05)
        jp = jax.tree.map(lambda a, b: a + b, jp, ju_)
        tp = apply_updates(tp, tu_)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp["b"]["c"].numpy(), np.asarray(jp["b"]["c"]),
                               rtol=1e-6, atol=1e-6)


def test_adamw_first_step_is_signed_lr():
    init, update = adamw(weight_decay=0.0)
    p = {"w": torch.tensor([1.0, -1.0])}
    g = {"w": torch.tensor([0.3, -0.7])}
    u, _ = update(g, init(p), p, lr=0.01)
    np.testing.assert_allclose(u["w"].numpy(), [-0.01, 0.01], rtol=1e-4)


def test_adamw_converges_quadratic():
    init, update = adamw(weight_decay=0.0)
    p = {"w": torch.tensor([5.0, -3.0])}
    st = init(p)
    for _ in range(300):
        u, st = update({"w": 2 * p["w"]}, st, p, lr=0.05)
        p = apply_updates(p, u)
    assert float(p["w"].abs().max()) < 0.1


def test_reduce_lr_on_plateau():
    s = ReduceLROnPlateau(base_lr=1.0, factor=0.5, patience=2)
    assert s.step(1.0) == 1.0
    assert s.step(0.9) == 1.0       # improving
    assert s.step(0.95) == 1.0      # wait 1
    assert s.step(0.95) == 0.5      # plateau -> halve
    assert s.step(0.95) == 0.5


def test_cosine_schedule_shape_and_equal_to_jax():
    from repro.train.optimizer import cosine_schedule as j_cos
    lr, jlr = cosine_schedule(1.0, warmup=10, total=110), j_cos(1.0, warmup=10, total=110)
    assert lr(0) == 0.0
    assert lr(10) == pytest.approx(1.0)
    assert lr(110) == pytest.approx(0.1)
    assert lr(60) < lr(20)
    assert [lr(s) for s in range(0, 120, 7)] == [jlr(s) for s in range(0, 120, 7)]


# --- train step factory ------------------------------------------------------

def _quad_loss(params, batch):
    pred = batch["x"] @ params["w"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"dbg": loss}


def _setup_step(ga, compression=None):
    opt_init, opt_update = sgd(momentum=0.0)
    step = make_train_step(_quad_loss, opt_update,
                           StepConfig(grad_accum=ga, compression=compression))
    params = {"w": torch.ones((4, 3))}
    return step, params, opt_init(params), {"w": None}


def _quad_batch():
    rng = np.random.RandomState(0)
    return rng.randn(8, 4).astype(np.float32), rng.randn(8, 3).astype(np.float32)


def test_grad_accum_equivalence():
    x, y = _quad_batch()
    batch = {"x": _t(x), "y": _t(y)}
    outs = []
    for ga in (1, 2, 4):
        step, params, opt, masks = _setup_step(ga)
        p2, _, _, metrics = step(params, opt, masks, None, batch, 0.1)
        outs.append(p2["w"].numpy())
        assert set(metrics) == {"dbg", "loss", "grad_norm"}
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-5)


@pytest.mark.parametrize("ga,compression", [(1, None), (2, None), (1, "topk"), (1, "int8")])
def test_train_step_matches_jax(ga, compression):
    """The port's step against the JAX package's ``make_train_step`` on the
    same quadratic problem: params, loss and grad norm."""
    from repro.train.loop import StepConfig as JStepConfig, make_train_step as j_make

    def jloss(params, batch):
        loss = jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
        return loss, {"dbg": loss}

    x, y = _quad_batch()
    cfg = dict(grad_accum=ga, compression=compression, compression_frac=0.25)
    jstep = j_make(jloss, j_sgd(momentum=0.9)[1], JStepConfig(**cfg), donate=False)
    tstep = make_train_step(_quad_loss, sgd(momentum=0.9)[1], StepConfig(**cfg))
    w0 = np.linspace(-1, 1, 12, dtype=np.float32).reshape(4, 3)
    mask = np.ones((4, 3), np.float32)
    mask[1] = 0.0
    jp, tp = {"w": jnp.asarray(w0)}, {"w": _t(w0)}
    jo, to = j_sgd(momentum=0.9)[0](jp), sgd(momentum=0.9)[0](tp)
    je = JCOMP.zeros_like_f32(jp) if compression else None
    te = COMP.zeros_like_f32(tp) if compression else None
    for _ in range(3):
        jp, jo, je, jm = jstep(jp, jo, {"w": jnp.asarray(mask)}, je,
                               {"x": jnp.asarray(x), "y": jnp.asarray(y)}, 0.1)
        tp, to, te, tm = tstep(tp, to, {"w": _t(mask)}, te, {"x": _t(x), "y": _t(y)}, 0.1)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert bool(torch.all(tp["w"][1] == 0.0))


def test_masks_keep_pruned_at_zero():
    step, params, opt, _ = _setup_step(1)
    masks = {"w": torch.ones((4, 3))}
    masks["w"][0] = 0.0
    batch = {"x": torch.ones((8, 4)), "y": torch.zeros((8, 3))}
    p, opt, _, m = step(params, opt, masks, None, batch, 0.1)
    assert bool(torch.all(p["w"][0] == 0.0))
    p, *_ = step(p, opt, masks, None, batch, 0.1)
    assert bool(torch.all(p["w"][0] == 0.0))


def test_compression_error_feedback_conservation():
    g = {"w": torch.tensor([[1.0, -0.1, 0.01, 3.0]])}
    e = COMP.zeros_like_f32(g)
    kept, e2 = COMP.topk_compress(g, e, frac=0.5)
    np.testing.assert_allclose((kept["w"] + e2["w"]).numpy(), g["w"].numpy(), rtol=1e-6)
    assert int(torch.sum(kept["w"] != 0)) == 2
    kept2, _ = COMP.topk_compress(g, e2, frac=0.5)       # error re-enters next round
    assert float(kept2["w"].abs().sum()) > float(kept["w"].abs().sum()) - 1e-6


def test_int8_compression_bounded_error_and_equal_to_jax():
    rng = np.random.RandomState(1)
    gn = rng.randn(64).astype(np.float32)
    deq, e2 = COMP.int8_compress({"w": _t(gn)}, COMP.zeros_like_f32({"w": _t(gn)}))
    jdeq, je2 = JCOMP.int8_compress({"w": jnp.asarray(gn)},
                                    JCOMP.zeros_like_f32({"w": jnp.asarray(gn)}))
    scale = float(np.abs(gn).max()) / 127
    assert float(e2["w"].abs().max()) <= scale
    np.testing.assert_allclose((deq["w"] + e2["w"]).numpy(), gn, rtol=1e-5)
    np.testing.assert_allclose(deq["w"].numpy(), np.asarray(jdeq["w"]), rtol=1e-6, atol=1e-7)


def test_run_epochs_with_callbacks_and_watchdog():
    step, params, opt, masks = _setup_step(1)
    x, y = _quad_batch()
    seen = []

    def batches():
        while True:
            yield {"x": _t(x), "y": _t(y)}

    def on_epoch_start(epoch, params, masks):
        seen.append(epoch)
        return masks

    params, opt, masks, _, hist = run_epochs(
        params=params, opt_state=opt, masks=masks, step_fn=step,
        batches_per_epoch=3, epochs=2, batch_iter=batches(), lr_fn=lambda s: 0.05,
        callbacks=EpochCallbacks(on_epoch_start=on_epoch_start),
        watchdog=StepWatchdog())
    assert seen == [0, 1] and len(hist) == 2 and hist[1] < hist[0]


# --- checkpointing -----------------------------------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3), "none": None},
            "step_count": torch.tensor(7)}
    for s in (10, 20, 30, 40):
        CKPT.save(str(tmp_path), s, tree, keep=2)
    assert CKPT.all_steps(str(tmp_path)) == [30, 40]
    assert CKPT.latest_step(str(tmp_path)) == 40
    restored, meta = CKPT.restore(str(tmp_path), tree)
    assert meta["step"] == 40
    np.testing.assert_array_equal(restored["params"]["w"], tree["params"]["w"].numpy())
    assert restored["params"]["none"] is None
    on_dev, _ = CKPT.restore(str(tmp_path), tree, device="cpu")
    assert isinstance(on_dev["params"]["w"], torch.Tensor)
    assert torch.equal(on_dev["params"]["w"], tree["params"]["w"])


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    CKPT.save(str(tmp_path), 1, {"w": torch.ones((2, 2))})
    with pytest.raises(ValueError):
        CKPT.restore(str(tmp_path), {"w": torch.ones((3, 3))})


def test_checkpoint_atomic_no_partial_dirs(tmp_path):
    CKPT.save(str(tmp_path), 5, {"w": torch.ones(3)})
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def _model_tree():
    """A params tree plus an SGD state (a named tuple) — the shapes a
    trainer checkpoints."""
    rs = np.random.RandomState(4)
    params = {"conv0": {"w": rs.randn(3, 3, 3, 8).astype(np.float32)},
              "bn0": {"scale": rs.rand(8).astype(np.float32),
                      "bias": rs.randn(8).astype(np.float32)},
              "fc": {"w": rs.randn(8, 10).astype(np.float32), "b": np.zeros(10, np.float32)}}
    return params


def test_checkpoints_interchange_with_jax_package(tmp_path):
    """A checkpoint the JAX package writes restores with the port's
    ``restore`` to equal arrays, and the reverse — named-tuple optimizer
    state included."""
    from repro.train.optimizer import SGDState as JSGDState
    from repro_torch.train.optimizer import SGDState
    params = _model_tree()
    jtree = {"params": jax.tree.map(jnp.asarray, params),
             "opt": JSGDState(jax.tree.map(lambda a: jnp.asarray(a) * 2, params)),
             "step": jnp.asarray(3)}
    ttree = {"params": jax.tree.map(_t, params),
             "opt": SGDState(jax.tree.map(lambda a: _t(a) * 2, params)),
             "step": torch.tensor(3)}
    JCK.save(str(tmp_path / "j"), 7, jtree, extra_meta={"who": "jax"})
    got, meta = CKPT.restore(str(tmp_path / "j"), ttree)
    assert meta["step"] == 7 and meta["who"] == "jax"
    assert isinstance(got["opt"], SGDState)
    CKPT.save(str(tmp_path / "t"), 8, ttree)
    back, meta2 = JCK.restore(str(tmp_path / "t"), jtree)
    assert meta2["step"] == 8
    for a, b, c in zip(jax.tree.leaves(jtree), jax.tree.leaves(back),
                       jax.tree.leaves(jax.tree.map(np.asarray, got))):
        np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(np.asarray(a), c)
    assert sorted(CKPT.load_flat(str(tmp_path / "j"))[0]) == \
        sorted(JCK.load_flat(str(tmp_path / "t"))[0])


def test_truncated_checkpoint_skipped_with_warning(tmp_path):
    d = str(tmp_path)
    tree = {"w": np.arange(12.0).reshape(3, 4)}
    CKPT.save(d, 1, tree)
    CKPT.save(d, 2, {"w": tree["w"] + 1})
    npz = os.path.join(d, "step_0000000002", "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    assert not CKPT.verify_step(d, 2) and CKPT.verify_step(d, 1)
    with pytest.warns(UserWarning, match="skipping corrupt"):
        restored, meta = CKPT.restore(d, tree)
    assert meta["step"] == 1
    np.testing.assert_array_equal(restored["w"], tree["w"])
    with pytest.raises(CKPT.CorruptCheckpointError):
        CKPT.restore(d, tree, step=2)


def test_signal_save_chains_and_is_idempotent():
    calls = []
    prev = signal.getsignal(signal.SIGUSR1)
    signal.signal(signal.SIGUSR1, lambda s, f: calls.append("prev"))
    try:
        CKPT.install_signal_save(lambda: calls.append("a"), signals=(signal.SIGUSR1,))
        CKPT.install_signal_save(lambda: calls.append("b"), signals=(signal.SIGUSR1,))
        with pytest.raises(SystemExit):
            signal.getsignal(signal.SIGUSR1)(signal.SIGUSR1, None)
        assert calls == ["b", "prev"]
    finally:
        CKPT.uninstall_signal_save(signals=(signal.SIGUSR1,))
        assert signal.getsignal(signal.SIGUSR1) is not None
        signal.signal(signal.SIGUSR1, prev)


def test_watchdog_flags_stragglers():
    t = [0.0]
    wd = StepWatchdog(factor=3.0, clock=lambda: t[0])
    for dt in (1.0, 1.0, 1.0):
        wd.start(); t[0] += dt
        assert wd.stop() is False
    wd.start(); t[0] += 10.0
    assert wd.stop() is True
    assert wd.straggler_events == 1
    wd.start(); t[0] += 1.0            # EMA not poisoned by the slow step
    assert wd.stop() is False


# --- CnnServer snapshot -> warm restart (tests/test_resilience.py:348, :373) --

N_CU = 4


@pytest.fixture(scope="module")
def tiny():
    cfg = JC.ResNetConfig(stages=(1, 1), widths=(8, 16), image_size=16)
    params, state = JC.init(jax.random.PRNGKey(0), cfg)
    params = jax.tree_util.tree_map_with_path(
        lambda p, l: l / jnp.std(l) * 0.1 if JC.is_conv_weight(p, l) else l, params)
    specs = JC.conv_group_specs(params, N_CU)
    hcfg = JH.HAPMConfig(0.5, 1)
    st = JH.hapm_epoch_update(JH.hapm_init(specs, hcfg), specs, params, hcfg)
    pruned = JM.apply_masks(params, JH.hapm_element_masks(specs, st))
    tp, ts = TC.params_from_numpy(jax.tree.map(np.asarray, pruned),
                                  jax.tree.map(np.asarray, state), device="cpu")
    return TC.ResNetConfig(stages=(1, 1), widths=(8, 16), image_size=16), tp, ts


def _x(n=2, seed=0):
    return np.random.RandomState(seed).rand(n, 16, 16, 3).astype(np.float32)


def _server(tiny, spec, **kw):
    cfg, params, state = tiny
    return CnnServer(params, state, cfg, spec=spec, buckets=(1,), device="cpu", **kw)


def test_snapshot_warm_restart_and_mismatch_fallback(tiny, tmp_path):
    spec = TC.ExecSpec(quantized=True, n_cu=N_CU)
    srv = _server(tiny, spec)
    path = srv.snapshot(str(tmp_path), step=5)
    assert os.path.isdir(path)
    warm = _server(tiny, spec, snapshot_dir=str(tmp_path))
    assert warm.mask_fp == srv.mask_fp
    assert warm.group_masks.keys() == srv.group_masks.keys()
    x = _x(1, seed=3)
    assert torch.equal(warm.infer(x), srv.infer(x))
    # a snapshot for a different spec is refused (derive fresh + warn)
    with pytest.warns(UserWarning, match="does not match"):
        other = _server(tiny, TC.ExecSpec(n_cu=N_CU), snapshot_dir=str(tmp_path))
    assert other.mask_fp == _server(tiny, TC.ExecSpec(n_cu=N_CU)).mask_fp
    # an empty dir warns and derives fresh
    with pytest.warns(UserWarning, match="no server snapshot"):
        _server(tiny, spec, snapshot_dir=str(tmp_path / "nowhere"))


def test_snapshot_fingerprint_integrity_check(tiny, tmp_path):
    spec = TC.ExecSpec(n_cu=N_CU)
    srv = _server(tiny, spec)
    srv.snapshot(str(tmp_path), step=1)
    man = os.path.join(str(tmp_path), "step_0000000001", "manifest.json")
    with open(man) as f:
        meta = json.load(f)
    meta["mask_fp"] = "deadbeef"
    with open(man, "w") as f:
        json.dump(meta, f)
    with pytest.warns(UserWarning, match="integrity"):
        warm = _server(tiny, spec, snapshot_dir=str(tmp_path))
    assert warm.mask_fp == srv.mask_fp      # derived fresh, still correct
    assert warm.resilience["mask_repairs"] == 1


def test_snapshot_files_equal_jax_servers(tiny, tmp_path):
    """The port's snapshot and the JAX server's snapshot of the same
    weights hold the same masks and fingerprints, and each package warm
    starts from the other's."""
    from repro.launch.serve_cnn import CnnServer as JServer
    cfg, tp, ts = tiny
    jcfg = JC.ResNetConfig(stages=(1, 1), widths=(8, 16), image_size=16)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    js = jax.tree.map(lambda t: jnp.asarray(t.numpy()), ts)
    jsrv = JServer(jp, js, jcfg, spec=JC.ExecSpec(n_cu=N_CU), buckets=(1,))
    tsrv = _server(tiny, TC.ExecSpec(n_cu=N_CU))
    assert (jsrv.arch_fp, jsrv.mask_fp) == (tsrv.arch_fp, tsrv.mask_fp)
    jsrv.snapshot(str(tmp_path / "j"), step=2)
    tsrv.snapshot(str(tmp_path / "t"), step=2)
    jflat, jmeta = JCK.load_flat(str(tmp_path / "j"))
    tflat, tmeta = CKPT.load_flat(str(tmp_path / "t"))
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_array_equal(jflat[k], tflat[k])
    for key in ("kind", "arch_fp", "mask_fp", "spec"):
        assert jmeta[key] == tmeta[key]
    warm = _server(tiny, TC.ExecSpec(n_cu=N_CU), snapshot_dir=str(tmp_path / "j"))
    assert warm.mask_fp == jsrv.mask_fp and warm.resilience["mask_repairs"] == 0
