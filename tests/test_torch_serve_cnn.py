"""Port vs JAX package: the serving stack (``launch/exec_cache.py``,
``launch/resilience.py``, ``launch/serve_cnn.py``).

Both servers get the same weights (made by the JAX package, converted with
``np.asarray``) and the same request sequence; the port serves with
``device="cpu"``. Cache keys and counters, ladder walks, fault records and
shed accounting must be **equal**; logits agree to the head's tolerance
(<= 1e-6 for int8 rungs with every layer bound, <= 1e-5 otherwise)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from repro.core import hapm as JH, masks as JM
from repro.launch import exec_cache as JE, resilience as JR, serve_cnn as JS
from repro.models import cnn as JC
from repro_torch.launch import exec_cache as TE, resilience as TR, serve_cnn as TS
from repro_torch.models import cnn as TC

CFG_KW = dict(stages=(1, 1), widths=(8, 16), image_size=16)
N_CU = 4
BUCKETS = (1, 4, 8)
# the server's behaviour (cache, ladder, masks, shedding) does not depend on
# the tile layout: those tests bind the packed one, which the JAX side traces
# fastest; the one-group-per-tile layout is served once, below
STREAMED = dict(packed=True, quantized=True, folded=True, streamed=True,
                activation_dsb=True, dense_fallback=2.0, n_cu=N_CU)


def _pruned(sparsity, seed=0):
    cfg = JC.ResNetConfig(**CFG_KW)
    params, state = JC.init(jax.random.PRNGKey(seed), cfg)
    specs = JC.conv_group_specs(params, N_CU)
    hcfg = JH.HAPMConfig(sparsity, 1)
    st = JH.hapm_epoch_update(JH.hapm_init(specs, hcfg), specs, params, hcfg)
    params = JM.apply_masks(params, JH.hapm_element_masks(specs, st))
    tparams, tstate = TC.params_from_numpy(jax.tree.map(np.asarray, params),
                                           jax.tree.map(np.asarray, state), device="cpu")
    return (params, state), (tparams, tstate)


@pytest.fixture(scope="module")
def weights():
    return {s: _pruned(s) for s in (0.5, 0.7)}


def _servers(weights, spec_kw, sparsity=0.5, buckets=BUCKETS, **kw):
    (jp, js), (tp, ts) = weights[sparsity]
    jkw = {k: v for k, v in kw.items() if k not in ("tfaults", "jfaults")}
    jsrv = JS.CnnServer(jp, js, JC.ResNetConfig(**CFG_KW), spec=JC.ExecSpec(**spec_kw),
                        buckets=buckets, faults=kw.get("jfaults"), **jkw)
    tsrv = TS.CnnServer(tp, ts, TC.ResNetConfig(**CFG_KW), spec=TC.ExecSpec(**spec_kw),
                        buckets=buckets, faults=kw.get("tfaults"), device="cpu", **jkw)
    return jsrv, tsrv


def _frames(n, seed=1):
    return np.random.RandomState(seed).rand(n, 16, 16, 3).astype(np.float32)


# (the one-group-per-tile layout is the slow one to trace on the JAX side:
# one bucket there, three for the others)
@pytest.mark.parametrize("spec_kw,tol,buckets,sizes", [
    (dict(STREAMED, packed=False), 1e-6, (4,), (1, 4, 9, 3)),
    (STREAMED, 1e-6, BUCKETS, (1, 3, 8, 5, 20, 1)),
    (dict(n_cu=N_CU), 1e-5, BUCKETS, (1, 3, 8, 5, 20, 1))],
    ids=["streamed-unpacked", "streamed-packed", "default-f32"])
def test_bucketed_answers_and_cache_counts_equal_jax(weights, spec_kw, tol, buckets,
                                                     sizes):
    jsrv, tsrv = _servers(weights, spec_kw, buckets=buckets)
    assert (jsrv.arch_fp, jsrv.mask_fp) == (tsrv.arch_fp, tsrv.mask_fp)
    x = _frames(20)
    for n in sizes:                        # exact fit, padding, chunking
        jy, ty = np.asarray(jsrv.infer(x[:n])), tsrv.infer(x[:n])
        assert tuple(ty.shape) == (n, 10) and ty.dtype == torch.float32
        np.testing.assert_allclose(ty.numpy(), jy, atol=tol)
        assert jsrv.cache.stats() == tsrv.cache.stats()
    assert jsrv.stats() == tsrv.stats()
    assert [k[:2] + (repr(k[2]), k[3]) for k in jsrv.cache.keys()] == \
        [k[:2] + (repr(k[2]), k[3]) for k in tsrv.cache.keys()]
    # bucketed == an unbucketed forward of the same bind, bit for bit
    exec_ = tsrv._bind()
    xt = torch.from_numpy(x)
    if tsrv.spec.folded:
        direct = TC.apply_folded(tsrv._tree, xt, tsrv.run_cfg, sparse=exec_)
    else:
        direct = TC.apply(tsrv._tree, tsrv.state, xt, tsrv.run_cfg, sparse=exec_)[0]
    assert torch.equal(tsrv.infer(x), direct)
    assert tuple(tsrv.infer(x[:0]).shape) == (0, 10)


def test_update_masks_invalidation_equal_jax(weights):
    jsrv, tsrv = _servers(weights, STREAMED)
    x = _frames(8)
    for srv in (jsrv, tsrv):
        srv.warmup()
        srv.infer(x[:3])
    # a no-op update keeps every entry
    assert jsrv.update_masks(jsrv.params) == tsrv.update_masks(tsrv.params) == 0
    assert jsrv.cache.stats() == tsrv.cache.stats()
    # a HAPM epoch that pruned more groups drops exactly the stale entries
    (jp, js), (tp, ts) = weights[0.7]
    assert jsrv.update_masks(jp, js) == tsrv.update_masks(tp, ts) == len(BUCKETS)
    assert (jsrv.arch_fp, jsrv.mask_fp) == (tsrv.arch_fp, tsrv.mask_fp)
    np.testing.assert_allclose(tsrv.infer(x).numpy(), np.asarray(jsrv.infer(x)), atol=1e-6)
    assert jsrv.cache.stats() == tsrv.cache.stats()
    assert jsrv.report(batch=4) == tsrv.report(batch=4)


def test_ladder_walk_under_seeded_faults_equal_jax(weights):
    plan = dict(seed=3, bind_fail_calls=(0, 1, 2), nonfinite_calls=(1,),
                mask_corrupt_calls=(0,), sleep=lambda s: None)
    policy_kw = dict(max_bind_retries=2, bind_backoff_s=0.0, promote_after_clean=2)
    jsrv, tsrv = _servers(weights, STREAMED, jfaults=JR.FaultPlan(**plan),
                          tfaults=TR.FaultPlan(**plan))
    jsrv.policy = JR.ServePolicy(**policy_kw)
    tsrv.policy = TR.ServePolicy(**policy_kw)
    x = _frames(8)
    levels = []
    for n in (2, 8, 1, 4, 4, 4, 4):
        jy, ty = np.asarray(jsrv.infer(x[:n])), tsrv.infer(x[:n]).numpy()
        assert np.isfinite(ty).all()
        assert jsrv.last_request_level == tsrv.last_request_level
        levels.append(tsrv.last_request_level)
        np.testing.assert_allclose(ty, jy, atol=1e-5)
        assert jsrv.resilience == tsrv.resilience
    assert jsrv.degrade_log == tsrv.degrade_log and tsrv.degrade_log
    assert jsrv.faults.record == tsrv.faults.record
    assert jsrv.faults.injected == tsrv.faults.injected
    assert max(levels) >= 1 and tsrv.resilience["promotions"] >= 1
    assert tsrv.resilience["mask_repairs"] == 1
    assert [TR.rung_name(r) for r in tsrv.rungs] == ["streamed", "quantized", "f32", "dense"]
    assert jsrv.stats() == tsrv.stats()


@pytest.mark.parametrize("level,tol", [(0, 1e-6), (1, 1e-5), (2, 1e-5), (3, 1e-5)])
def test_forced_rungs_match_jax(weights, level, tol):
    jsrv, tsrv = _servers(weights, STREAMED)
    jsrv.force_level(level)
    tsrv.force_level(level)
    x = _frames(5)
    np.testing.assert_allclose(tsrv.infer(x).numpy(), np.asarray(jsrv.infer(x)), atol=tol)
    assert tsrv.last_request_level == level == tsrv.level
    with pytest.raises(ValueError, match="level must be in"):
        tsrv.force_level(9)


def test_nonfinite_on_every_rung_raises(weights):
    _, tsrv = _servers(weights, STREAMED,
                       tfaults=TR.FaultPlan(nonfinite_rate=1.0))
    with pytest.raises(TR.NonFiniteOutputError):
        tsrv.infer(_frames(2))
    assert tsrv.resilience["nonfinite_caught"] == 4 and tsrv.cache.quarantined == 3


def test_admission_deadline_and_validation(weights):
    (_, _), (tp, ts) = weights[0.5]
    mk = lambda **pol: TS.CnnServer(tp, ts, TC.ResNetConfig(**CFG_KW),
                                    spec=TC.ExecSpec(**STREAMED), buckets=BUCKETS,
                                    policy=TR.ServePolicy(**pol), device="cpu")
    with pytest.raises(TR.OverloadError):
        mk(max_request_images=4).infer(_frames(5))
    srv = mk(max_request_images=4, overload_action="degrade")
    srv.infer(_frames(5))
    assert srv.last_request_level == 1 and srv.resilience["overload_downgrades"] == 1
    with pytest.raises(TR.DeadlineExceeded):
        srv2 = mk()
        srv2._svc_ema[8] = 10.0
        srv2.infer(_frames(8), deadline_s=0.001)
    with pytest.raises(ValueError, match="expects images shaped"):
        mk().infer(np.zeros((2, 8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="floating-point frames"):
        mk().infer(np.zeros((2, 16, 16, 3), np.uint8))


def test_simulate_trace_shed_accounting_equal_jax(weights):
    rs = np.random.RandomState(5)
    trace = [(float(t), int(n)) for t, n in
             zip(np.cumsum(rs.exponential(0.002, 60)), rs.randint(1, 6, 60))]
    svc = lambda b: 0.001 * b
    jb = JE.BucketBatcher(BUCKETS, max_wait_s=0.004, max_pending_images=12)
    tb = TE.BucketBatcher(BUCKETS, max_wait_s=0.004, max_pending_images=12)
    jr = JS.simulate_trace(jb, trace, svc, deadline_s=0.003)
    tr = TS.simulate_trace(tb, trace, svc, deadline_s=0.003)
    assert jr == tr and tr["shed"] > 0 and tr["requests"] + tr["shed"] == 60
    # with the real server in the loop: outputs per request, equal rungs
    jsrv, tsrv = _servers(weights, STREAMED)
    frames = lambda rid, n: _frames(n, seed=rid)
    jr = JS.simulate_trace(JE.BucketBatcher(BUCKETS, 0.004), trace[:12], svc,
                           server=jsrv, images_fn=frames)
    tr = TS.simulate_trace(TE.BucketBatcher(BUCKETS, 0.004), trace[:12], svc,
                           server=tsrv, images_fn=frames)
    assert jr["rungs"] == tr["rungs"] and jr["releases"] == tr["releases"]
    for rid, y in tr["outputs"].items():
        np.testing.assert_allclose(y, jr["outputs"][rid], atol=1e-6)


@pytest.mark.parametrize("batch,want", [(1, 1), (2, 4), (4, 4), (5, 8), (8, 8)])
def test_bucket_for_equal(batch, want):
    assert TE.bucket_for(batch, BUCKETS) == JE.bucket_for(batch, BUCKETS) == want
    with pytest.raises(ValueError):
        TE.bucket_for(9, BUCKETS)


def test_degradation_ladder_equal():
    for kw in (STREAMED, dict(quantized=True, folded=True, activation_dsb=True), dict()):
        jl = JR.degradation_ladder(JC.ExecSpec(**kw))
        tl = TR.degradation_ladder(TC.ExecSpec(**kw))
        assert [repr(r) for r in jl] == [repr(r) for r in tl]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TC.TransientBindError("again")
        return "bound"
    assert TR.retry_bind(flaky, retries=2, sleep=lambda s: None) == "bound"
    with pytest.raises(TC.PermanentBindError):
        TR.retry_bind(lambda: (_ for _ in ()).throw(TC.PermanentBindError("no")))


def test_no_silent_cpu_and_later_slices_raise(weights):
    (_, _), (tp, ts) = weights[0.5]
    cfg = TC.ResNetConfig(**CFG_KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device and none is available"):
            TS.CnnServer(tp, ts, cfg, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device and none is available"):
            TS.CnnServer(tp, ts, cfg)
        with pytest.raises(RuntimeError, match="CUDA device and none is available"):
            TS.main(["--requests", "1"])
    srv = TS.CnnServer(tp, ts, cfg, device="cpu")
    assert srv.device == torch.device("cpu")
    # the snapshot slice has landed: a missing snapshot warns and derives
    with pytest.warns(UserWarning, match="no server snapshot"):
        warm = TS.CnnServer(tp, ts, cfg, device="cpu", snapshot_dir="/nonexistent")
    assert warm.mask_fp == srv.mask_fp


@pytest.mark.parametrize("argv", [["--device", "cpu"],
                                  ["--device", "cpu", "--activation-dsb", "--requests", "3"],
                                  ["--device", "cpu", "--quantized", "--deadline-ms", "2"]],
                         ids=["f32", "dsb", "quantized-deadline"])
def test_main_smoke_on_cpu(argv, capsys):
    srv = TS.main(argv)
    out = capsys.readouterr().out
    assert "[warmup] 3 buckets, 1 bind(s)" in out and "[batcher]" in out
    assert srv.device == torch.device("cpu") and srv.cache.binds == 1
