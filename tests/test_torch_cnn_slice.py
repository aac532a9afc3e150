"""Port vs JAX package: the serving slice as a whole (``models/cnn.py``) —
BN folding, the folded dataflows, ``bind_execution`` under the streamed
int8 contract, accounting reports and the ``ExecSpec`` contract table.

Weights are made once with the JAX package's ``init`` (+ HAPM), converted
with ``np.asarray`` and handed to both sides; BN folding is done once (in
JAX) and the *same folded arrays* go to both binds, so per-channel
calibration sees identical inputs. The port binds with ``device="cpu"``
(plain PyTorch versions of the kernels); JAX runs Pallas in interpret mode.

Tolerances: every bound int8 layer is exact integer arithmetic, so with
every layer bound (``dense_fallback=2.0``) the two packages' logits differ
only through the head's mean + matmul: <= 1e-6. f32 paths: <= 1e-5
(summation order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import hapm as JH, masks as JM
from repro.models import cnn as JC
from repro_torch.models import cnn as TC

CFG_KW = dict(stages=(1, 1), widths=(8, 16), image_size=16)
N_CU = 4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JC.ResNetConfig(**CFG_KW), TC.ResNetConfig(**CFG_KW)
    params, state = JC.init(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(0)
    # non-trivial BN statistics so that folding rescales channels
    state = jax.tree.map(lambda a: jnp.asarray(
        rs.uniform(0.5, 1.5, a.shape).astype(np.float32)), state)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.asarray(rs.uniform(0.5, 1.5, a.shape).astype(np.float32))
                      if p[-1].key == "scale" else a), params)
    specs = JC.conv_group_specs(params, N_CU)
    hcfg = JH.HAPMConfig(0.5, 1)
    st = JH.hapm_epoch_update(JH.hapm_init(specs, hcfg), specs, params, hcfg)
    params = JM.apply_masks(params, JH.hapm_element_masks(specs, st))
    jfold = JC.fold_batchnorm(params, state, jcfg)
    tparams, tstate = TC.params_from_numpy(jax.tree.map(np.asarray, params),
                                           jax.tree.map(np.asarray, state), device="cpu")
    tfold = TC.tree_from_numpy(jax.tree.map(np.asarray, jfold), device="cpu")
    x = rs.rand(3, 16, 16, 3).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params, js=state, jfold=jfold,
                tp=tparams, ts=tstate, tfold=tfold, x=x)


def test_fold_batchnorm_matches(model):
    tfold = TC.fold_batchnorm(model["tp"], model["ts"], model["tcfg"])
    flat_j = jax.tree_util.tree_flatten_with_path(model["jfold"])[0]
    for path, a in flat_j:
        b = tfold
        for k in path:
            b = b[k.key]
        # the port takes 1/sqrt (same bits on CPU and GPU), JAX rsqrt: 1-2 ulp
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    # folding preserves zero groups exactly: HAPM masks survive
    for path, a in flat_j:
        if a.ndim == 4:
            b = tfold
            for k in path:
                b = b[k.key]
            np.testing.assert_array_equal(b.numpy() == 0, np.asarray(a) == 0)


def test_apply_dense_matches(model):
    jy, _ = JC.apply(model["jp"], model["js"], jnp.asarray(model["x"]), model["jcfg"])
    ty, st = TC.apply(model["tp"], model["ts"], _t(model["x"]), model["tcfg"])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    assert st is model["ts"]


def test_apply_folded_dense_matches(model):
    jy = JC.apply_folded(model["jfold"], jnp.asarray(model["x"]), model["jcfg"])
    ty = TC.apply_folded(model["tfold"], _t(model["x"]), model["tcfg"])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    # folded == unfolded on the port itself
    ty2, _ = TC.apply(model["tp"], model["ts"], _t(model["x"]), model["tcfg"])
    np.testing.assert_allclose(ty.numpy(), ty2.numpy(), atol=1e-4)


def _bind_both(model, folded=True, **kw):
    jspec, tspec = JC.ExecSpec(n_cu=N_CU, folded=folded, **kw), \
        TC.ExecSpec(n_cu=N_CU, folded=folded, **kw)
    jtree, ttree = (model["jfold"], model["tfold"]) if folded else (model["jp"], model["tp"])
    return (JC.bind_execution(jtree, model["jcfg"], spec=jspec),
            TC.bind_execution(ttree, model["tcfg"], spec=tspec, device="cpu"))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dsb", [False, True])
def test_streamed_logits_match_jax(model, packed, dsb):
    je, te = _bind_both(model, packed=packed, quantized=True, streamed=True,
                        activation_dsb=dsb, dense_fallback=2.0)
    assert all(v is not None for v in te.table.values())
    jy = JC.apply_folded(model["jfold"], jnp.asarray(model["x"]), model["jcfg"], sparse=je)
    ty = TC.apply_folded(model["tfold"], _t(model["x"]), model["tcfg"], sparse=te)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
    # every bound layer, fed the same frame codes, emits bit-equal codes
    codes = np.asarray(JC.Q.QuantSpec().act_codes(jnp.asarray(model["x"])))
    for path in [("conv0", "w")]:
        np.testing.assert_array_equal(
            te.table[path](_t(codes), stride=1).numpy(),
            np.asarray(je.table[path](jnp.asarray(codes), stride=1)))


@pytest.mark.parametrize("packed", [False, True])
def test_streamed_equals_own_wire_reference_exactly(model, packed):
    tcfg = model["tcfg"]
    kw = dict(n_cu=N_CU, packed=packed, quantized=True, folded=True, dense_fallback=2.0)
    streamed = TC.bind_execution(model["tfold"], tcfg, device="cpu",
                                 spec=TC.ExecSpec(streamed=True, activation_dsb=True, **kw))
    plain_q = TC.bind_execution(model["tfold"], tcfg, device="cpu", spec=TC.ExecSpec(**kw))
    x = _t(model["x"])
    ys = TC.apply_folded(model["tfold"], x, tcfg, sparse=streamed)
    yr = TC.apply_folded(model["tfold"], x, tcfg, sparse=plain_q, wire_quantize=True)
    assert torch.equal(ys, yr)
    # and the float dataflow of the quantized exec is a different (f32-wire) answer
    yf = TC.apply_folded(model["tfold"], x, tcfg, sparse=plain_q)
    assert yf.dtype == torch.float32 and tuple(yf.shape) == (3, 10)


def test_default_fallback_chain_matches_jax(model):
    """Default ``dense_fallback``: dense library-conv layers sit in the
    chain. Their f32 sums feed a requantize, so a summation-order difference
    could flip a code (1/16) — on this seeded input none does, and the
    logits agree to the head's tolerance."""
    je, te = _bind_both(model, quantized=True, streamed=True)
    assert [v is None for v in je.table.values()] == [v is None for v in te.table.values()]
    jy = JC.apply_folded(model["jfold"], jnp.asarray(model["x"]), model["jcfg"], sparse=je)
    ty = TC.apply_folded(model["tfold"], _t(model["x"]), model["tcfg"], sparse=te)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_folded_f32_and_quantized_execs_match_jax(model, quantized):
    je, te = _bind_both(model, packed=False, quantized=quantized, dense_fallback=2.0)
    jy = JC.apply_folded(model["jfold"], jnp.asarray(model["x"]), model["jcfg"], sparse=je)
    ty = TC.apply_folded(model["tfold"], _t(model["x"]), model["tcfg"], sparse=te)
    # f32 wire between layers: <= 1e-5 (summation order; 1-ulp epilogue on int8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_plain_exec_through_apply(model, quantized):
    jcfg = dataclasses.replace(model["jcfg"], quantized=quantized)
    tcfg = dataclasses.replace(model["tcfg"], quantized=quantized)
    je, te = _bind_both(model, folded=False, packed=False, quantized=quantized,
                        dense_fallback=2.0)
    ty, _ = TC.apply(model["tp"], model["ts"], _t(model["x"]), tcfg, sparse=te)
    td, _ = TC.apply(model["tp"], model["ts"], _t(model["x"]), tcfg)
    if quantized:
        # executed int8 == the fake-quant dense forward, exactly (both sums
        # are exact integers below 2^24)
        assert torch.equal(ty, td)
    else:
        np.testing.assert_allclose(ty.numpy(), td.numpy(), atol=1e-5)
        jy, _ = JC.apply(model["jp"], model["js"], jnp.asarray(model["x"]), jcfg, sparse=je)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    # sparse=True memoizes a bind on the params' identity
    t1, _ = TC.apply(model["tp"], model["ts"], _t(model["x"]), tcfg, sparse=True)
    np.testing.assert_allclose(t1.numpy(), td.numpy(), atol=1e-5)
    assert (id(model["tp"]), quantized) in TC._SPARSE_EXEC_CACHE


REPORT_SPECS = [
    dict(packed=True, quantized=True, folded=True, streamed=True, activation_dsb=True),
    dict(packed=False, quantized=True, folded=True, streamed=True, dense_fallback=2.0),
    dict(packed=True, folded=True, implicit=False, bm=64),
    dict(packed=False, quantized=True, folded=True),
]


@pytest.mark.parametrize("kw", REPORT_SPECS, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
@pytest.mark.parametrize("batch", [1, 8])
def test_report_dicts_equal(model, kw, batch):
    je, te = _bind_both(model, **kw)
    jr = je.report(model["jcfg"], batch=batch, per_layer=True)
    tr = te.report(model["tcfg"], batch=batch, per_layer=True)
    assert jr == tr
    assert je.step_counts(model["jcfg"], batch) == te.step_counts(model["tcfg"], batch)
    assert je.schedule_step_counts() == te.schedule_step_counts()
    assert je.mac_utilization(model["jcfg"], batch) == te.mac_utilization(model["tcfg"], batch)
    assert je.hbm_bytes(model["jcfg"], batch) == te.hbm_bytes(model["tcfg"], batch)
    assert te.spec == TC.ExecSpec(n_cu=N_CU, **kw)


def test_accounting_only_bind_needs_no_device(model):
    te = TC.bind_execution(model["tfold"], model["tcfg"], bind_kernels=False,
                           spec=TC.ExecSpec(n_cu=N_CU, folded=True, packed=False))
    je = JC.bind_execution(model["jfold"], model["jcfg"], bind_kernels=False,
                           spec=JC.ExecSpec(n_cu=N_CU, folded=True, packed=False))
    assert all(v is None for v in te.table.values())
    assert je.report(model["jcfg"], batch=4) == te.report(model["tcfg"], batch=4)


def test_measured_dsb_skip_equal(model):
    x = model["x"].copy()
    x[0] = 0.0
    je, te = _bind_both(model, packed=True, quantized=True, streamed=True,
                        activation_dsb=True, dense_fallback=2.0)
    jm = je.measure_dsb_skip(model["jfold"], jnp.asarray(x), model["jcfg"])
    tm = te.measure_dsb_skip(model["tfold"], _t(x), model["tcfg"])
    assert jm == tm and tm["dsb_skipped_steps"] > 0
    jr = je.report(model["jcfg"], batch=3, dsb_sample=jnp.asarray(x), dsb_tree=model["jfold"])
    tr = te.report(model["tcfg"], batch=3, dsb_sample=_t(x), dsb_tree=model["tfold"])
    assert jr == tr


INVALID_SPECS = [
    dict(bm="big"), dict(n_cu=0), dict(trainable=True, quantized=True),
    dict(trainable=True, folded=True), dict(streamed=True),
    dict(streamed=True, quantized=True), dict(activation_dsb=True),
    dict(activation_dsb=True, quantized=True, implicit=False),
    dict(trainable=True, streamed=True, activation_dsb=True, bm=1.5, n_cu=-1),
]


@pytest.mark.parametrize("kw", INVALID_SPECS, ids=lambda k: "+".join(k))
def test_exec_spec_contract_table_same_messages(kw):
    with pytest.raises(ValueError) as je:
        JC.ExecSpec(**kw)
    with pytest.raises(ValueError) as te:
        TC.ExecSpec(**kw)
    assert str(je.value) == str(te.value)


def test_exec_spec_is_the_same_key():
    kw = dict(packed=False, quantized=True, folded=True, streamed=True,
              activation_dsb=True, dense_fallback=2.0, n_cu=N_CU)
    assert repr(JC.ExecSpec(**kw)) == repr(TC.ExecSpec(**kw))
    assert hash(TC.ExecSpec(**kw)) == hash(TC.ExecSpec(**kw))
    assert [f.name for f in dataclasses.fields(JC.ExecSpec)] == \
        [f.name for f in dataclasses.fields(TC.ExecSpec)]


def test_bind_errors_and_staleness(model):
    tcfg = model["tcfg"]
    assert issubclass(TC.PermanentBindError, (TC.BindError, ValueError))
    assert issubclass(TC.TransientBindError, TC.BindError)
    with pytest.raises(TC.PermanentBindError, match="plain-exec only"):
        TC.bind_execution(model["tfold"], tcfg, spec=TC.ExecSpec(folded=True),
                          quant_spec=TC.Q.QuantSpec(), device="cpu")
    with pytest.raises(TC.PermanentBindError, match="silently ignored"):
        TC.bind_execution(model["tp"], tcfg, quant_spec=TC.Q.QuantSpec(), device="cpu")
    with pytest.raises(TC.PermanentBindError, match="concrete torch tensors"):
        TC.bind_execution(jax.tree.map(np.asarray, model["jp"]), tcfg, device="cpu")
    # trainable binds prepack nothing, so they are never stale
    texec = TC.bind_execution(model["tp"], tcfg, spec=TC.ExecSpec(trainable=True),
                              device="cpu")
    assert texec.trainable and texec.bound_weights is None
    _, new_state = TC.apply(model["tp"], model["ts"], _t(model["x"]), tcfg, train=True)
    assert new_state is not model["ts"] and set(new_state) == set(model["ts"])
    folded = TC.bind_execution(model["tfold"], tcfg, device="cpu",
                               spec=TC.ExecSpec(folded=True, n_cu=N_CU))
    with pytest.raises(ValueError, match="consume it with apply_folded"):
        TC.apply(model["tp"], model["ts"], _t(model["x"]), tcfg, sparse=folded)
    plain = TC.bind_execution(model["tp"], tcfg, device="cpu",
                              spec=TC.ExecSpec(packed=False, n_cu=N_CU))
    with pytest.raises(ValueError, match="needs a folded SparseConvExec"):
        TC.apply_folded(model["tfold"], _t(model["x"]), tcfg, sparse=plain)
    with pytest.raises(ValueError, match="cfg.quantized=True"):
        TC.apply(model["tp"], model["ts"], _t(model["x"]),
                 dataclasses.replace(tcfg, quantized=True), sparse=plain)
    stale = {**model["tp"], "conv0": {"w": model["tp"]["conv0"]["w"].clone()}}
    with pytest.raises(ValueError, match="is stale for conv0/w"):
        TC.apply(stale, model["ts"], _t(model["x"]), tcfg, sparse=plain)
    with pytest.raises(TypeError, match="sparse must be"):
        TC.apply(model["tp"], model["ts"], _t(model["x"]), tcfg, sparse="yes")
    streamed = TC.bind_execution(model["tfold"], tcfg, device="cpu", spec=TC.ExecSpec(
        folded=True, quantized=True, streamed=True, n_cu=N_CU))
    with pytest.raises(ValueError, match="cannot be disabled"):
        TC.apply_folded(model["tfold"], _t(model["x"]), tcfg, sparse=streamed,
                        wire_quantize=False)
    with pytest.raises(ValueError, match="cannot ingest them"):
        TC.apply_folded(model["tfold"], _t(model["x"]), tcfg, sparse=folded,
                        wire_quantize=True)


def test_entry_points_default_to_the_gpu_and_raise_without_one(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA device and none is available"):
        TC.bind_execution(model["tfold"], model["tcfg"], spec=TC.ExecSpec(folded=True))
    with pytest.raises(RuntimeError, match="CUDA device and none is available"):
        TC.init(0, model["tcfg"])
    with pytest.raises(RuntimeError, match="CUDA device and none is available"):
        TC.params_from_numpy({"w": np.zeros(3, np.float32)})
    assert TC.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("stride", [1, 2])
def test_dense_conv_forward_and_backward_are_the_library_conv(stride):
    """The dense rung's CUDA convolution (``_DenseConv``: cuDNN off in the
    forward, on in full f32 in the backward) computes what ``F.conv2d`` and
    its autograd compute; on the CPU, bit for bit."""
    import torch.nn.functional as F
    rs = np.random.RandomState(stride)
    x = torch.from_numpy(rs.randn(2, 5, 9, 9).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rs.randn(7, 5, 3, 3).astype(np.float32)).requires_grad_()
    y = TC._DenseConv.apply(x, w, stride)
    y_ref = F.conv2d(x, w, stride=stride)
    g = torch.from_numpy(rs.randn(*y.shape).astype(np.float32))
    want = torch.autograd.grad(y_ref, (x, w), g)
    for got, ref in zip(torch.autograd.grad(y, (x, w), g), want):
        assert torch.equal(got, ref)
    assert torch.equal(y, y_ref)
    # only the weight wants a gradient (the first layer's input)
    gw, = torch.autograd.grad(TC._DenseConv.apply(x.detach(), w, stride), (w,), g)
    assert torch.equal(gw, want[1])


@pytest.mark.parametrize("shape", [(8, 8, 8, 16), (4, 4, 4, 64), (3, 5, 7, 3)])
def test_global_avg_pool_is_per_image_and_the_mean(shape):
    """The heads' pool: an image's value does not depend on the batch it is
    in, and equals the JAX head's ``jnp.mean`` over the spatial axes."""
    h = np.random.RandomState(0).rand(*shape).astype(np.float32)
    pooled = TC._global_avg_pool(torch.from_numpy(h))
    for b in (1, 2):
        assert torch.equal(TC._global_avg_pool(torch.from_numpy(h[:b])), pooled[:b])
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jnp.mean(h, axis=(1, 2))),
                               rtol=0, atol=1e-6)
