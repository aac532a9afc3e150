"""Port vs JAX package: training the network through the block-sparse
kernels (``ExecSpec(trainable=True)``, train-mode ``cnn.apply``,
``train/cnn_training.py``, the ``launch/train_cnn.py`` entry point). The
trainable conv itself is held to JAX's in ``test_torch_trainable_conv.py``.

The same numpy inputs (and the JAX package's ``init`` weights, converted
with ``np.asarray``) go through both packages: JAX with the Pallas kernels
in interpret mode under its ``custom_vjp``s, the port with the plain
versions under its ``autograd.Function``s (CPU tensors). Tolerances: f32
gradients within 1e-4 (other summation orders, as the JAX package holds
its own sparse-vs-dense grads); one SGD step's params and BN state within
1e-5. Pruned groups' gradients and pruned weights are exactly 0.0.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import (HAPMConfig, apply_masks, hapm_element_masks,
                        hapm_epoch_update, hapm_init)
from repro.models import cnn as JC
from repro_torch.core import apply_masks as t_apply_masks
from repro_torch.core.masks import tree_flatten_with_path, tree_map
from repro_torch.data.synthetic import SyntheticCifar
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import cnn as TC
from repro_torch.train import cnn_training as TT
from repro_torch.train.loop import value_and_grad

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(stages=(1, 1), widths=(8, 16), image_size=16)
N_CU = 4
GRAD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def test_exec_spec_trainable_contract():
    s = TC.ExecSpec(trainable=True)
    assert s == TC.ExecSpec(trainable=True) and hash(s) == hash(s)
    for kw in (dict(quantized=True), dict(folded=True),
               dict(streamed=True, quantized=True, folded=True)):
        with pytest.raises(ValueError, match="inference-only") as te:
            TC.ExecSpec(trainable=True, **kw)
        with pytest.raises(ValueError) as je:
            JC.ExecSpec(trainable=True, **kw)
        assert str(te.value) == str(je.value)


def _pruned_tiny(target=0.5, quantized=False):
    cfg = JC.ResNetConfig(**CFG_KW, quantized=quantized)
    params, state = JC.init(jax.random.PRNGKey(0), cfg)
    specs = JC.conv_group_specs(params, N_CU)
    hcfg = HAPMConfig(target, 1)
    st = hapm_epoch_update(hapm_init(specs, hcfg), specs, params, hcfg)
    masks = hapm_element_masks(specs, st)
    tp, ts = TC.params_from_numpy(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, state), device="cpu")
    tmasks = tree_map(lambda m: _t(np.asarray(m)),
                      jax.tree.map(np.asarray, masks))
    tgm = jax.tree.map(np.asarray, st.group_masks)
    return dict(cfg=cfg, tcfg=TC.ResNetConfig(**CFG_KW, quantized=quantized),
                jp=params, js=state, specs=specs, st=st, jm=masks,
                tp=tp, ts=ts, tm=tmasks, tgm=tgm)


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "qat"])
def tiny(request):
    return _pruned_tiny(0.5, request.param)


def _batch(n, seed):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 16, 16, 3).astype(np.float32),
            rs.randint(0, 10, n).astype(np.int32))


def _t_exec(m):
    return TC.bind_execution(m["tp"], m["tcfg"],
                             spec=TC.ExecSpec(trainable=True, n_cu=N_CU),
                             group_masks=m["tgm"], device="cpu")


def test_trainable_bind_prepacks_nothing_and_binds_like_jax(tiny):
    jexec = JC.bind_execution(tiny["jp"], tiny["cfg"],
                              spec=JC.ExecSpec(trainable=True, n_cu=N_CU),
                              specs=tiny["specs"], group_masks=tiny["st"].group_masks)
    texec = _t_exec(tiny)
    assert texec.trainable and texec.bound_weights is None
    assert set(texec.table) == set(jexec.table)
    for k in jexec.table:
        assert (texec.table[k] is None) == (jexec.table[k] is None)
        np.testing.assert_array_equal(texec.plans[k].idx, jexec.plans[k].idx)
        assert texec.table[k] is None or texec.table[k].trainable
    assert texec.report(tiny["tcfg"], 2) == jexec.report(tiny["cfg"], 2)


def test_apply_train_rejects_inference_only_exec(tiny):
    pruned = t_apply_masks(tiny["tp"], tiny["tm"])
    x = torch.zeros((1, 16, 16, 3))
    infer_exec = TC.bind_execution(
        pruned, tiny["tcfg"], device="cpu",
        spec=TC.ExecSpec(n_cu=N_CU, quantized=tiny["tcfg"].quantized))
    with pytest.raises(ValueError, match="inference-only"):
        TC.apply(pruned, tiny["ts"], x, tiny["tcfg"], train=True, sparse=infer_exec)
    # eval-mode inference through the same exec still fine
    TC.apply(pruned, tiny["ts"], x, tiny["tcfg"], train=False, sparse=infer_exec)


def _j_loss(m, x, y, sparse):
    def loss(p):
        logits, new_state = JC.apply(apply_masks(p, m["jm"]), m["js"], x, m["cfg"],
                                     train=True, sparse=sparse)
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(lp, y[:, None], axis=-1)), new_state
    return loss


def _leaves(tree):
    return dict(tree_flatten_with_path(tree))


def test_model_grads_dense_vs_sparse_exec_match_jax(tiny):
    """Whole model, f32 and QAT: grads of the masked loss through the
    trainable bind match the port's dense path and the JAX package's sparse
    path; train-mode BN state matches JAX's; pruned groups get exactly zero
    gradient through the whole model."""
    xn, yn = _batch(2, 1)
    jexec = JC.bind_execution(tiny["jp"], tiny["cfg"],
                              spec=JC.ExecSpec(trainable=True, n_cu=N_CU),
                              specs=tiny["specs"], group_masks=tiny["st"].group_masks)
    (jl, jstate), jg = jax.value_and_grad(
        _j_loss(tiny, jnp.asarray(xn), jnp.asarray(yn), jexec), has_aux=True)(tiny["jp"])
    texec = _t_exec(tiny)
    batch = {"x": _t(xn), "y": _t(yn)}
    masked = lambda p, s: TT._loss_fn(t_apply_masks(p, tiny["tm"]), tiny["ts"], batch,
                                      tiny["tcfg"], s)
    (tl, tstate), tgs = value_and_grad(masked, tiny["tp"], texec)
    (tld, _), tgd = value_and_grad(masked, tiny["tp"], None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tld), float(jl), rtol=1e-5, atol=1e-5)
    jleaves = {tuple(k.key for k in p): np.asarray(a)
               for p, a in jax.tree_util.tree_flatten_with_path(jg)[0]}
    ts, td = _leaves(tgs), _leaves(tgd)
    assert set(jleaves) == set(ts) == set(td)
    for k, a in jleaves.items():
        np.testing.assert_allclose(ts[k].numpy(), a, rtol=GRAD_TOL, atol=GRAD_TOL)
        np.testing.assert_allclose(td[k].numpy(), ts[k].numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
    for k, m in _leaves(tiny["tm"]).items():
        assert float(torch.max(torch.abs(ts[k] * (1 - m)))) == 0.0
    for p, a in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        np.testing.assert_allclose(_leaves(tstate)[tuple(k.key for k in p)].numpy(),
                                   np.asarray(a), rtol=1e-5, atol=1e-6)


def test_sparse_train_step_matches_jax(tiny):
    """One SGD step (momentum 0.9, weight decay 1e-4, re-mask) through the
    trainable bind: params, BN state and momentum equal the JAX package's
    ``make_sparse_train_step`` within 1e-5."""
    sys.path.insert(0, ROOT)
    try:
        from benchmarks import cnn_training as JT
    finally:
        sys.path.remove(ROOT)
    from repro.train.optimizer import sgd as j_sgd
    from repro_torch.train.optimizer import sgd as t_sgd
    xn, yn = _batch(4, 2)
    jexec = JC.bind_execution(tiny["jp"], tiny["cfg"],
                              spec=JC.ExecSpec(trainable=True, n_cu=N_CU),
                              specs=tiny["specs"], group_masks=tiny["st"].group_masks)
    jstep = JT.make_sparse_train_step(tiny["cfg"], jexec)
    jp = jax.tree.map(jnp.array, tiny["jp"])           # the jitted step donates
    jout = jstep(jp, jax.tree.map(jnp.array, tiny["js"]), j_sgd(0.9, weight_decay=1e-4)[0](jp),
                 tiny["jm"], {"x": jnp.asarray(xn), "y": jnp.asarray(yn)}, 0.05)
    tstep = TT.make_sparse_train_step(tiny["tcfg"], _t_exec(tiny))
    tout = tstep(tiny["tp"], tiny["ts"], t_sgd(0.9, weight_decay=1e-4)[0](tiny["tp"]),
                 tiny["tm"], {"x": _t(xn), "y": _t(yn)}, 0.05)
    np.testing.assert_allclose(float(tout[3]), float(jout[3]), rtol=1e-5, atol=1e-5)
    for jt, tt in ((jout[0], tout[0]), (jout[1], tout[1]), (jout[2].momentum, tout[2].momentum)):
        tl = _leaves(tt)
        for p, a in jax.tree_util.tree_flatten_with_path(jt)[0]:
            np.testing.assert_allclose(tl[tuple(k.key for k in p)].numpy(), np.asarray(a),
                                       rtol=1e-5, atol=1e-5)
    for k, m in _leaves(tiny["tm"]).items():
        assert float(torch.max(torch.abs(_leaves(tout[0])[k] * (1 - m)))) == 0.0
    with pytest.raises(ValueError, match="trainable"):
        TT.make_sparse_train_step(tiny["tcfg"], TC.bind_execution(
            tiny["tp"], tiny["tcfg"], spec=TC.ExecSpec(n_cu=N_CU, bm=64,
                                                       implicit=False,
                                                       dense_fallback=0.0),
            bind_kernels=False))


def test_sparse_train_steps_decrease_loss_and_keep_pruned_zero():
    """End-to-end on the CPU: SGD steps through the trainable bind strictly
    decrease the loss on a fixed batch and keep pruned weights at zero; on
    the CPU no CUDA kernel is launched."""
    m = _pruned_tiny(0.5)
    exec_ = _t_exec(m)
    xn, yn = _batch(4, 2)
    step = TT.make_sparse_train_step(m["tcfg"], exec_)
    params = t_apply_masks(m["tp"], m["tm"])
    state = m["ts"]
    opt = TT.sgd(momentum=0.9, weight_decay=1e-4)[0](params)
    reset_launch_counts()
    losses = []
    for _ in range(4):
        params, state, opt, loss = step(params, state, opt, m["tm"],
                                        {"x": _t(xn), "y": _t(yn)}, 0.05)
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    for k, mk in _leaves(m["tm"]).items():
        assert float(torch.max(torch.abs(_leaves(params)[k] * (1 - mk)))) == 0.0
    assert set(launch_counts().values()) == {0}


def test_train_variant_hapm_sparse_training_on_cpu(capsys):
    """The harness runs HAPM with its epochs after the first pruning
    through the trainable bind (the full-width net on a tiny dataset of
    16x16 images, explicitly on the CPU); pruned groups stay exactly zero."""
    ds = SyntheticCifar(num_train=16, num_test=256, image_size=16)
    m = TT.train_variant("hapm", ds, 2, batch=8, sparse_training=True, device="cpu")
    out = capsys.readouterr().out
    assert out.count("sparse-exec") == 2 and "test accuracy" in out
    assert m.cfg.quantized and len(m.history) == 2
    assert all(np.isfinite(m.history)) and 0.0 <= m.test_accuracy <= 1.0
    for k, mk in _leaves(m.masks).items():
        assert float(torch.max(torch.abs(_leaves(m.params)[k] * (1 - mk)))) == 0.0
    with pytest.raises(ValueError, match="HAPM group plan"):
        TT.train_variant("int8", ds, 1, sparse_training=True, device="cpu")
    if not torch.cuda.is_available():       # no silent CPU: CUDA by default
        with pytest.raises(RuntimeError, match="none is available"):
            TT.train_variant("fp32", ds, 1)


def test_train_cli_on_cpu():
    """``python -m repro_torch.launch.train_cnn --device cpu`` at a tiny
    size: fp32 -> int8 -> HAPM with sparse training, then the executed-int8
    and the gradient checks through the kernels' plain versions. Its own
    process with two threads: it trains the full-width net, and six test
    workers each using every core would make it crawl."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2",
               MKL_NUM_THREADS="2")
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_cnn", "--device", "cpu",
         "--epochs", "1", "--train-size", "128"],
        env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "sparse-kernel training grads" in done.stdout and "HAPM acc=" in done.stdout
    assert "[hapm] epoch 1/1" in done.stdout and "sparse-exec" in done.stdout
    # the board pricing: int8 against HAPM on each of the three boards, and
    # the one-group-per-tile DSB cycle ratio beside the executed-int8 check
    assert "accelerator pricing (cycle model, DSB on)" in done.stdout
    for board in ("zybo_70mhz_72dsp", "zedboard_100mhz_72dsp", "zedboard_83mhz_144dsp"):
        assert f"{board}: int8" in done.stdout
    assert "DSB cycle ratio" in done.stdout
