"""Port vs JAX package: the synthetic datasets (``data/synthetic.py``, a
numpy copy that must give the same arrays) and Zhu-Gupta uniform pruning
(``core/uniform.py``; mirrors ``tests/test_quant_uniform.py``).

Datasets are compared **bitwise**; masks are equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import uniform as JU
from repro.data import synthetic as JS
from repro_torch.core import uniform as TU
from repro_torch.data import synthetic as TS


@pytest.mark.parametrize("kw", [dict(num_train=64, num_test=16, seed=0),
                                dict(num_train=40, num_test=8, seed=3, image_size=16,
                                     num_classes=4)])
def test_synthetic_cifar_arrays_and_epochs_bitwise_equal(kw, monkeypatch):
    monkeypatch.delenv("CIFAR10_DIR", raising=False)
    j, t = JS.SyntheticCifar(**kw), TS.SyntheticCifar(**kw)
    for name in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name
    for seed, augment, pi, pc in ((1, True, 0, 1), (2, False, 0, 1), (5, True, 1, 2)):
        je = list(j.epoch(8, seed=seed, augment=augment, process_index=pi, process_count=pc))
        te = list(t.epoch(8, seed=seed, augment=augment, process_index=pi, process_count=pc))
        assert len(je) == len(te) > 0
        for (jx, jy), (tx, ty) in zip(je, te):
            assert jx.tobytes() == tx.tobytes() and jy.tobytes() == ty.tobytes()


def test_token_stream_bitwise_equal():
    j, t = JS.TokenStream(vocab_size=300, seq_len=12, seed=2), \
        TS.TokenStream(vocab_size=300, seq_len=12, seed=2)
    jb, tb = j.batches(4, seed=1, process_index=1), t.batches(4, seed=1, process_index=1)
    for _ in range(3):
        a, b = next(jb), next(tb)
        for k in ("tokens", "targets"):
            assert a[k].tobytes() == b[k].tobytes()


def test_cubic_schedule_endpoints_and_equal_to_jax():
    cfg = TU.UniformPruneConfig(target_sparsity=0.8, begin_step=100, end_step=1100)
    jcfg = JU.UniformPruneConfig(target_sparsity=0.8, begin_step=100, end_step=1100)
    assert TU.sparsity_at(0, cfg) == 0.0
    assert TU.sparsity_at(100, cfg) == pytest.approx(0.0)
    assert TU.sparsity_at(1100, cfg) == pytest.approx(0.8)
    assert TU.sparsity_at(99999, cfg) == pytest.approx(0.8)
    assert 0.6 < TU.sparsity_at(600, cfg) < 0.8           # cubic: front-loaded
    assert [TU.sparsity_at(s, cfg) for s in range(0, 1300, 37)] == \
        [JU.sparsity_at(s, jcfg) for s in range(0, 1300, 37)]


def test_magnitude_masks_exact_count_monotone_and_equal_to_jax():
    rs = np.random.RandomState(2)
    w = rs.randn(40, 25).astype(np.float32)
    w[0, :5] = w[1, :5]                               # ties break by index
    tparams = {"w": torch.from_numpy(w), "b": torch.ones(7)}
    tmasks = {"w": torch.ones(40, 25), "b": None}
    jparams = {"w": jnp.asarray(w), "b": jnp.ones(7)}
    jmasks = {"w": jnp.ones((40, 25)), "b": None}
    m1 = TU.magnitude_masks(tparams, tmasks, 0.4)
    assert int(torch.sum(m1["w"] == 0)) == int(0.4 * 1000)
    assert m1["b"] is None
    np.testing.assert_array_equal(m1["w"].numpy(),
                                  np.asarray(JU.magnitude_masks(jparams, jmasks, 0.4)["w"]))
    # prune, then raise sparsity: pruned weights stay pruned
    p2 = {"w": tparams["w"] * m1["w"], "b": tparams["b"]}
    m2 = TU.magnitude_masks(p2, tmasks, 0.6)
    assert int(torch.sum(m2["w"] == 0)) == 600
    assert bool(torch.all(m2["w"] * (1 - m1["w"]) == 0))
    jp2 = {"w": jnp.asarray(p2["w"].numpy()), "b": jparams["b"]}
    np.testing.assert_array_equal(m2["w"].numpy(),
                                  np.asarray(JU.magnitude_masks(jp2, jmasks, 0.6)["w"]))


@pytest.mark.parametrize("step", [0, 50, 100, 150, 1200])
def test_maybe_update_schedule_equal_to_jax(step):
    rs = np.random.RandomState(step)
    w = rs.randn(16, 9).astype(np.float32)
    kw = dict(target_sparsity=0.5, begin_step=0, end_step=1000, update_every=100)
    t = TU.maybe_update(step, {"w": torch.from_numpy(w)}, {"w": torch.ones(16, 9)},
                        TU.UniformPruneConfig(**kw))
    j = JU.maybe_update(step, {"w": jnp.asarray(w)}, {"w": jnp.ones((16, 9))},
                        JU.UniformPruneConfig(**kw))
    np.testing.assert_array_equal(t["w"].numpy(), np.asarray(j["w"]))
