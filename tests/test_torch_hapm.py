"""Port vs JAX package: pruning groups, masks and HAPM (``core/groups.py``,
``core/masks.py``, ``core/hapm.py``) — identical masks from identical
weights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import groups as JG, hapm as JH, masks as JM
from repro.models import cnn as JC
from repro_torch.core import groups as TG, hapm as TH, masks as TM
from repro_torch.models import cnn as TC

CFG = dict(stages=(1, 1), widths=(8, 16), image_size=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _model():
    jp, js = JC.init(jax.random.PRNGKey(0), JC.ResNetConfig(**CFG))
    np_p = jax.tree.map(np.asarray, jp)
    tp, _ = TC.params_from_numpy(np_p, device="cpu")
    return jp, tp


SPEC_CASES = [
    ("fpga", (3, 3, 5, 10), lambda m, s: m.fpga_conv_groups(s, 4)),
    ("fpga_exact", (1, 1, 8, 16), lambda m, s: m.fpga_conv_groups(s, 4)),
    ("tile", (40, 300), lambda m, s: m.tpu_tile_groups(s, (16, 128))),
    ("tile_lead", (2, 32, 256), lambda m, s: m.tpu_tile_groups(s, (16, 128))),
    ("flat", (3, 4, 5), lambda m, s: m.flat_groups(s)),
]


@pytest.mark.parametrize("name,shape,make", SPEC_CASES)
def test_group_spec_equal(name, shape, make):
    rs = np.random.RandomState(0)
    w = rs.randn(*shape).astype(np.float32)
    js, ts = make(JG, shape), make(TG, shape)
    assert (js.num_groups, js.group_size, js.kind) == (ts.num_groups, ts.group_size, ts.kind)
    np.testing.assert_array_equal(js.group_elem_counts(), ts.group_elem_counts())
    np.testing.assert_allclose(ts.group_scores(_t(w)).numpy(),
                               np.asarray(js.group_scores(jnp.asarray(w))),
                               rtol=1e-6)
    gm = (rs.rand(js.num_groups) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(ts.expand(gm).numpy(),
                                  np.asarray(js.expand(jnp.asarray(gm))))
    np.testing.assert_array_equal(
        TG.apply_group_mask(ts, _t(w), gm).numpy(),
        np.asarray(JG.apply_group_mask(js, jnp.asarray(w), jnp.asarray(gm))))


@pytest.mark.parametrize("sparsity,epochs,score", [(0.5, 1, "sum_abs"),
                                                   (0.5, 3, "sum_abs"),
                                                   (0.8, 2, "mean_abs")])
def test_hapm_masks_identical(sparsity, epochs, score):
    jp, tp = _model()
    jspecs, tspecs = JC.conv_group_specs(jp, 4), TC.conv_group_specs(tp, 4)
    jcfg = JH.HAPMConfig(sparsity, epochs, score)
    tcfg = TH.HAPMConfig(sparsity, epochs, score)
    jst, tst = JH.hapm_init(jspecs, jcfg), TH.hapm_init(tspecs, tcfg)
    assert (jst.g_per_epoch, jst.total_groups) == (tst.g_per_epoch, tst.total_groups)
    for _ in range(epochs):
        jst = JH.hapm_epoch_update(jst, jspecs, jp, jcfg)
        tst = TH.hapm_epoch_update(tst, tspecs, tp, tcfg)
    assert jst.epoch == tst.epoch and jst.groups_pruned == tst.groups_pruned
    assert JH.hapm_group_sparsity(jst) == TH.hapm_group_sparsity(tst)
    jm = {jax.tree_util.keystr(p): np.asarray(m) for p, m in
          jax.tree_util.tree_flatten_with_path(jst.group_masks)[0]}
    tm = {TM.keystr(p): m for p, m in TM.tree_flatten_with_path(tst.group_masks)}
    assert jm.keys() == tm.keys()
    for k in jm:
        np.testing.assert_array_equal(jm[k], tm[k])
    # element masks and the masked params they produce
    jel, tel = JH.hapm_element_masks(jspecs, jst), TH.hapm_element_masks(tspecs, tst)
    jpr, tpr = JM.apply_masks(jp, jel), TM.apply_masks(tp, tel)
    for (p, a) in jax.tree_util.tree_flatten_with_path(jpr)[0]:
        keys = tuple(k.key for k in p)
        b = tpr
        for k in keys:
            b = b[k]
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert abs(JM.global_sparsity(jel) - TM.global_sparsity(tel)) < 1e-7
    assert JM.count_params(jel) == TM.count_params(tel)
    assert JM.per_leaf_sparsity(jel).keys() == TM.per_leaf_sparsity(tel).keys()


def test_hapm_scores_tree_matches():
    jp, tp = _model()
    jsc = JH.hapm_scores(JC.conv_group_specs(jp, 4), jp)
    tsc = TH.hapm_scores(TC.conv_group_specs(tp, 4), tp)
    np.testing.assert_allclose(tsc["s1b0"]["proj"]["w"].numpy(),
                               np.asarray(jsc["s1b0"]["proj"]["w"]), rtol=1e-6)
    assert tsc["bn0"]["scale"] is None and tsc["fc"]["w"] is None


def test_non_finite_scores_raise():
    _, tp = _model()
    specs = TC.conv_group_specs(tp, 4)
    cfg = TH.HAPMConfig(0.5, 1)
    tp["conv0"]["w"] = tp["conv0"]["w"].clone()
    tp["conv0"]["w"][0, 0, 0, 0] = float("nan")
    with pytest.raises(ValueError, match="non-finite group score"):
        TH.hapm_epoch_update(TH.hapm_init(specs, cfg), specs, tp, cfg)


def test_full_masks_and_sparsity():
    _, tp = _model()
    fm = TM.full_masks(tp, TC.is_conv_weight)
    assert fm["bn0"]["scale"] is None and fm["conv0"]["w"].shape == tp["conv0"]["w"].shape
    assert TM.global_sparsity(fm) == 0.0 and TM.sparsity(None) == 0.0
    assert TM.sparsity(torch.tensor([1.0, 0.0, 0.0, 1.0])) == 0.5


def test_tree_walker_matches_jax_paths():
    tree = {"b": {"y": 1, "x": [2, 3]}, "a": (4, None), "c": None}
    jp = [(jax.tree_util.keystr(p), v) for p, v in
          jax.tree_util.tree_flatten_with_path(tree)[0]]
    tp = [(TM.keystr(p), v) for p, v in TM.tree_flatten_with_path(tree)]
    assert jp == tp
