"""Port vs JAX package: LM training, ``launch/train.py`` (the step builders
and the driver), ``cfg.remat`` in the port's layer stacks, and the
``examples/prune_lm_blocksparse.py`` twin ``launch/prune_lm_blocksparse.py``.

The JAX side draws the weights (``lm.init``), which come across through
``lm.params_from_numpy``; the same numpy batches and group masks go to both
steps (JAX's jitted). MoE configs run at drop-free capacity, as the PR 25
parity tests do, so no token's route depends on how a batch is split.

Tolerances: the loss within ``LOSS_REL_TOL`` (1e-5) of JAX's; weights and
AdamW moments per leaf within ``STEP_REL_TOL`` (1e-4, the repo's f32 bar) x
the leaf's largest |value| after 3 steps. AdamW divides each gradient by
its own root mean square, so an entry whose gradient is near ``eps`` moves
by a share of ``lr`` that the last bits of the gradient decide: the worst
leaf reads ~5e-5 (gemma2-9b's tied embedding), while the loss agrees to
~1e-7. Pruned entries are exactly 0 on both sides after every step. The
example twin's block-sparse product against JAX's ``make_block_sparse_matmul``
(Pallas interpret mode) within ``KERNEL_VS_JAX_TOL`` (1e-5, summation
order).
"""
import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.kernels import ops as JO
from repro.launch import train as JT
from repro.models import lm as JLM
from repro.sparse import block_mask as JB
from repro_torch.configs import registry as TR
from repro_torch.core import HAPMConfig, hapm_epoch_update, hapm_group_sparsity, hapm_init
from repro_torch.core.groups import apply_group_mask
from repro_torch.core.masks import tree_flatten_with_path, tree_map
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import dryrun as DR
from repro_torch.launch import prune_lm_blocksparse as PLB
from repro_torch.launch import train as TT
from repro_torch.models import lm as LM
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.loop import value_and_grad

ALL_ARCHS = sorted(JR.REGISTRY)
LOSS_REL_TOL = 1e-5
STEP_REL_TOL = 1e-4
KERNEL_VS_JAX_TOL = 1e-5
STEPS = 3
J_INIT = jax.jit(JLM.init, static_argnums=(1,))


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Six test workers share the machine: two intra-op threads each."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _drop_free(cfg):
    if cfg.family == "moe":
        return dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg


def _cfgs(arch, **kw):
    return (dataclasses.replace(_drop_free(JR.get(arch).smoke), **kw),
            dataclasses.replace(_drop_free(TR.get(arch).smoke), **kw))


def _batch(cfg, rs, B=4, S=16):
    """One training batch from a numpy stream: next-token targets, and the
    VLM's image prefix / the audio family's frame embeddings."""
    toks = rs.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    if cfg.family == "vlm":
        P = cfg.num_prefix_tokens
        return {"tokens": toks[:, :S - P], "targets": toks[:, 1:S - P + 1],
                "embeds": (rs.randn(B, P, cfg.d_model) * 0.1).astype(np.float32)}
    if cfg.family == "audio":
        return {"tokens": None, "targets": toks[:, 1:],
                "embeds": (rs.randn(B, S, cfg.d_model) * 0.1).astype(np.float32)}
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _jax(b):
    return {k: None if v is None else jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: None if v is None else torch.from_numpy(v) for k, v in b.items()}


def _flat_jax(tree):
    return {tuple(getattr(k, "key", None) for k in p): np.asarray(l, np.float64)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _worst(tree_j, tree_t):
    """max over leaves of max |port - JAX| / max |JAX|, and its leaf."""
    want = _flat_jax(tree_j)
    got = dict(tree_flatten_with_path(tree_t))
    assert set(got) == set(want)
    return max((float(np.abs(got[p].double().numpy() - a).max() / max(np.abs(a).max(), 1e-30)),
                p) for p, a in want.items())


def _random_masks(specs_j, rs):
    """Group masks with about 30 % of each weight's groups 0, as numpy."""
    return jax.tree.map(lambda m: (rs.rand(*m.shape) > 0.3).astype(np.float32),
                        JT.init_group_masks(specs_j))


def _assert_pruned_zero(params, specs, gmasks):
    """Every entry of a pruned group is exactly 0."""
    weights, by_path = dict(tree_flatten_with_path(params)), dict(tree_flatten_with_path(specs))
    for path, gm in tree_flatten_with_path(gmasks):
        pruned = weights[path][by_path[path].expand(gm) == 0]
        assert pruned.numel() == 0 or float(pruned.abs().max()) == 0.0, path


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_matches_jax(arch, accum):
    """``build_train_step`` against the JAX package's, step by step: 3
    AdamW steps with ~30 % of every weight's groups pruned, ``grad_accum``
    1 (gradients in the weights' dtype) and 2 (micro-batches summed in f32),
    f32 smoke configs."""
    cj, ct = _cfgs(arch, grad_accum=accum)
    pj = J_INIT(jax.random.PRNGKey(0), cj)
    pt = LM.params_from_numpy(jax.tree.map(np.asarray, pj), ct, device="cpu")
    sj, st = JLM.group_specs(pj, cj), LM.group_specs(pt, ct)
    rs = np.random.RandomState(3)
    gm_np = _random_masks(sj, rs)
    gj = jax.tree.map(jnp.asarray, gm_np)
    gt = tree_map(lambda m: torch.from_numpy(np.array(m)), gm_np)
    step_j, init_j = JT.build_train_step(cj, sj, lr=3e-4)
    step_j = jax.jit(step_j)
    step_t, init_t = TT.build_train_step(ct, st, lr=3e-4)
    oj, ot = init_j(pj), init_t(pt)
    for _ in range(STEPS):
        b = _batch(cj, rs)
        pj, oj, lj = step_j(pj, oj, gj, _jax(b))
        pt, ot, lt = step_t(pt, ot, gt, _torch(b))
        assert np.isfinite(float(lt))
        assert abs(float(lt) - float(lj)) <= LOSS_REL_TOL * abs(float(lj))
        _assert_pruned_zero(pt, st, gt)
    assert int(ot.count) == int(oj.count) == STEPS
    for got, want in ((pt, pj), (ot.mu, oj.mu), (ot.nu, oj.nu)):
        err, leaf = _worst(want, got)
        assert err <= STEP_REL_TOL, (leaf, err)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_group_masks_equal_jax(arch):
    """``init_group_masks`` (all ones, f32, one per prunable weight) and
    ``expand_group_masks`` of random masks, leaf by leaf, on the smoke
    config's tree."""
    cj, ct = _cfgs(arch)
    sj = JLM.group_specs(jax.eval_shape(lambda: JLM.init(jax.random.PRNGKey(0), cj)), cj)
    st = LM.group_specs(LM.init(None, ct, device="meta"), ct)
    init_j, init_t = _flat_jax(JT.init_group_masks(sj)), dict(
        tree_flatten_with_path(TT.init_group_masks(st)))
    assert set(init_t) == set(init_j) and init_t
    for p, m in init_t.items():
        assert m.dtype == torch.float32 and np.array_equal(m.numpy(), init_j[p])
    gm_np = _random_masks(sj, np.random.RandomState(5))
    ej = _flat_jax(JT.expand_group_masks(sj, jax.tree.map(jnp.asarray, gm_np)))
    et = dict(tree_flatten_with_path(TT.expand_group_masks(
        st, tree_map(lambda m: torch.from_numpy(np.array(m)), gm_np))))
    assert set(et) == set(ej)
    for p, m in et.items():
        assert np.array_equal(m.numpy(), ej[p]), p


def test_hapm_epoch_update_on_bf16_weights_matches_jax():
    """HAPM's epoch update on a bf16 model (the full configs' dtype): the
    group scores are summed in bf16 on both sides and ranked in float64, so
    the masks equal the JAX package's on the same bf16 weights."""
    from repro.core import HAPMConfig as JHC, hapm_epoch_update as j_update, hapm_init as j_init
    cj, ct = _cfgs("mistral-nemo-12b", dtype="bfloat16")
    pj = J_INIT(jax.random.PRNGKey(4), cj)
    pt = LM.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), pj), ct,
                              device="cpu")
    assert pt["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    sj, st = JLM.group_specs(pj, cj), LM.group_specs(pt, ct)
    hj, ht = j_init(sj, JHC(0.5, 2)), hapm_init(st, HAPMConfig(0.5, 2))
    for _ in range(2):
        hj, ht = j_update(hj, sj, pj, JHC(0.5, 2)), hapm_epoch_update(ht, st, pt, HAPMConfig(0.5, 2))
    want = _flat_jax(hj.group_masks)
    got = dict(tree_flatten_with_path(ht.group_masks))
    assert set(got) == set(want) and hapm_group_sparsity(ht) > 0.4
    for p, m in got.items():
        assert np.array_equal(np.asarray(m), want[p]), p


# ---------------------------------------------------------------------------
# cfg.remat
# ---------------------------------------------------------------------------

REMAT_ARCHS = ["mistral-nemo-12b", "gemma2-9b", "granite-moe-3b-a800m", "zamba2-7b",
               "xlstm-350m"]


def _grads_and_saved(ct, pt, b, remat):
    cfg = dataclasses.replace(ct, remat=remat)
    saved = DR.SavedBytes((pt, b))
    with saved.counting():
        (loss, _), g = value_and_grad(lambda p, bb: LM.loss_fn(p, bb, cfg), pt, b)
    return loss, g, saved.bytes


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_leaves_gradients_unchanged_and_saves_less(arch):
    """``remat`` none / dots / full: the same loss and the same gradients,
    bit for bit (the recomputed layer runs the same operations; MoE routes
    the same way, the router being deterministic), while the activations
    autograd holds for the backward shrink: none > dots (the weight
    products kept, the rest recomputed) > full (each layer's inputs only)."""
    cj, ct = _cfgs(arch)
    pt = LM.params_from_numpy(jax.tree.map(np.asarray, J_INIT(jax.random.PRNGKey(0), cj)),
                              ct, device="cpu")
    b = _torch(_batch(cj, np.random.RandomState(9)))
    out = {r: _grads_and_saved(ct, pt, b, r) for r in ("none", "dots", "full")}
    loss0, g0, _ = out["none"]
    for r in ("dots", "full"):
        loss, g, _ = out[r]
        assert torch.equal(loss, loss0), r
        for (p, a), (_, c) in zip(tree_flatten_with_path(g0), tree_flatten_with_path(g)):
            assert torch.equal(a, c), (r, p)
    assert out["none"][2] > out["dots"][2] > out["full"][2] > 0, {r: o[2] for r, o in out.items()}


def test_remat_is_off_without_a_recorded_backward():
    """Under ``torch.no_grad`` (serving) a ``remat="full"`` forward is the
    plain one: the same logits, and no checkpoint is entered."""
    cj, ct = _cfgs("mistral-nemo-12b")
    pt = LM.params_from_numpy(jax.tree.map(np.asarray, J_INIT(jax.random.PRNGKey(0), cj)),
                              ct, device="cpu")
    b = _torch(_batch(cj, np.random.RandomState(2)))
    with torch.no_grad():
        a, _, _ = LM.forward(pt, b, dataclasses.replace(ct, remat="full"))
        c, _, _ = LM.forward(pt, b, dataclasses.replace(ct, remat="none"))
    assert torch.equal(a, c)
    from repro_torch.models import transformer as TF
    f = lambda x: x
    with torch.no_grad():
        assert TF._remat(f, dataclasses.replace(ct, remat="full")) is f


# ---------------------------------------------------------------------------
# The training system, the driver and the entry points
# ---------------------------------------------------------------------------

def test_train_learns_prunes_and_resumes(tmp_path):
    """Twin of ``tests/test_system.py::test_train_learns_prunes_and_resumes``:
    30 steps of a 2-layer mistral-nemo smoke model with HAPM epochs at steps
    5, 12 and 19 (target 0.25); the loss falls, the target is reached,
    pruned weights are exactly 0, and a checkpoint of step 15 resumes."""
    cfg = dataclasses.replace(TR.get("mistral-nemo-12b").smoke,
                              num_layers=2, d_model=64, vocab_size=256)
    params = LM.init(0, cfg, device="cpu")
    specs = LM.group_specs(params, cfg)
    step_fn, opt_init = TT.build_train_step(cfg, specs, lr=3e-3)
    opt_state = opt_init(params)

    hcfg = HAPMConfig(0.25, 3)
    hstate = hapm_init(specs, hcfg)
    gmasks = TT.init_group_masks(specs)

    ds = TokenStream(cfg.vocab_size, seq_len=32)
    it = ds.batches(8, seed=0)
    batch = lambda: {k: torch.from_numpy(v) for k, v in next(it).items()}
    losses = []
    for step in range(30):
        if step in (5, 12, 19):   # epoch boundaries: prune more groups
            hstate = hapm_epoch_update(hstate, specs, params, hcfg)
            gmasks = TT.group_masks_on(hstate, "cpu")
        params, opt_state, loss = step_fn(params, opt_state, gmasks, batch())
        losses.append(float(loss))
        if step == 15:
            CKPT.save(str(tmp_path), step, {"params": params, "opt": opt_state})

    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses
    assert abs(hapm_group_sparsity(hstate) - 0.25) < 0.05
    wq = params["blocks"]["attn"]["wq"]
    gm = gmasks["blocks"]["attn"]["wq"]
    masked = apply_group_mask(specs["blocks"]["attn"]["wq"], wq, gm)
    if float((gm == 0).sum()) > 0:
        assert float(masked.abs().min()) == 0.0

    restored, meta = CKPT.restore(str(tmp_path), {"params": params, "opt": opt_state},
                                  device="cpu")
    assert meta["step"] == 15
    _, _, loss2 = step_fn(restored["params"], restored["opt"], gmasks, batch())
    assert np.isfinite(float(loss2))


def test_bf16_checkpoint_round_trips_and_is_the_jax_packages_file(tmp_path):
    """A bf16 model and its AdamW state saved by ``train/checkpoint.py``
    restore bit for bit on the CPU, and the arrays hold the bytes the JAX
    package's ``save`` writes for the same bf16 weights (numpy has no bf16:
    both store its bits as 2-byte voids)."""
    from repro.train import checkpoint as JCKPT
    cj, ct = _cfgs("mistral-nemo-12b", dtype="bfloat16")
    pj = J_INIT(jax.random.PRNGKey(6), cj)
    pt = LM.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), pj), ct,
                              device="cpu")
    _, opt_init = TT.build_train_step(ct, LM.group_specs(pt, ct))
    opt = opt_init(pt)
    CKPT.save(str(tmp_path / "port"), 3, {"params": pt, "opt": opt})
    JCKPT.save(str(tmp_path / "jax"), 3, {"params": pj})
    tree, meta = CKPT.restore(str(tmp_path / "port"), {"params": pt, "opt": opt}, device="cpu")
    assert meta["step"] == 3
    for (p, a), (_, b) in zip(tree_flatten_with_path(tree["params"]),
                              tree_flatten_with_path(pt)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    assert torch.equal(tree["opt"].mu["embed"], opt.mu["embed"])
    port, _ = CKPT.load_flat(str(tmp_path / "port"))
    ref, _ = CKPT.load_flat(str(tmp_path / "jax"))
    assert set(ref) <= set(port)
    for k, a in ref.items():
        assert port[k].dtype == a.dtype and port[k].tobytes() == a.tobytes(), k


def _lines(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue().splitlines()


_NUMBER = re.compile(r"\d+\.\d+")


def test_train_main_prints_jax_line_formats(tmp_path):
    """``launch.train.main`` on the CPU prints the JAX driver's lines, in the
    same order and format: the parameter count and every HAPM epoch's group
    sparsity equal, the losses (other weights) only in format; a second run
    resumes from the checkpoint the first one saved."""
    argv = ["--arch", "xlstm-350m", "--smoke", "--steps", "6", "--batch", "4", "--seq", "16",
            "--hapm-sparsity", "0.25", "--hapm-epochs", "3", "--log-every", "1"]
    want = _lines(JT.main, argv)
    got = _lines(TT.main, argv + ["--device", "cpu"])
    assert len(got) == len(want) and got[0] == want[0]
    for g, w in zip(got, want):
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w), (g, w)
        if "[hapm]" in g:
            assert g == w
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device", "cpu"]
    _lines(TT.main, argv + ck)
    resumed = _lines(TT.main, argv[:3] + ["--steps", "7"] + argv[5:] + ck)
    assert resumed[1] == "resumed from step 4" and resumed[-1].startswith("final loss: ")


def test_example_twin_kernel_matches_jax():
    """The example twin's layer-0 ``ffn/wi`` through ``make_block_sparse_matmul``
    (the kernel's plain version on the CPU) against the JAX package's, run
    as its tests run it (Pallas interpret mode), on the same numpy weights,
    tile mask and rows; both against the masked-dense product."""
    out = PLB.main(["--device", "cpu", "--steps", "18", "--epochs", "6"])
    assert out["err"] < PLB.KERNEL_TOL and out["skipped_tiles"] > 0
    w, tm, x = out["w"].detach().numpy(), out["tile_mask"], out["x"].numpy()
    plan = JB.plan_from_tile_mask(tm, PLB.DEMO_CFG.block_size)
    y_jax = np.asarray(JO.make_block_sparse_matmul(plan, tm)(jnp.asarray(x), jnp.asarray(w)))
    y_port = out["y_kernel"].numpy()
    assert np.abs(y_port - y_jax).max() <= KERNEL_VS_JAX_TOL * np.abs(y_jax).max()
    bk, bn = PLB.DEMO_CFG.block_size
    dense = x @ (w * np.kron(tm, np.ones((bk, bn), np.float32)))
    assert np.abs(y_port - dense).max() < PLB.KERNEL_TOL


def test_layer_spec_is_the_replace_of_the_jax_example():
    """``dataclasses.replace`` of a stacked tile spec down to one layer (the
    JAX example's l. 73-77) gives the spec of a one-layer weight."""
    from repro_torch.core.groups import tpu_tile_groups
    stacked = tpu_tile_groups((2, 256, 512), (128, 128))
    one, masks = PLB.layer_spec(stacked, np.arange(stacked.num_groups, dtype=np.float32))
    assert one == tpu_tile_groups((256, 512), (128, 128))
    assert masks.shape == (2, 2, 4) and masks[1, 0, 0] == 8.0


def test_entry_points_want_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.main(["--arch", "xlstm-350m", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        PLB.main(["--steps", "1"])
