"""The port's input pipeline (``data/pipeline.py``), its meshes
(``launch/mesh.py``) and elastic restore (``train/elastic.py`` over
``train/checkpoint.restore``'s ``sharding_fn``), on the CPU.

``shard_batch`` and ``prefetch`` keep the batches' order, values and
``None`` leaves, run at most ``depth`` ahead, and end when the iterator
does; under rules a batch becomes DTensors on the ``(1, 1)`` gloo mesh laid
out by ``batch_specs``. ``restore_elastic`` twins
``tests/test_train_substrate.py::test_elastic_restore_replicates`` and lays
a checkpoint of the transformer's params out by ``param_specs``. (The
copy-stream ordering of ``prefetch`` on the card is a ``gpu`` test.)"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.dist.api import ShardingRules as JRules
from repro.dist.compat import make_mesh as j_make_mesh
from repro.train import checkpoint as JCK
from repro.train.elastic import restore_elastic as j_restore_elastic
from repro_torch.configs import registry as TR
from repro_torch.core.masks import tree_flatten_with_path, tree_leaves
from repro_torch.data.pipeline import prefetch, shard_batch
from repro_torch.data.synthetic import TokenStream
from repro_torch.dist.api import NamedSharding, P, ShardingRules
from repro_torch.dist.sharding import make_rules, param_specs
from repro_torch.launch.mesh import make_host_mesh, make_mesh, make_production_mesh
from repro_torch.models import transformer as TT
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.elastic import restore_elastic


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(device="cpu")


def _batches(n, B=4, S=8, embeds=False):
    ts = TokenStream(vocab_size=300, seq_len=S, seed=1)
    it = ts.batches(B, seed=2)
    out = []
    for _ in range(n):
        b = dict(next(it))
        b["embeds"] = np.ones((B, 2, 3), np.float32) if embeds else None
        out.append(b)
    return out


def _equal(placed, host):
    for k, v in host.items():
        if v is None:
            assert placed[k] is None
        else:
            t = placed[k]
            t = t.full_tensor() if hasattr(t, "full_tensor") else t
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), v)


def test_shard_batch_without_rules_keeps_values_and_none_leaves():
    b = _batches(1)[0]
    placed = shard_batch(b, None, device="cpu")
    assert isinstance(placed["tokens"], torch.Tensor) and placed["tokens"].dtype == torch.int32
    _equal(placed, b)


def test_shard_batch_under_rules_places_dtensors(mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    b = _batches(1, embeds=True)[0]
    placed = shard_batch(b, make_rules(mesh, "train"))
    assert isinstance(placed["tokens"], DTensor)
    assert placed["tokens"].placements == (Shard(0), Replicate())
    assert placed["embeds"].placements == (Shard(0), Replicate())
    _equal(placed, b)


def test_default_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is the card")
    b = _batches(1)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        shard_batch(b, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch(iter([b])))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_order_values_and_end(depth):
    host = _batches(7, embeds=depth == 2)
    got = list(prefetch(iter(host), depth=depth, device="cpu"))
    assert len(got) == 7
    for placed, b in zip(got, host):
        _equal(placed, b)


def test_prefetch_under_rules(mesh):
    host = _batches(3)
    got = list(prefetch(iter(host), make_rules(mesh, "serve")))
    assert len(got) == 3
    for placed, b in zip(got, host):
        _equal(placed, b)


def test_prefetch_runs_at_most_depth_ahead():
    """The worker blocks once ``depth`` batches wait (plus the one it holds):
    with nothing consumed it has drawn ``depth + 1`` and no more."""
    drawn = []

    def source():
        for i in range(20):
            drawn.append(i)
            yield {"x": np.full((2,), i, np.int64)}

    it = prefetch(source(), depth=2, device="cpu")
    first = next(it)
    assert int(first["x"][0]) == 0
    for _ in range(100):
        if len(drawn) >= 4:
            break
        threading.Event().wait(0.01)
    threading.Event().wait(0.1)
    assert len(drawn) <= 4          # one consumed, two queued, one held
    rest = [int(b["x"][0]) for b in it]
    assert rest == list(range(1, 20))


def test_prefetch_ends_empty_and_raises_the_iterators_error():
    assert list(prefetch(iter([]), device="cpu")) == []

    def broken():
        yield {"x": np.zeros(2)}
        raise ValueError("source failed")

    it = prefetch(broken(), device="cpu")
    assert next(it)["x"].shape == (2,)
    with pytest.raises(ValueError, match="source failed"):
        next(it)


def test_meshes(mesh):
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    again = make_host_mesh(device="cpu")           # the group is opened once
    assert tuple(again.shape) == (1, 1)
    one = make_mesh((1,), ("data",), device="cpu")
    assert one.mesh_dim_names == ("data",)
    with pytest.raises(ValueError):
        make_host_mesh(model=2, device="cpu")
    with pytest.raises(RuntimeError, match="256"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512"):
        make_production_mesh(multi_pod=True)


# ---------------------------------------------------------------------------
# Elastic restore
# ---------------------------------------------------------------------------

def test_elastic_restore_replicates(tmp_path, mesh):
    """Twin of ``tests/test_train_substrate.py::test_elastic_restore_replicates``:
    a one-axis mesh, a spec over it, the leaf back with its values, as
    JAX's restore gives them from the same checkpoint."""
    from torch.distributed.tensor import DTensor, Shard
    rules = ShardingRules(mesh=make_mesh((1,), ("data",), device="cpu"),
                          rules={"batch": "data"})
    tree = {"w": torch.ones((4, 4))}
    CKPT.save(str(tmp_path), 3, tree)
    restored, meta = restore_elastic(str(tmp_path), tree, rules, {"w": P("data", None)})
    assert meta["step"] == 3
    assert isinstance(restored["w"], DTensor) and restored["w"].placements == (Shard(0),)
    assert torch.equal(restored["w"].full_tensor(), torch.ones((4, 4)))
    jrules = JRules(mesh=j_make_mesh((1,), ("data",)), rules={"batch": "data"})
    jtree = {"w": jnp.ones((4, 4))}
    want, _ = j_restore_elastic(str(tmp_path), jtree, jrules,
                                {"w": jax.sharding.PartitionSpec("data", None)})
    np.testing.assert_array_equal(restored["w"].full_tensor().numpy(), np.asarray(want["w"]))


def test_elastic_restore_without_rules_is_the_plain_restore(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": None}
    CKPT.save(str(tmp_path), 1, tree)
    restored, _ = restore_elastic(str(tmp_path), tree, None)
    np.testing.assert_array_equal(restored["w"], tree["w"].numpy())
    assert restored["b"] is None


def test_restore_elastic_lays_out_the_transformer_by_param_specs(tmp_path, mesh):
    """A smoke transformer's params saved, restored onto the (1, 1) mesh
    with ``param_specs`` (a spec left out replicates): each leaf a DTensor
    with its spec's placements and the saved values, bit for bit."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.dist.api import placements
    cfg = TR.get("granite-moe-3b-a800m").smoke
    params = TT.init(0, cfg, device="cpu")
    CKPT.save(str(tmp_path), 7, params)
    rules = make_rules(mesh, "serve")
    specs = param_specs(params, rules)
    specs["final_norm"] = None                      # no spec: replicated
    restored, _ = restore_elastic(str(tmp_path), params, rules, specs)
    flat_specs = dict(tree_flatten_with_path(specs, is_leaf=lambda x: x is None
                                             or isinstance(x, P)))
    for path, leaf in tree_flatten_with_path(restored):
        assert isinstance(leaf, DTensor), path
        spec = flat_specs[path]
        want = (Replicate(), Replicate()) if spec is None else placements(spec, mesh)
        assert leaf.placements == want, path
    for a, b in zip(tree_leaves(restored), tree_leaves(params)):
        assert torch.equal(a.full_tensor(), b)


def test_checkpoint_restore_sharding_fn_and_jax_checkpoint(tmp_path, mesh):
    """``restore``'s hook sees each leaf's path; a JAX-written checkpoint
    restores onto the port's mesh."""
    JCK.save(str(tmp_path), 2, {"a": {"w": jnp.arange(8.0).reshape(2, 4)}, "n": None})
    seen = []

    def sharding_fn(path, arr):
        seen.append(path)
        return NamedSharding(mesh, P(None, "model"))

    skel = {"a": {"w": torch.zeros((2, 4))}, "n": None}
    restored, _ = CKPT.restore(str(tmp_path), skel, sharding_fn=sharding_fn)
    assert seen == [("a", "w")] and restored["n"] is None
    assert torch.equal(restored["a"]["w"].full_tensor(), torch.arange(8.0).reshape(2, 4))
    plain, _ = CKPT.restore(str(tmp_path), skel, device="cpu",
                            sharding_fn=lambda p, a: None)
    assert isinstance(plain["a"]["w"], torch.Tensor)
    assert not hasattr(plain["a"]["w"], "full_tensor")
