"""Port vs JAX package: the live-tile weight gradient (kernel K3,
``block_sparse_grad_weight``) and the trainable block-sparse matmul
(``kernels/ops.py``: ``make_block_sparse_grad_weight``, the backward of
``make_block_sparse_matmul``, ``block_sparse_from_hapm``).

The same numpy inputs go through the JAX function (Pallas in interpret
mode) and the port's plain version (CPU tensors). Tolerances: the two sum
the M rows in different orders, so f32 agrees within 1e-5 of the scale of
the sums, max(|x|ᵀ|g|); gradients through the autograd.Function agree with
JAX's custom VJP within 1e-5 relative (1e-3 absolute on gradients of a few
hundred). Dead tiles are exactly 0.0."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import tpu_tile_groups as j_tile_groups
from repro.kernels import ops as JO
from repro.kernels.block_sparse_matmul import block_sparse_grad_weight as j_grad_w
from repro.sparse.block_mask import plan_from_tile_mask as j_plan
from repro_torch.core import tpu_tile_groups as t_tile_groups
from repro_torch.kernels import block_sparse_matmul as TB
from repro_torch.kernels import ops as TO
from repro_torch.sparse.block_mask import plan_from_tile_mask as t_plan

F32_REL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(M, K, N, block, L, seed):
    rs = np.random.RandomState(seed)
    bk, bn = block
    cells = [(k, n) for k in range(K // bk) for n in range(N // bn)]
    pick = rs.permutation(len(cells))[:L]              # any order
    kk = np.asarray([cells[i][0] for i in pick], np.int32)
    nn = np.asarray([cells[i][1] for i in pick], np.int32)
    x = rs.randn(M, K).astype(np.float32)
    g = rs.randn(M, N).astype(np.float32)
    return x, g, kk, nn


def _scale(x, g, kk, nn, block):
    """max over live tiles of |x|ᵀ|g| — the size of the sums compared."""
    bk, bn = block
    ax, ag = np.abs(x.astype(np.float64)), np.abs(g.astype(np.float64))
    return max(float((ax[:, k * bk:(k + 1) * bk].T @ ag[:, n * bn:(n + 1) * bn]).max())
               for k, n in zip(kk, nn))


# tiles of the training path: unpacked 3x3 (16,128), unpacked 1x1 (8,128),
# packed (128,128); M a multiple of bm but not of the 128-row default
@pytest.mark.parametrize("block", [(16, 128), (8, 128), (128, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M,bm,L", [(192, 64, 3), (128, 128, 1), (200, 8, 5)])
def test_grad_weight_plain_matches_jax(block, dtype, M, bm, L):
    bk, bn = block
    K, N = 3 * bk, 2 * bn
    L = min(L, 6)
    x, g, kk, nn = _case(M, K, N, block, L, seed=M + bk + L)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    want = np.asarray(j_grad_w(jx, jg, jnp.asarray(kk), jnp.asarray(nn),
                               block=block, bm=bm, interpret=True))
    tx, tg = _t(np.asarray(jx.astype(jnp.float32))).to(tdt), \
        _t(np.asarray(jg.astype(jnp.float32))).to(tdt)
    got = TB.block_sparse_grad_weight(tx, tg, _t(kk), _t(nn), block=block, bm=bm)
    assert got.dtype == torch.float32 and tuple(got.shape) == (L, bk, bn)
    # bf16 operands: the products are exact in f32 on both sides
    tol = F32_REL * _scale(np.asarray(jx.astype(jnp.float32)),
                           np.asarray(jg.astype(jnp.float32)), kk, nn, block)
    assert float(np.abs(got.numpy() - want).max()) <= tol


def test_grad_weight_wrapper_contract():
    x, g, kk, nn = _case(64, 64, 256, (16, 128), 2, seed=1)
    with pytest.raises(ValueError, match="tile-aligned"):
        TB.block_sparse_grad_weight(_t(x[:60]), _t(g[:60]), _t(kk), _t(nn),
                                    block=(16, 128), bm=64)
    with pytest.raises(ValueError, match="no live tiles"):
        TB.block_sparse_grad_weight(_t(x), _t(g), _t(kk[:0]), _t(nn[:0]),
                                    block=(16, 128), bm=64)
    with pytest.raises(TypeError, match="dtypes differ"):
        TB.block_sparse_grad_weight(_t(x), _t(g).to(torch.bfloat16), _t(kk), _t(nn),
                                    block=(16, 128), bm=64)


@pytest.mark.parametrize("M,L", [(131072, 16), (131072, 2), (8192, 162),
                                 (128, 1), (1000, 300)])
def test_grad_weight_split_is_fixed_and_covers_rows(M, L):
    """``L`` counts the kernel's blocks along the tiles: its stacks."""
    for n_sms in (132, 114, 1):
        s, chunk = TB.grad_weight_split(M, L, n_sms)
        assert chunk % TB.GRAD_W_SLICE_M == 0
        assert (s - 1) * chunk < M <= s * chunk
        assert s <= max(1, -(-TB.GRAD_W_BLOCKS_PER_SM * n_sms // L))
        assert (s, chunk) == TB.grad_weight_split(M, L, n_sms)


@pytest.mark.parametrize("bk,L,n_cols", [(16, 14, 2), (16, 198, 6), (8, 112, 6),
                                         (128, 8, 1), (6, 50, 3), (256, 5, 2)])
def test_grad_weight_stacks_cover_every_tile_once(bk, L, n_cols):
    """The kernel's stack table: every live tile in exactly one row, a row's
    tiles all of one output column and at most stack_width(bk) of them (-1
    after), columns ascending, a column's tiles in the caller's order, as
    few rows as the columns need; the same table on every call."""
    rs = np.random.RandomState(L + bk)
    nn = rs.randint(n_cols, size=L).astype(np.int32)
    kk = rs.randint(64, size=L).astype(np.int32)
    tab = TB.grad_weight_stacks(kk, nn, bk)
    width = TB.stack_width(bk)
    assert width == max(1, TB.GRAD_W_STACK_ROWS // bk)
    assert tab.dtype == np.int32 and tab.shape[1] == width
    counts = np.bincount(nn, minlength=n_cols)
    assert tab.shape[0] == sum(-(-int(c) // width) for c in counts)
    seen = []
    for row in tab:
        live = row[row >= 0]
        assert np.all(row[len(live):] == -1) and len(live) >= 1
        assert len(set(nn[live].tolist())) == 1
        seen.extend(live.tolist())
    assert sorted(seen) == list(range(L))
    cols = [int(nn[row[0]]) for row in tab]
    assert cols == sorted(cols)
    for n in range(n_cols):                       # caller's order within a column
        assert [l for l in seen if nn[l] == n] == np.flatnonzero(nn == n).tolist()
    np.testing.assert_array_equal(tab, TB.grad_weight_stacks(kk, nn, bk))


def test_grad_weight_cpu_ignores_the_stack_table():
    """On the CPU the wrapper runs the plain version whether or not the
    bind's stack table is passed."""
    x, g, kk, nn = _case(64, 64, 256, (16, 128), 5, seed=3)
    stacks = _t(TB.grad_weight_stacks(kk, nn, 16))
    a = TB.block_sparse_grad_weight(_t(x), _t(g), _t(kk), _t(nn), block=(16, 128), bm=64)
    b = TB.block_sparse_grad_weight(_t(x), _t(g), _t(kk), _t(nn), block=(16, 128), bm=64,
                                    stacks=stacks)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kx,cin,cout", [(3, 16, 16), (1, 16, 32), (3, 32, 64)])
@pytest.mark.parametrize("packed", [False, True])
def test_conv_output_gradient_is_zero_past_output_lanes(kx, cin, cout, packed):
    """The trainable conv's backward packs dY onto the layout's 128-lane
    columns as the transpose of ``unpack_output``: every lane past the
    layout's ``output_lanes`` (12 filters unpacked, 10 groups of 12 packed)
    is exactly zero in every column, so the weight-gradient kernel may skip
    them (``g_lanes``); unpacked, 2 of a column's 16 n8 lane tiles hold
    values."""
    from repro_torch.core.groups import fpga_conv_groups
    from repro_torch.sparse.conv_plan import conv_gemm_layout
    spec = fpga_conv_groups((kx, kx, cin, cout), 12)
    layout = conv_gemm_layout(spec, packed=packed)
    lanes, bn = layout.output_lanes, layout.block[1]
    assert lanes == (120 if packed else 12)
    dy = torch.from_numpy(np.random.RandomState(cout).randn(2, 4, 4, cout).astype(np.float32))
    with torch.enable_grad():
        o2 = torch.zeros((32, layout.n_packed), requires_grad=True)
        g2d, = torch.autograd.grad(layout.unpack_output(o2, (2, 4, 4)), o2, dy)
    g3 = g2d.reshape(32, -1, bn)
    assert bool((g3[:, :, lanes:] == 0).all())
    assert bool((g3[:, 0, :lanes] != 0).any())
    if not packed:
        n8_live = (g3.abs().reshape(32, -1, bn // 8, 8).sum((0, 3)) > 0).sum(1)
        assert int(n8_live.max()) == 2


def test_grad_weight_cpu_takes_g_lanes():
    """On the CPU ``g_lanes`` is a promise about ``g`` the plain version
    does not need: the result is the same with or without it, through the
    wrapper and through the bind's ``dw_fn``."""
    x, g, kk, nn = _case(64, 64, 256, (16, 128), 4, seed=4)
    g.reshape(64, 2, 128)[:, :, 12:] = 0.0
    a = TB.block_sparse_grad_weight(_t(x), _t(g), _t(kk), _t(nn), block=(16, 128), bm=64)
    b = TB.block_sparse_grad_weight(_t(x), _t(g), _t(kk), _t(nn), block=(16, 128), bm=64,
                                    g_lanes=12)
    assert torch.equal(a, b) and float(a[:, :, 12:].abs().max()) == 0.0
    tm = np.zeros((4, 2), bool)
    tm[kk, nn] = True
    dw = TO.make_block_sparse_grad_weight(tm, (16, 128), bm=64)(_t(x), _t(g))
    dw12 = TO.make_block_sparse_grad_weight(tm, (16, 128), bm=64, g_lanes=12)(_t(x), _t(g))
    assert torch.equal(dw, dw12)


@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
def test_make_block_sparse_grad_weight_scatter(density):
    rs = np.random.RandomState(int(density * 10))
    block = (16, 128)
    tm = rs.rand(4, 3) < density
    x = rs.randn(100, 64).astype(np.float32)        # M padded to bm inside
    g = rs.randn(100, 384).astype(np.float32)
    jdw = np.asarray(JO.make_block_sparse_grad_weight(tm, block, bm=64)(
        jnp.asarray(x), jnp.asarray(g)))
    tdw = TO.make_block_sparse_grad_weight(tm, block, bm=64)(_t(x), _t(g)).numpy()
    assert tdw.shape == (64, 384) and tdw.dtype == np.float32
    dead = ~np.repeat(np.repeat(tm, 16, 0), 128, 1)
    assert np.all(tdw[dead] == 0.0)                 # exactly, not to a tolerance
    np.testing.assert_allclose(tdw, jdw, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tdw[~dead], (x.T @ g)[~dead], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("M,K,N,density", [
    (128, 256, 256, 0.5),
    (200, 384, 256, 0.3),            # M not tile-aligned
    (128, 256, 256, 1.0),
    (64, 128, 128, 0.0),             # fully pruned -> zero grads
])
def test_block_sparse_matmul_backward_matches_jax(M, K, N, density):
    rs = np.random.RandomState(M + K + int(density * 10))
    block = (128, 128)
    tm = rs.rand(K // 128, N // 128) < density
    w = rs.randn(K, N).astype(np.float32)
    x = rs.randn(M, K).astype(np.float32)
    jf = JO.make_block_sparse_matmul(j_plan(tm, block), tm)
    tf = TO.make_block_sparse_matmul(t_plan(tm, block), tm)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jf(a, b) ** 2), (0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    out = tf(tx, tw)
    torch.sum(out ** 2).backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jf(jnp.asarray(x), jnp.asarray(w))),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=1e-3, rtol=1e-5)
    dead = ~np.repeat(np.repeat(tm, 128, 0), 128, 1)
    assert np.all(tw.grad.numpy()[dead] == 0.0)     # pruned tiles: exactly zero


def test_block_sparse_matmul_backward_leading_dims_and_mask():
    """Leading batch dims are flattened for the kernels and restored; the
    gradient of a pruned tile is exactly zero (mirrors
    ``tests/test_kernels.py::test_block_sparse_grads_match_ref``)."""
    rs = np.random.RandomState(0)
    tm = np.asarray([[True, False], [False, True]])
    w = rs.randn(256, 256).astype(np.float32)
    x = rs.randn(2, 64, 256).astype(np.float32)
    tf = TO.make_block_sparse_matmul(t_plan(tm, (128, 128)), tm)
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    torch.sum(tf(tx, tw) ** 2).backward()
    m = np.repeat(np.repeat(tm, 128, 0), 128, 1).astype(np.float32)
    y = x.reshape(-1, 256) @ (w * m)
    np.testing.assert_allclose(tx.grad.numpy().reshape(-1, 256),
                               2 * y @ (w * m).T, atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), (x.reshape(-1, 256).T @ (2 * y)) * m,
                               atol=1e-3, rtol=1e-4)
    assert float(tw.grad[:128, 128:].abs().max()) == 0.0


def test_block_sparse_from_hapm_endtoend():
    """HAPM element mask -> plan -> kernel == masked dense matmul, as in
    ``tests/test_kernels.py``; the port's closure is also trainable."""
    rs = np.random.RandomState(5)
    w = rs.randn(256, 256).astype(np.float32)
    gm = np.asarray([1, 0, 0, 1], np.float32)
    jem = np.asarray(j_tile_groups(w.shape, (128, 128)).expand(jnp.asarray(gm)))
    tem = t_tile_groups(w.shape, (128, 128)).expand(gm).numpy()
    np.testing.assert_array_equal(jem, tem)
    jfn, jplan = JO.block_sparse_from_hapm(w, jem)
    tfn, tplan = TO.block_sparse_from_hapm(w, tem)
    assert tplan.skipped_tiles == jplan.skipped_tiles == 2
    np.testing.assert_array_equal(tplan.idx, jplan.idx)
    x = rs.randn(64, 256).astype(np.float32)
    tw = _t(w).requires_grad_()
    out = tfn(_t(x), tw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jfn(jnp.asarray(x), jnp.asarray(w))),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), x @ (w * tem), atol=1e-4, rtol=1e-4)
    out.sum().backward()
    assert float(tw.grad[tem == 0].abs().max()) == 0.0
