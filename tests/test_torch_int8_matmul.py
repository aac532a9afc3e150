"""Port vs JAX package: the fixed-point GEMM slice — ``kernels/int8_matmul.py``
(kernel K4's wrapper; on the CPU its plain version) and
``kernels/ops.py::fixed_point_matmul``.

The same numpy codes and floats go through the JAX function (Pallas in
interpret mode) and the port. int8 × int8 accumulates exactly in int32 and
the flush is one int → f32 conversion and one f32 multiply, so outputs are
**bit-equal**, sums past 2^24 (where the conversion rounds) included. The
straight-through backward is two f32 matmuls on the float operands: within
1e-4 of ``jax.grad`` (summation order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import quant as JQ
from repro.kernels import ops as JO, ref as JR
from repro.kernels.int8_matmul import int8_matmul as j_int8_matmul
from repro_torch import kernels as TK
from repro_torch.core import quant as TQ
from repro_torch.kernels import int8_matmul as TI, ops as TO, ref as TR


def _codes(M, K, N, seed):
    """Codes over the whole int8 range with a row/column of -128 and of 127,
    so sums reach K * 2^14."""
    rs = np.random.RandomState(seed)
    x = rs.randint(-128, 128, (M, K)).astype(np.int8)
    w = rs.randint(-128, 128, (K, N)).astype(np.int8)
    x[0], w[:, 0] = -128, -128
    x[-1], w[:, -1] = 127, 127
    return x, w, rs


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (128, 256, 128), (256, 384, 256),
                                   (128, 1152, 128)])
@pytest.mark.parametrize("per_cout", [False, True], ids=["scalar", "per_cout"])
def test_int8_matmul_bit_exact_vs_jax(M, K, N, per_cout):
    x, w, rs = _codes(M, K, N, M + K + N)
    scale = (rs.uniform(1e-3, 1e-1, N).astype(np.float32) if per_cout
             else np.asarray([1.0 / 512], np.float32))
    before = TI.launch_count()
    got = TI.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale))
    assert TI.launch_count() == before                     # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    want = np.asarray(j_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                    interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JR.int8_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                                   jnp.asarray(scale))))
    np.testing.assert_array_equal(
        got.numpy(), TR.int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                        torch.from_numpy(scale)).numpy())
    if K >= 1152:       # sums past 2^24: the int -> f32 conversion rounds
        assert np.abs(x.astype(np.int64) @ w.astype(np.int64)).max() > 2 ** 24


def test_int8_matmul_scalar_is_the_broadcast_row():
    x, w, _ = _codes(128, 256, 256, 9)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    s = TI.int8_matmul(xt, wt, torch.tensor([1.0 / 512]))
    assert torch.equal(s, TI.int8_matmul(xt, wt, torch.full((256,), 1.0 / 512)))
    assert torch.equal(s, TI.int8_matmul_plain(xt, wt, torch.tensor([1.0 / 512])))


@pytest.mark.parametrize("bm,bk,bn", [(64, 32, 64), (32, 128, 16)])
def test_int8_matmul_block_sizes_equal_jax(bm, bk, bn):
    x, w, rs = _codes(128, 256, 128, bm + bk + bn)
    scale = rs.uniform(1e-3, 1e-1, 128).astype(np.float32)
    got = TI.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
                         bm=bm, bk=bk, bn=bn)
    want = j_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), bm=bm, bk=bk,
                         bn=bn, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (M, K, N, bm, bk, bn): the shapes the tensor-core kernel tells apart that
# JAX's tile rules allow — caller tiles far below its own block tile, M and N
# no multiple of 64, K = 1, K ending inside a 32-deep step (24, 33, 100) or
# on a 16-deep tail (48), and sums past 2^24 (K >= 1152 with -128 rows)
SMALL_TILE_CASES = [(8, 33, 8, 8, 33, 8), (16, 1, 16, 8, 1, 8), (24, 100, 40, 8, 20, 8),
                    (72, 48, 136, 24, 16, 8), (136, 24, 72, 8, 8, 24),
                    (64, 2048, 24, 64, 256, 24), (200, 1152, 136, 8, 128, 8)]


@pytest.mark.parametrize("M,K,N,bm,bk,bn", SMALL_TILE_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("per_cout", [False, True], ids=["scalar", "per_cout"])
def test_int8_matmul_small_tiles_and_k_tails_equal_jax(M, K, N, bm, bk, bn, per_cout):
    x, w, rs = _codes(M, K, N, M + K + N + bm)
    scale = (rs.uniform(1e-3, 1e-1, N).astype(np.float32) if per_cout
             else np.asarray([1.0 / 512], np.float32))
    got = TI.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
                         bm=bm, bk=bk, bn=bn)
    want = j_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), bm=bm, bk=bk,
                         bn=bn, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), TR.int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                        torch.from_numpy(scale)).numpy())
    if K >= 1152:       # sums past 2^24: the int -> f32 conversion rounds
        assert np.abs(x.astype(np.int64) @ w.astype(np.int64)).max() > 2 ** 24


def test_int8_matmul_refusals():
    """What the JAX wrapper refuses, the port refuses too (as exceptions
    with a message, where JAX asserts)."""
    x, w, _ = _codes(128, 128, 128, 1)
    xt, wt, s = torch.from_numpy(x), torch.from_numpy(w), torch.tensor([0.5])
    with pytest.raises(TypeError, match="int8 codes"):
        TI.int8_matmul(xt.float(), wt, s)
    with pytest.raises(TypeError, match="int8 codes"):
        TI.int8_matmul(xt, wt.to(torch.int32), s)
    for bad, kw in (((xt[:100], wt), {}), ((xt, wt), {"bk": 96}),
                    ((xt, wt), {"bn": 96}), ((xt[:, :100], wt[:100]), {})):
        with pytest.raises(ValueError, match="tile-aligned"):
            TI.int8_matmul(*bad, s, **kw)
        with pytest.raises(AssertionError):
            j_int8_matmul(jnp.asarray(bad[0].numpy()), jnp.asarray(bad[1].numpy()),
                          jnp.asarray([0.5], jnp.float32), interpret=True, **kw)
    with pytest.raises(ValueError, match="scale must be"):
        TI.int8_matmul(xt, wt, torch.ones(7))
    with pytest.raises(ValueError, match="do not chain"):
        TI.int8_matmul(xt, wt[:64], s)


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (100, 256, 128), (256, 384, 256)])
def test_fixed_point_matmul_matches_jax(M, K, N):
    """``tests/test_kernels.py``'s shapes: the forward bit-exact against the
    JAX function and against the integer oracle; the straight-through
    backward within 1e-4 of ``jax.grad``."""
    rng = np.random.RandomState(M + K + N)
    x = rng.uniform(-4, 4, (M, K)).astype(np.float32)
    w = rng.uniform(-2, 2, (K, N)).astype(np.float32)
    g = rng.randn(M, N).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = TO.fixed_point_matmul(xt, wt)
    jout = JO.fixed_point_matmul(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    expect = TR.int8_matmul_ref(TQ.to_int(torch.from_numpy(x), TQ.Q3_4),
                                TQ.to_int(torch.from_numpy(w), TQ.Q2_5),
                                1.0 / (TQ.Q3_4.scale * TQ.Q2_5.scale))
    assert torch.equal(out.detach(), expect)
    out.backward(torch.from_numpy(g))
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(JO.fixed_point_matmul(a, b) * g),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    assert float(np.abs(xt.grad.numpy() - np.asarray(jdx)).max()) <= 1e-4
    assert float(np.abs(wt.grad.numpy() - np.asarray(jdw)).max()) <= 1e-4


def test_fixed_point_matmul_lead_dims_and_formats():
    """Leading batch dims reshape around the 2-D product; other Q formats
    set the codes and the scalar dequant; the forward keeps x's dtype."""
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (2, 3, 10, 128)).astype(np.float32)
    w = rng.uniform(-1, 1, (128, 128)).astype(np.float32)
    fmt = dict(x_fmt=TQ.QFormat(1, 6), w_fmt=TQ.QFormat(0, 7))
    out = TO.fixed_point_matmul(torch.from_numpy(x), torch.from_numpy(w), **fmt, bm=16)
    jout = JO.fixed_point_matmul(jnp.asarray(x), jnp.asarray(w), JQ.QFormat(1, 6),
                                 JQ.QFormat(0, 7), bm=16)
    assert tuple(out.shape) == (2, 3, 10, 128) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_fixed_point_backward_only_what_is_asked():
    """The backward computes only the gradients autograd asks for; its dw
    is the float ``x2dᵀ g2d``, not a product of codes."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.uniform(-4, 4, (2, 64, 128)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-2, 2, (128, 128)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(2, 64, 128).astype(np.float32))
    TO.fixed_point_matmul(x, w).backward(g)
    assert x.grad is None
    assert torch.allclose(w.grad, x.reshape(-1, 128).T @ g.reshape(-1, 128),
                          rtol=0, atol=1e-4)


def test_launch_counts_name_int8_matmul():
    TK.reset_launch_counts()
    counts = TK.launch_counts()
    assert set(counts) == {"block_sparse_matmul", "implicit_block_sparse_conv",
                           "block_sparse_grad_weight", "int8_matmul"}
    assert set(counts.values()) == {0}


@pytest.mark.parametrize("K", [1023, 1024, 1040, 1041])
def test_int_matmul_exact_with_minus_128_codes(K):
    """The CPU's f32 route is exact only while K·128² < 2^24 (−128 × −128 =
    2^14); past that the int32 matmul takes over."""
    a = torch.full((2, K), -128, dtype=torch.int8)
    b = torch.full((K, 3), -128, dtype=torch.int8)
    got = TR.int_matmul_exact(a, b)
    assert got.dtype == torch.int32 and int(got[0, 0]) == K * 16384
