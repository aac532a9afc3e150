"""Port vs JAX package: the trainable branch of ``make_sparse_conv`` — one
conv layer forward and backward through the block-sparse kernels (K2 or K1
forward, K1 on the transposed plan for dX, K3 for dW) under an
``autograd.Function``, against JAX's ``custom_vjp`` (Pallas in interpret
mode) on the same numpy inputs.

Tolerances: f32 values within 1e-5 and gradients within 1e-4 (other
summation orders, the bar the JAX package holds its own sparse-vs-dense
grads to). Pruned positions get exactly 0.0."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import fpga_conv_groups
from repro.sparse.conv_plan import conv_gemm_layout as j_layout
from repro.sparse.conv_plan import make_sparse_conv as j_conv
from repro_torch.core import fpga_conv_groups as t_groups
from repro_torch.models import cnn as TC
from repro_torch.sparse.conv_plan import conv_gemm_layout as t_layout
from repro_torch.sparse.conv_plan import make_sparse_conv as t_conv

GRAD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _group_mask(rng, n, density):
    if density <= 0.0:
        return np.zeros(n, np.float32)
    if density >= 1.0:
        return np.ones(n, np.float32)
    return (rng.rand(n) < density).astype(np.float32)


# the cases of tests/test_sparse_train.py::GRAD_CASES:
# stride {1,2} x SAME/VALID x density {0, .3, 1} x layout x forward kernel
GRAD_CASES = [
    # stride padding cin cout n_cu density packed implicit
    (1, "SAME", 16, 32, 12, 0.3, True, True),
    (2, "SAME", 16, 32, 12, 0.3, True, False),
    (1, "VALID", 9, 10, 4, 0.3, True, True),
    (2, "VALID", 5, 12, 4, 0.3, True, True),
    (1, "SAME", 3, 10, 4, 0.3, False, False),   # one-group-per-tile layout
    (2, "SAME", 5, 12, 4, 0.3, False, False),
    (1, "SAME", 8, 16, 4, 1.0, True, True),     # fully dense plan
    (1, "SAME", 16, 32, 12, 0.0, True, True),   # fully pruned -> zero grads
    (2, "SAME", 5, 12, 4, 0.3, False, True),    # unpacked, implicit forward
]


@pytest.mark.parametrize(
    "stride,padding,cin,cout,n_cu,density,packed,implicit", GRAD_CASES)
def test_trainable_conv_grads_match_jax(stride, padding, cin, cout, n_cu,
                                        density, packed, implicit):
    rng = np.random.RandomState(hash((stride, cin, cout, density)) % 2**31)
    jspec = fpga_conv_groups((3, 3, cin, cout), n_cu)
    gm = _group_mask(rng, jspec.num_groups, density)
    em = t_groups((3, 3, cin, cout), n_cu).expand(gm)
    w = rng.randn(3, 3, cin, cout).astype(np.float32)
    x = rng.randn(2, 9, 8, cin).astype(np.float32)

    jc = j_conv(j_layout(jspec, packed=packed), gm, implicit=implicit,
                trainable=True)
    tc = t_conv(t_layout(t_groups((3, 3, cin, cout), n_cu), packed=packed), gm,
                implicit=implicit, trainable=True)
    assert tc.trainable and tc.implicit == jc.implicit

    jf, (jdx, jdw) = jax.value_and_grad(
        lambda a, b: jnp.sum(jnp.sin(jc(a, b, stride, padding))), (0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    tf = torch.sum(torch.sin(tc(tx, tw, stride, padding)))
    tf.backward()
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=GRAD_TOL, atol=GRAD_TOL)
    # no-resurrection: pruned positions get bitwise-zero gradient
    assert float(torch.max(torch.abs(tw.grad * (1 - em)))) == 0.0
    if density == 0.0:
        assert float(tw.grad.abs().max()) == 0.0 and float(tx.grad.abs().max()) == 0.0


@pytest.mark.parametrize("packed,lanes", [(False, 12), (True, 120)])
@pytest.mark.parametrize("implicit", [False, True])
def test_dx_reads_only_the_layout_output_lanes(monkeypatch, packed, lanes, implicit):
    """The trainable conv's dX (the block-sparse matmul on the transposed
    plan) is told the layout's ``output_lanes`` (12 of 128 unpacked, 120
    packed at n_cu = 12) as ``x_lanes``, and its gradients still equal
    JAX's, whose kernel reads every lane."""
    from repro_torch.kernels import ops as TO
    seen = []
    real = TO.block_sparse_matmul

    def spy(*a, **k):
        seen.append(k.get("x_lanes"))
        return real(*a, **k)

    monkeypatch.setattr(TO, "block_sparse_matmul", spy)
    rng = np.random.RandomState(5)
    cin, cout, n_cu = 16, 32, 12
    jspec = fpga_conv_groups((3, 3, cin, cout), n_cu)
    gm = _group_mask(rng, jspec.num_groups, 0.5)
    tlayout = t_layout(t_groups((3, 3, cin, cout), n_cu), packed=packed)
    assert tlayout.output_lanes == lanes
    w = rng.randn(3, 3, cin, cout).astype(np.float32)
    x = rng.randn(2, 6, 6, cin).astype(np.float32)
    jc = j_conv(j_layout(jspec, packed=packed), gm, implicit=implicit, trainable=True)
    tc = t_conv(tlayout, gm, implicit=implicit, trainable=True)
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(jnp.sin(jc(a, b, 1, "SAME"))), (0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    torch.sum(torch.sin(tc(tx, tw, 1, "SAME"))).backward()
    assert seen and seen[-1] == lanes      # the dX call, after any forward one
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_trainable_conv_reuses_geometry_and_never_goes_stale():
    """The per-(kx,ky,stride,padding) autograd closures are cached; a call
    with new weights is right (nothing is prepacked). The reference is the
    library convolution of the masked weight."""
    rng = np.random.RandomState(3)
    spec = t_groups((3, 3, 8, 16), 4)
    gm = _group_mask(rng, spec.num_groups, 0.5)
    em = spec.expand(gm)
    conv = t_conv(t_layout(spec, packed=True), gm, trainable=True)
    x = _t(rng.randn(2, 8, 8, 8).astype(np.float32))
    w1 = _t(rng.randn(3, 3, 8, 16).astype(np.float32))
    for w in (w1, w1 * 2.0):
        wa, wb = w.clone().requires_grad_(), w.clone().requires_grad_()
        torch.sum(conv(x, wa, 1, "SAME") ** 2).backward()
        torch.sum(TC._conv(x, wb * em, 1) ** 2).backward()
        np.testing.assert_allclose(wa.grad.numpy(), wb.grad.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_trainable_rejects_inference_epilogues():
    spec = t_groups((3, 3, 8, 16), 4)
    gm = np.ones(spec.num_groups, np.float32)
    with pytest.raises(ValueError, match="inference-only"):
        t_conv(t_layout(spec, packed=True), gm, trainable=True, relu=True)
    conv = t_conv(t_layout(spec, packed=True), gm, trainable=True)
    with pytest.raises(ValueError, match="no weight bound"):
        conv(torch.zeros(1, 8, 8, 8))
