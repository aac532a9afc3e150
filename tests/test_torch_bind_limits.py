"""The port's bind-time limits, on the CPU.

- ``bm`` above the CUDA kernels' cap (``KERNEL_MAX_BM`` = 128 rows per
  M-block) is refused at bind when the bind's device is CUDA:
  ``make_sparse_conv`` raises ``ValueError``, ``bind_execution``
  ``PermanentBindError``, both before anything is put on the card, so the
  refusal needs no card. The same binds on the CPU run any ``bm`` and equal
  the JAX package's output (which runs any ``bm``): convs bound with
  ``bm=256`` at f32 <= 1e-5 (summation order), streamed int8 codes bit-equal,
  logits of a whole streamed network <= 1e-6 (only the head's mean + matmul
  differ).
- ``window_fits_card`` accepts every window it accepted under the f32
  instance's rule before the tensor-core redesign (window at 4 bytes an
  element beside one 32-row x 128-lane f32 weight slice), at every layer of
  the CIFAR ResNet in both tile layouts and at every window the GPU kernel
  tests run, so no layer moves to the materializing path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import groups as JG, hapm as JH, masks as JM, quant as JQ
from repro.models import cnn as JC
from repro.sparse import conv_plan as JP
from repro_torch.core import groups as TG, quant as TQ
from repro_torch.kernels import implicit_conv as TI
from repro_torch.kernels.conv_lowering import conv_out_size
from repro_torch.models import cnn as TC
from repro_torch.sparse import conv_plan as TP

from test_torch_gpu_kernels import CONV_CASES, IMMA_CASES

CUDA = torch.device("cuda")   # a device name: creating it needs no card


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer(k, cin, cout, packed, seed, n_cu=4):
    rs = np.random.RandomState(seed)
    shape = (k, k, cin, cout)
    jl = JP.conv_gemm_layout(JG.fpga_conv_groups(shape, n_cu), packed=packed)
    tl = TP.conv_gemm_layout(TG.fpga_conv_groups(shape, n_cu), packed=packed)
    gm = (rs.rand(tl.spec.num_groups) < 0.5).astype(np.float32)
    w = (rs.randn(*shape) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
    b = (0.2 * rs.randn(cout)).astype(np.float32)
    return jl, tl, gm, w, b


# --- bm above the cap on CUDA: refused at bind -----------------------------

@pytest.mark.parametrize("bm", [129, 256])
@pytest.mark.parametrize("implicit", [None, False])
@pytest.mark.parametrize("trainable", [False, True])
def test_make_sparse_conv_refuses_bm_over_cap_on_cuda(bm, implicit, trainable):
    _, tl, gm, _, _ = _layer(3, 8, 16, False, 0)
    for device in (CUDA, "cuda:0"):
        with pytest.raises(ValueError, match=rf"bm={bm} .*bm <= 128"):
            TP.make_sparse_conv(tl, gm, bm=bm, device=device, implicit=implicit,
                                trainable=trainable)


def test_bind_execution_refuses_bm_over_cap_on_cuda(monkeypatch):
    """The resolved device is CUDA (resolution stubbed: no card here): the
    bind raises ``PermanentBindError`` naming the field, value and cap,
    before any layer reaches ``make_sparse_conv``."""
    cfg = TC.ResNetConfig(stages=(1,), widths=(8,), image_size=8)
    rs = np.random.RandomState(0)
    params = {"conv0": {"w": _t(rs.randn(3, 3, 3, 8).astype(np.float32))}}

    def no_layer(*a, **k):
        raise AssertionError("a layer was bound before the bm check")

    monkeypatch.setattr(TC, "resolve_device", lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(TP, "make_sparse_conv", no_layer)
    for spec in (TC.ExecSpec(bm=256, dense_fallback=2.0),
                 TC.ExecSpec(bm=129, trainable=True, n_cu=4),
                 TC.ExecSpec(bm=256, quantized=True, folded=True, streamed=True)):
        with pytest.raises(TC.PermanentBindError, match=rf"ExecSpec.bm={spec.bm} .*bm <= 128"):
            TC.bind_execution(params, cfg, spec=spec, device="cuda")
    # the check sits on the device, not on the spec: accounting binds pass
    acc = TC.bind_execution(params, cfg, spec=TC.ExecSpec(bm=256, n_cu=4),
                            bind_kernels=False)
    assert all(v is None for v in acc.table.values())


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("implicit", [None, False])
@pytest.mark.parametrize("mode", ["f32", "streamed"])
def test_cpu_bind_with_bm_256_equals_jax(packed, implicit, mode):
    jl, tl, gm, w, b = _layer(3, 8, 16, packed, 2)
    jq = tq = jo = to = None
    if mode == "streamed":
        jq, tq = JQ.QuantSpec.calibrate(jnp.asarray(w)), TQ.QuantSpec.calibrate(_t(w))
        jo, to = JQ.QuantSpec(), TQ.QuantSpec()
    jc = JP.make_sparse_conv(jl, gm, bm=256, weight=jnp.asarray(w), bias=jnp.asarray(b),
                             relu=True, quant=jq, out_quant=jo, implicit=implicit)
    tc = TP.make_sparse_conv(tl, gm, bm=256, weight=_t(w), bias=_t(b), relu=True,
                             quant=tq, out_quant=to, implicit=implicit, device="cpu")
    x = np.maximum(np.random.RandomState(3).randn(2, 16, 16, 8), 0).astype(np.float32)
    if implicit is None:
        assert TI.choose_m_block(16, 16, cap=256).bm == 256     # over the kernels' cap
    jy = np.asarray(jc(jnp.asarray(x)))
    ty = tc(_t(x)).numpy()
    if mode == "f32":
        np.testing.assert_allclose(ty, jy, atol=1e-5)
    else:
        np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("packed", [False, True])
def test_cpu_bind_execution_with_bm_256_equals_jax(packed):
    kw = dict(stages=(1, 1), widths=(8, 16), image_size=16)
    jcfg, tcfg = JC.ResNetConfig(**kw), TC.ResNetConfig(**kw)
    params, state = JC.init(jax.random.PRNGKey(1), jcfg)
    specs = JC.conv_group_specs(params, 4)
    hcfg = JH.HAPMConfig(0.5, 1)
    st = JH.hapm_epoch_update(JH.hapm_init(specs, hcfg), specs, params, hcfg)
    params = JM.apply_masks(params, JH.hapm_element_masks(specs, st))
    jfold = JC.fold_batchnorm(params, state, jcfg)
    tfold = TC.tree_from_numpy(jax.tree.map(np.asarray, jfold), device="cpu")
    spec = dict(n_cu=4, packed=packed, quantized=True, folded=True, streamed=True,
                dense_fallback=2.0, bm=256)
    je = JC.bind_execution(jfold, jcfg, spec=JC.ExecSpec(**spec))
    te = TC.bind_execution(tfold, tcfg, spec=TC.ExecSpec(**spec), device="cpu")
    assert all(v is not None for v in te.table.values())
    x = np.random.RandomState(4).rand(3, 16, 16, 3).astype(np.float32)
    jy = JC.apply_folded(jfold, jnp.asarray(x), jcfg, sparse=je)
    ty = TC.apply_folded(tfold, _t(x), tcfg, sparse=te)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)


# --- window_fits_card keeps every window it took ---------------------------

def _rule_before(rows, cols, cpk):
    """The acceptance rule before the tensor-core redesign: the window at 4
    bytes an element beside one 32-row, 128-lane f32 weight slice."""
    return -(-rows * cols * cpk // 4) * 4 * 4 + 32 * 128 * 4 <= 232448


def _cifar_windows():
    """(name, packed, rows, cols, cpk) of every conv of the CIFAR ResNet
    (stages (3, 3, 3), widths (16, 32, 64), 32x32, n_cu = 12)."""
    cfg = TC.ResNetConfig()
    feat, cin = cfg.image_size, cfg.in_channels
    convs = [("conv0", feat, 1, 3, cin, cfg.widths[0])]
    cin = cfg.widths[0]
    for si, n in enumerate(cfg.stages):
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            width = cfg.widths[si]
            convs.append((f"s{si}b{bi}/conv1", feat, stride, 3, cin, width))
            out = -(-feat // stride)
            convs.append((f"s{si}b{bi}/conv2", out, 1, 3, width, width))
            if stride != 1 or cin != width:
                convs.append((f"s{si}b{bi}/proj", feat, stride, 1, cin, width))
            feat, cin = out, width
    for name, h, stride, k, cin, cout in convs:
        for packed in (False, True):
            layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), 12),
                                         packed=packed)
            ho = conv_out_size(h, k, stride, "SAME")
            mb = TI.choose_m_block(ho, ho)
            yield (name, packed, *TI.window_shape(mb, k, k, stride),
                   layout.implicit_geometry()["cpk"])


def _test_windows():
    """(case, packed, rows, cols, cpk) of every window the GPU kernel tests
    run (``CONV_CASES`` at n_cu = 4, ``IMMA_CASES`` at their own n_cu)."""
    cases = [(c, 4) for c in CONV_CASES] + [(c[:8], c[8]) for c in IMMA_CASES]
    for (k, cin, cout, stride, h, w_, _, cap), n_cu in cases:
        for packed in (False, True):
            layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), n_cu),
                                         packed=packed)
            mb = TI.choose_m_block(conv_out_size(h, k, stride, "SAME"),
                                   conv_out_size(w_, k, stride, "SAME"), cap=cap)
            yield ((k, cin, cout, stride, h, w_, cap), packed,
                   *TI.window_shape(mb, k, k, stride), layout.implicit_geometry()["cpk"])


def test_window_fits_card_keeps_every_cifar_layer_implicit():
    windows = list(_cifar_windows())
    assert len(windows) == 2 * 21
    for name, packed, rows, cols, cpk in windows:
        assert _rule_before(rows, cols, cpk), (name, packed)
        assert TI.window_fits_card(rows, cols, cpk), (name, packed, rows, cols, cpk)
        # the JAX package's accounting rule, the other condition of the path
        assert 2 * rows * cols * cpk * 4 <= TI.SLAB_VMEM_BUDGET, (name, packed)


def test_window_fits_card_keeps_every_test_window():
    windows = list(_test_windows())
    assert len(windows) == 2 * (len(CONV_CASES) + len(IMMA_CASES))
    for case, packed, rows, cols, cpk in windows:
        assert _rule_before(rows, cols, cpk), (case, packed)
        assert TI.window_fits_card(rows, cols, cpk), (case, packed, rows, cols, cpk)


@pytest.mark.parametrize("rows,cols,cpk", [
    (1, 1, 1), (6, 34, 8), (73, 73, 8), (29, 61, 16), (100, 100, 5), (120, 120, 3),
    (1, 54016, 1), (1, 54020, 1), (128, 128, 8), (233, 233, 1)])
def test_window_fits_card_accepts_what_it_accepted(rows, cols, cpk):
    """At and around the limit: everything the old rule took is taken."""
    if _rule_before(rows, cols, cpk):
        assert TI.window_fits_card(rows, cols, cpk)
