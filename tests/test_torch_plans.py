"""Port vs JAX package: the host-side half — layouts, plans, packed arrays,
byte counts, fingerprints, conv lowering and M-block geometry. Arrays, ints
and hex digests must be **equal**: the port keeps every table and byte
count of the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import groups as JG
from repro.kernels import conv_lowering as JL, implicit_conv as JI
from repro.launch import exec_cache as JE
from repro.models import cnn as JC
from repro.sparse import block_mask as JB, conv_plan as JP
from repro_torch.core import groups as TG
from repro_torch.kernels import conv_lowering as TL, implicit_conv as TI
from repro_torch.launch import exec_cache as TE
from repro_torch.models import cnn as TC
from repro_torch.sparse import block_mask as TB, conv_plan as TP


def _t(a):
    return torch.from_numpy(np.array(a))


def _layouts(kind, shape, n_cu=4):
    if kind == "tile":
        kx, ky, cin, cout = shape
        js = JG.tpu_tile_groups((kx * ky * cin, cout), (16, 128))
        ts = TG.tpu_tile_groups((kx * ky * cin, cout), (16, 128))
        return JP.conv_gemm_layout(js), TP.conv_gemm_layout(ts)
    js, ts = JG.fpga_conv_groups(shape, n_cu), TG.fpga_conv_groups(shape, n_cu)
    packed = kind == "packed"
    return (JP.conv_gemm_layout(js, packed=packed),
            TP.conv_gemm_layout(ts, packed=packed))


LAYOUT_CASES = [(kind, shape) for kind in ("unpacked", "packed", "tile")
                for shape in [(3, 3, 5, 10), (1, 1, 8, 16), (3, 3, 20, 7)]]


@pytest.mark.parametrize("kind,shape", LAYOUT_CASES)
def test_layout_tables_and_packing_equal(kind, shape):
    rs = np.random.RandomState(0)
    jl, tl = _layouts(kind, shape)
    assert type(jl).__name__ == type(tl).__name__
    assert (jl.block, jl.tiles, jl.k_packed, jl.n_packed) == \
        (tl.block, tl.tiles, tl.k_packed, tl.n_packed)
    assert jl.implicit_geometry() == tl.implicit_geometry()
    gm = (rs.rand(jl.spec.num_groups) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(jl.tile_mask(gm), tl.tile_mask(gm))
    jp, tp = jl.plan(gm), tl.plan(gm)
    np.testing.assert_array_equal(jp.idx, tp.idx)
    np.testing.assert_array_equal(jp.cnt, tp.cnt)
    assert (jp.max_nnz, jp.density, jp.skipped_tiles, jp.block, jp.tiles) == \
        (tp.max_nnz, tp.density, tp.skipped_tiles, tp.block, tp.tiles)
    for a, b in zip(jl.tile_occupancy(gm), tl.tile_occupancy(gm)):
        np.testing.assert_array_equal(a, b)
    assert jl.mac_accounting(gm) == tl.mac_accounting(gm)
    assert jl.mac_utilization(gm) == tl.mac_utilization(gm)
    kx, ky, cin, cout = shape
    w = rs.randn(*shape).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    patches = rs.randn(2, 3, 3, kx, ky, cin).astype(np.float32)
    np.testing.assert_array_equal(tl.pack_weight(_t(w)).numpy(),
                                  np.asarray(jl.pack_weight(jnp.asarray(w))))
    np.testing.assert_array_equal(tl.pack_bias(_t(b)).numpy(),
                                  np.asarray(jl.pack_bias(jnp.asarray(b))))
    np.testing.assert_array_equal(tl.pack_patches(_t(patches)).numpy(),
                                  np.asarray(jl.pack_patches(jnp.asarray(patches))))
    out2d = rs.randn(18, jl.n_packed).astype(np.float32)
    np.testing.assert_array_equal(
        tl.unpack_output(_t(out2d), (2, 3, 3)).numpy(),
        np.asarray(jl.unpack_output(jnp.asarray(out2d), (2, 3, 3))))
    if kind == "tile":
        with pytest.raises(ValueError, match="no implicit-im2col table"):
            tl.implicit_index_table(gm)
    else:
        for a, b2 in zip(jl.implicit_index_table(gm), tl.implicit_index_table(gm)):
            np.testing.assert_array_equal(a, b2)


@pytest.mark.parametrize("kind,shape", [c for c in LAYOUT_CASES if c[0] != "tile"])
@pytest.mark.parametrize("implicit", [True, False])
def test_conv_hbm_bytes_equal(kind, shape, implicit):
    rs = np.random.RandomState(1)
    jl, tl = _layouts(kind, shape)
    gm = (rs.rand(jl.spec.num_groups) > 0.4).astype(np.float32)
    for batch, h, stride, bm, ob, out_b in [(1, 16, 1, "auto", None, None),
                                            (4, 9, 2, 128, 1, None),
                                            (2, 32, 2, "auto", 1, 1)]:
        kw = dict(implicit=implicit, bm=bm, operand_bytes=ob, out_bytes=out_b)
        assert (JP.conv_hbm_bytes(jl, gm, batch, h, h, stride, "SAME", **kw)
                == TP.conv_hbm_bytes(tl, gm, batch, h, h, stride, "SAME", **kw))


def test_layout_errors_equal():
    with pytest.raises(ValueError, match="exceeds the 128-lane tile"):
        TP.conv_gemm_layout(TG.fpga_conv_groups((3, 3, 4, 8), 200))
    with pytest.raises(TypeError, match="no conv GEMM layout"):
        TP.conv_gemm_layout(TG.flat_groups((3, 3, 4, 8)))
    with pytest.raises(ValueError, match="2-D im2col"):
        TP.conv_gemm_layout(TG.tpu_tile_groups((2, 32, 128)))


def test_block_mask_module_equal():
    rs = np.random.RandomState(2)
    w = rs.randn(40, 300).astype(np.float32) * (rs.rand(40, 300) > 0.97)
    jm, tm = JB.tile_mask_from_weight(w, (16, 128)), TB.tile_mask_from_weight(w, (16, 128))
    np.testing.assert_array_equal(jm, tm)
    jp, tp = JB.plan_from_weight(w, (16, 128)), TB.plan_from_weight(w, (16, 128))
    np.testing.assert_array_equal(jp.idx, tp.idx)
    np.testing.assert_array_equal(jp.cnt, tp.cnt)
    jt, tt = JB.transpose_plan(jp, jm), TB.transpose_plan(tp, tm)
    np.testing.assert_array_equal(jt.idx, tt.idx)
    assert jt.block == tt.block == (128, 16)


@pytest.mark.parametrize("n,k,stride", [(32, 3, 1), (32, 3, 2), (15, 3, 2),
                                        (16, 1, 2), (7, 5, 3), (9, 2, 2)])
def test_conv_sizes_and_pads_equal(n, k, stride):
    assert JL.same_pads(n, k, stride) == TL.same_pads(n, k, stride)
    for padding in ("SAME", "VALID"):
        assert JL.conv_out_size(n, k, stride, padding) == \
            TL.conv_out_size(n, k, stride, padding)


def test_conv_out_size_errors():
    with pytest.raises(ValueError, match="VALID conv has no output"):
        TL.conv_out_size(2, 3, 1, "VALID")
    with pytest.raises(ValueError, match="padding must be SAME or VALID"):
        TL.conv_out_size(8, 3, 1, "FULL")


@pytest.mark.parametrize("h,k,stride,padding", [(8, 3, 1, "SAME"), (9, 3, 2, "SAME"),
                                                (8, 1, 2, "SAME"), (8, 3, 2, "VALID"),
                                                (7, 2, 1, "SAME")])
def test_im2col_and_conv_via_matmul_equal(h, k, stride, padding):
    rs = np.random.RandomState(3)
    x = rs.randn(2, h, h + 1, 3).astype(np.float32)
    w = rs.randn(k, k, 3, 5).astype(np.float32)
    np.testing.assert_array_equal(
        TL.im2col_patches(_t(x), k, k, stride, padding).numpy(),
        np.asarray(JL.im2col_patches(jnp.asarray(x), k, k, stride, padding)))
    jy = np.asarray(JL.conv_via_matmul(jnp.asarray(x), jnp.asarray(w), stride, padding))
    ty = TL.conv_via_matmul(_t(x), _t(w), stride, padding).numpy()
    np.testing.assert_allclose(ty, jy, atol=1e-5)   # f32 summation order
    # and the library conv on explicitly padded input is the same function
    if padding == "SAME":
        np.testing.assert_allclose(TC._conv(_t(x), _t(w), stride).numpy(),
                                   np.asarray(JC._conv(jnp.asarray(x), jnp.asarray(w), stride)),
                                   atol=1e-5)


M_BLOCK_CASES = [(32, 32, 128), (16, 16, 128), (8, 8, 128), (4, 4, 128),
                 (3, 200, 128), (5, 7, 16), (2, 2, 4), (0, 4, 128), (1, 1, 8)]


@pytest.mark.parametrize("ho,wo,cap", M_BLOCK_CASES)
def test_choose_m_block_and_window_equal(ho, wo, cap):
    jm, tm = JI.choose_m_block(ho, wo, cap), TI.choose_m_block(ho, wo, cap)
    assert (jm is None) == (tm is None)
    if jm is not None:
        assert tuple(jm) == tuple(tm)
        for k, s in [(3, 1), (3, 2), (1, 2)]:
            assert JI.window_shape(jm, k, k, s) == TI.window_shape(tm, k, k, s)


@pytest.mark.parametrize("h,w,k,stride,padding,cap", [
    (8, 8, 3, 1, "SAME", 128), (9, 9, 3, 2, "SAME", 128), (8, 8, 1, 2, "SAME", 128),
    (6, 40, 3, 1, "SAME", 16), (10, 10, 3, 2, "VALID", 128), (5, 5, 3, 1, "SAME", 8)])
def test_pad_input_and_crop_output_equal(h, w, k, stride, padding, cap):
    rs = np.random.RandomState(4)
    x = rs.randn(2, h, w, 3).astype(np.float32)
    ho, wo = (TL.conv_out_size(n, k, stride, padding) for n in (h, w))
    jm, tm = JI.choose_m_block(ho, wo, cap), TI.choose_m_block(ho, wo, cap)
    jx = np.asarray(JI.pad_input(jnp.asarray(x), k, k, stride, padding, jm, 8))
    tx = TI.pad_input(_t(x), k, k, stride, padding, tm, 8).numpy()
    np.testing.assert_array_equal(jx, tx)
    out2d = rs.randn(2 * jm.bpi * jm.bm, 24).astype(np.float32)
    np.testing.assert_array_equal(
        TI.crop_output(_t(out2d), tm, 2, ho, wo).numpy(),
        np.asarray(JI.crop_output(jnp.asarray(out2d), jm, 2, ho, wo)))


def test_slab_budget_kept_and_card_condition():
    assert TI.SLAB_VMEM_BUDGET == JI.SLAB_VMEM_BUDGET == 2 * 1024 * 1024
    # every window of the CIFAR ResNet fits both conditions
    for rows, cols, cpk in [(6, 34, 8), (17, 33, 8), (10, 18, 8), (15, 31, 16),
                            (17, 17, 8), (10, 10, 8), (15, 15, 16)]:
        assert TI.window_fits_card(rows, cols, cpk)
        assert 2 * rows * cols * cpk * 4 <= TI.SLAB_VMEM_BUDGET
    assert not TI.window_fits_card(128, 128, 8)


def _np_model(cfg_kw, seed=0):
    jp, js = JC.init(jax.random.PRNGKey(seed), JC.ResNetConfig(**cfg_kw))
    return jp, js, jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)


@pytest.mark.parametrize("cfg_kw", [dict(stages=(1, 1), widths=(8, 16), image_size=16),
                                    dict(stages=(2, 1, 1), widths=(4, 8, 8), image_size=8,
                                         quantized=True)])
def test_fingerprints_equal(cfg_kw):
    jp, js, np_p, np_s = _np_model(cfg_kw)
    tp, ts = TC.params_from_numpy(np_p, np_s, device="cpu")
    jcfg, tcfg = JC.ResNetConfig(**cfg_kw), TC.ResNetConfig(**cfg_kw)
    assert repr(jcfg) == repr(tcfg)
    assert JE.arch_fingerprint(jcfg, jp) == TE.arch_fingerprint(tcfg, tp)
    # flat {path: mask} form
    quantized = bool(cfg_kw.get("quantized"))
    jm = JC.derive_group_masks(jp, 4, quantized=quantized)
    tm = TC.derive_group_masks(tp, 4, quantized=quantized)
    assert jm.keys() == tm.keys()
    for k in jm:
        np.testing.assert_array_equal(jm[k], tm[k])
    assert JP.mask_fingerprint(jm) == TP.mask_fingerprint(tm)
    # tree form (path strings hashed)
    from repro.core import hapm as JH
    from repro_torch.core import hapm as TH
    jst = JH.hapm_init(JC.conv_group_specs(jp, 4), JH.HAPMConfig())
    tst = TH.hapm_init(TC.conv_group_specs(tp, 4), TH.HAPMConfig())
    jst.group_masks["conv0"]["w"][::2] = 0
    tst.group_masks["conv0"]["w"][::2] = 0
    assert JP.mask_fingerprint(jst.group_masks) == TP.mask_fingerprint(tst.group_masks)
    tst.group_masks["conv0"]["w"][1] = 0
    assert JP.mask_fingerprint(jst.group_masks) != TP.mask_fingerprint(tst.group_masks)


def test_params_round_trip_and_layer_order():
    cfg_kw = dict(stages=(1, 1), widths=(8, 16), image_size=16)
    jp, js, np_p, np_s = _np_model(cfg_kw)
    tp, ts = TC.params_from_numpy(np_p, np_s, device="cpu")
    back_p, back_s = TC.params_to_numpy(tp, ts)
    for a, b in zip(jax.tree.leaves(np_p), jax.tree.leaves(back_p)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(np_s), jax.tree.leaves(back_s)):
        np.testing.assert_array_equal(a, b)
    assert tp["conv0"]["w"].dtype == torch.float32
    assert JC.conv_layer_order(JC.ResNetConfig(**cfg_kw)) == \
        TC.conv_layer_order(TC.ResNetConfig(**cfg_kw))
    assert len(TC.conv_layer_order(TC.ResNetConfig())) == 21
    # init: the JAX package's key names and shapes, values from the generator
    ip, is_ = TC.init(torch.Generator().manual_seed(3), TC.ResNetConfig(**cfg_kw),
                      device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(ip) == shapes(np_p) and shapes(is_) == shapes(np_s)
    ip2, _ = TC.init(3, TC.ResNetConfig(**cfg_kw), device="cpu")
    assert torch.equal(ip["s1b0"]["proj"]["w"], ip2["s1b0"]["proj"]["w"])


def test_config_module():
    from repro_torch.configs import resnet21_cifar as R
    assert R.CONFIG == TC.ResNetConfig() and R.CONFIG_INT8.quantized
