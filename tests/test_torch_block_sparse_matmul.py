"""Port vs JAX package: the block-sparse matmul's module
(``kernels/block_sparse_matmul.py``, ``kernels/ops.py``, ``kernels/ref.py``).

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode. Same numpy inputs through both.

Tolerances: f32 <= 1e-5 (summation order). int8 outputs are exact integer
accumulations: bit-equal wherever the epilogue has one rounding (no bias),
and for requantized codes. With ``scale`` *and* ``bias`` the port rounds
``acc*scale`` and ``+bias`` separately — the kernel's documented order —
while XLA's CPU backend contracts the pair into one fused multiply-add;
there the port must equal the two-rounding numpy oracle **exactly** and the
JAX interpret result within one unit in the last place."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels import block_sparse_matmul as JK, ops as JO, ref as JR
from repro.sparse import block_mask as JB
from repro_torch.kernels import block_sparse_matmul as TK, launch_counts, ops as TO, ref as TR
from repro_torch.sparse import block_mask as TB


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _problem(M, K, N, block, dtype, seed, density=0.5, dead_column=True):
    rs = np.random.RandomState(seed)
    bk, bn = block
    tm = rs.rand(K // bk, N // bn) < density
    if dead_column:
        tm[:, -1] = False            # cnt == 0: the column still flushes bias
    plan = JB.plan_from_tile_mask(tm, block)
    if dtype == "int8":
        x = rs.randint(-127, 128, (M, K)).astype(np.int8)
        w = rs.randint(-127, 128, (K, N)).astype(np.int8)
    else:
        x = rs.randn(M, K).astype(np.float32)
        w = (rs.randn(K, N) / np.sqrt(K)).astype(np.float32)
    rows = {"bias": rs.randn(N).astype(np.float32),
            "scale": ((rs.rand(N) + 0.5) * 1e-3).astype(np.float32),
            "out_scale": np.full(N, 16.0, np.float32)}
    return x, w, tm, plan, rows


def _both(x, w, plan, block, bm, relu=False, bias=None, scale=None, out_scale=None):
    jy = JK.block_sparse_matmul(_j(x), _j(w), _j(plan.idx), _j(plan.cnt), _j(bias),
                                _j(scale), _j(out_scale), block=block, bm=bm,
                                relu=relu, interpret=True)
    ty = TK.block_sparse_matmul(_t(x), _t(w), _t(plan.idx), _t(plan.cnt), _t(bias),
                                _t(scale), _t(out_scale), block=block, bm=bm,
                                relu=relu)
    return np.asarray(jy), ty.numpy()


GEOMS = [  # (M, K, N, block, bm)
    (128, 256, 256, (128, 128), 128),     # packed tiles
    (64, 80, 384, (16, 128), 64),         # unpacked 3x3 tiles
    (8, 64, 256, (8, 128), 8),            # unpacked 1x1 tiles, smallest bm
    (48, 32, 128, (16, 128), 16),
]


@pytest.mark.parametrize("M,K,N,block,bm", GEOMS)
@pytest.mark.parametrize("epilogue", ["none", "bias_relu"])
def test_f32_matches_jax(M, K, N, block, bm, epilogue):
    x, w, tm, plan, rows = _problem(M, K, N, block, "f32", 0)
    kw = {} if epilogue == "none" else dict(bias=rows["bias"], relu=True)
    jy, ty = _both(x, w, plan, block, bm, **kw)
    assert ty.dtype == jy.dtype == np.float32
    np.testing.assert_allclose(ty, jy, atol=1e-5)
    if epilogue == "none":      # and both equal the dense masked product
        ref = TR.block_sparse_matmul_ref(_t(x), _t(w), tm, block).numpy()
        np.testing.assert_allclose(ty, ref, atol=1e-4)
        assert np.all(ty[:, -block[1]:] == 0)


@pytest.mark.parametrize("M,K,N,block,bm", GEOMS)
def test_int8_dequant_bit_equal(M, K, N, block, bm):
    x, w, tm, plan, rows = _problem(M, K, N, block, "int8", 1)
    jy, ty = _both(x, w, plan, block, bm, scale=rows["scale"])
    assert ty.dtype == jy.dtype == np.float32
    np.testing.assert_array_equal(ty, jy)
    m = TR.expand_tile_mask(tm, block, K, N).numpy().astype(np.int64)
    acc = x.astype(np.int64) @ (w.astype(np.int64) * m)
    np.testing.assert_array_equal(ty, acc.astype(np.float32) * rows["scale"])
    np.testing.assert_array_equal(
        TR.int8_matmul_ref(_t(x), _t(w) * _t(m).to(torch.int8), _t(rows["scale"])).numpy(),
        np.asarray(JR.int8_matmul_ref(_j(x), _j(w) * _j(m).astype(jnp.int8),
                                      _j(rows["scale"]))))


@pytest.mark.parametrize("M,K,N,block,bm", GEOMS)
def test_int8_bias_relu_two_roundings(M, K, N, block, bm):
    x, w, tm, plan, rows = _problem(M, K, N, block, "int8", 2)
    jy, ty = _both(x, w, plan, block, bm, scale=rows["scale"], bias=rows["bias"],
                   relu=True)
    m = TR.expand_tile_mask(tm, block, K, N).numpy().astype(np.int64)
    acc = (x.astype(np.int64) @ (w.astype(np.int64) * m)).astype(np.float32)
    oracle = np.maximum(acc * rows["scale"] + rows["bias"], np.float32(0))
    np.testing.assert_array_equal(ty, oracle)            # exactly the kernel's order
    np.testing.assert_allclose(ty, jy, rtol=2.5e-7, atol=1e-7)   # JAX/CPU fuses mul+add
    # the fully pruned column flushed relu(bias)
    np.testing.assert_array_equal(ty[:, -block[1]:],
                                  np.broadcast_to(np.maximum(rows["bias"][-block[1]:], 0),
                                                  (M, block[1])))


@pytest.mark.parametrize("M,K,N,block,bm", GEOMS)
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_requantized_codes_bit_equal(M, K, N, block, bm, with_bias):
    x, w, tm, plan, rows = _problem(M, K, N, block, "int8", 3)
    kw = dict(scale=rows["scale"], out_scale=rows["out_scale"], relu=with_bias)
    if with_bias:
        kw["bias"] = rows["bias"]
    jy, ty = _both(x, w, plan, block, bm, **kw)
    assert ty.dtype == jy.dtype == np.int8
    np.testing.assert_array_equal(ty, jy)
    assert np.abs(ty.astype(np.int32)).max() <= 127


def test_bf16_operands_accumulate_f32():
    x, w, tm, plan, rows = _problem(64, 64, 256, (16, 128), "f32", 4)
    xb, wb = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    ty = TK.block_sparse_matmul(xb, wb, _t(plan.idx), _t(plan.cnt), block=(16, 128), bm=64)
    jy = JK.block_sparse_matmul(_j(x).astype(jnp.bfloat16), _j(w).astype(jnp.bfloat16),
                                _j(plan.idx), _j(plan.cnt), block=(16, 128), bm=64,
                                interpret=True)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy.astype(jnp.float32)),
                               atol=2e-2)     # one bf16 ulp at |y| <= 4


def test_contract_violations_raise():
    x, w, tm, plan, rows = _problem(16, 32, 128, (16, 128), "int8", 5)
    args = (_t(plan.idx), _t(plan.cnt))
    with pytest.raises(ValueError, match="dequant"):
        TK.block_sparse_matmul(_t(x), _t(w), *args, block=(16, 128), bm=16)
    with pytest.raises(ValueError, match="int8-code"):
        TK.block_sparse_matmul(_t(x).float(), _t(w).float(), *args,
                               out_scale=_t(rows["out_scale"]), block=(16, 128), bm=16)
    with pytest.raises(ValueError, match="tile-aligned"):
        TK.block_sparse_matmul(_t(x)[:15], _t(w), *args, scale=_t(rows["scale"]),
                               block=(16, 128), bm=16)
    with pytest.raises(ValueError, match=r"bias must be \(128,\)"):
        TK.block_sparse_matmul(_t(x), _t(w), *args, scale=_t(rows["scale"]),
                               bias=_t(rows["bias"][:5]), block=(16, 128), bm=16)


@pytest.mark.parametrize("lead", [(37,), (3, 11)])
@pytest.mark.parametrize("mode", ["plain", "int8_epilogue"])
def test_make_block_sparse_matmul_pads_rows(lead, mode):
    block, bm = (16, 128), 16
    x, w, tm, plan, rows = _problem(16, 48, 256, block, "int8" if mode != "plain" else "f32", 6)
    rs = np.random.RandomState(7)
    xs = (rs.randint(-127, 128, lead + (48,)).astype(np.int8) if mode != "plain"
          else rs.randn(*lead, 48).astype(np.float32))
    kw = {} if mode == "plain" else dict(scale=rows["scale"], relu=True,
                                         out_scale=rows["out_scale"])
    jf = JO.make_block_sparse_matmul(plan, tm, bm=bm, **kw)
    tf = TO.make_block_sparse_matmul(TB.plan_from_tile_mask(tm, block), tm, bm=bm, **kw)
    jy, ty = np.asarray(jf(_j(xs), _j(w))), tf(_t(xs), _t(w)).numpy()
    assert ty.shape == jy.shape == lead + (256,)
    if mode == "plain":
        np.testing.assert_allclose(ty, jy, atol=1e-5)
    else:
        np.testing.assert_array_equal(ty, jy)


# (M, K, N, block, bm, x_lanes): the dX tiles of the unpacked 3x3 and 1x1
# layouts and of the packed one (12 of 128 lanes, 120 of 128), one lane,
# and a K-tile whose lane count is not a multiple of 8 or 16
X_LANES_CASES = [
    (64, 256, 64, (128, 16), 64, 12),
    (32, 256, 32, (128, 8), 32, 12),
    (24, 256, 256, (128, 128), 24, 120),
    (16, 96, 128, (24, 64), 16, 1),
]


def _zero_past_lanes(x, bk, lanes):
    x = x.copy()
    x.reshape(x.shape[0], -1, bk)[:, :, lanes:] = 0
    return x


@pytest.mark.parametrize("M,K,N,block,bm,lanes", X_LANES_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_x_lanes_matches_jax(M, K, N, block, bm, lanes, dtype):
    """The plain version told that x is zero past ``x_lanes`` lanes of every
    K-tile equals JAX's kernel, which reads every lane, on such an x."""
    x, w, tm, plan, rows = _problem(M, K, N, block, "int8" if dtype == "int8" else "f32", 10)
    x = _zero_past_lanes(x, block[0], lanes)
    kw = dict(block=block, bm=bm, relu=True)
    jx, jw, tx, tw = _j(x), _j(w), _t(x), _t(w)
    if dtype == "bf16":
        jx, jw = jx.astype(jnp.bfloat16), jw.astype(jnp.bfloat16)
        tx, tw = tx.to(torch.bfloat16), tw.to(torch.bfloat16)
    rs = dict(scale=rows["scale"], bias=rows["bias"]) if dtype == "int8" else \
        dict(bias=rows["bias"])
    jy = JK.block_sparse_matmul(jx, jw, _j(plan.idx), _j(plan.cnt), _j(rs["bias"]),
                                _j(rs.get("scale")), interpret=True, **kw)
    ty = TK.block_sparse_matmul(tx, tw, _t(plan.idx), _t(plan.cnt), _t(rs["bias"]),
                                _t(rs.get("scale")), x_lanes=lanes, **kw)
    full = TK.block_sparse_matmul(tx, tw, _t(plan.idx), _t(plan.cnt), _t(rs["bias"]),
                                  _t(rs.get("scale")), **kw)
    jy = np.asarray(jy.astype(jnp.float32) if dtype == "bf16" else jy)
    ty, full = ty.float().numpy(), full.float().numpy()
    if dtype == "int8":          # exact sums; JAX/CPU fuses the dequant and bias
        np.testing.assert_array_equal(ty, full)
        np.testing.assert_allclose(ty, jy, rtol=2.5e-7, atol=1e-7)
    else:
        np.testing.assert_allclose(ty, jy, atol=2e-2 if dtype == "bf16" else 1e-5)
        np.testing.assert_allclose(ty, full, atol=1e-5)
    # the fully pruned column flushed relu(bias)
    np.testing.assert_allclose(ty[:, -block[1]:], np.broadcast_to(
        np.maximum(rows["bias"][-block[1]:], 0), (M, block[1])), atol=2e-2)


@pytest.mark.parametrize("lanes", [0, -1, 17])
def test_x_lanes_refused_outside_1_to_bk(lanes):
    x, w, tm, plan, rows = _problem(16, 32, 128, (16, 128), "f32", 11)
    args = (_t(x), _t(w), _t(plan.idx), _t(plan.cnt))
    for fn in (TK.block_sparse_matmul, TK.block_sparse_matmul_plain):
        with pytest.raises(ValueError, match=r"x_lanes must be in 1\.\.16"):
            fn(*args, block=(16, 128), bm=16, x_lanes=lanes)
    fn(*args, block=(16, 128), bm=16, x_lanes=16)        # bk itself is taken


def test_wrapper_takes_plain_version_only_on_cpu(monkeypatch):
    """A CPU tensor runs the plain version and launches nothing; the CUDA
    branch needs the built library (it would raise here, not fall back)."""
    x, w, tm, plan, rows = _problem(16, 32, 128, (16, 128), "f32", 8)
    calls = []
    monkeypatch.setattr(TK, "block_sparse_matmul_plain",
                        lambda *a, **k: calls.append(1) or torch.zeros(1))
    before = launch_counts()["block_sparse_matmul"]
    TK.block_sparse_matmul(_t(x), _t(w), _t(plan.idx), _t(plan.cnt), block=(16, 128), bm=16)
    assert calls == [1] and launch_counts()["block_sparse_matmul"] == before


def test_int8_conv_ref_equal():
    rs = np.random.RandomState(9)
    xc = rs.randint(0, 128, (2, 6, 6, 4)).astype(np.int8)
    wc = rs.randint(-127, 128, (3, 3, 4, 5)).astype(np.int8)
    scale = ((rs.rand(5) + 0.5) * 1e-3).astype(np.float32)
    jy = JR.int8_conv_ref(_j(xc), _j(wc), _j(scale), 2, "SAME")
    ty = TR.int8_conv_ref(_t(xc), _t(wc), _t(scale), 2, "SAME")
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    m = rs.rand(16, 8) > 0.5
    a, b = rs.randn(4, 16).astype(np.float32), rs.randn(16, 8).astype(np.float32)
    np.testing.assert_allclose(TR.masked_dense_matmul_ref(_t(a), _t(b), m).numpy(),
                               np.asarray(JR.masked_dense_matmul_ref(_j(a), _j(b), _j(m))),
                               atol=1e-5)


# The int8 instance on the materializing path's operands: a conv's patch
# codes and weight codes packed by ``conv_gemm_layout`` (the unpacked 3x3
# and 1x1 layouts' (16, 128) and (8, 128) tiles, 12 real lanes each; the
# packed layout's (128, 128) tiles), half the groups pruned. Codes span the
# whole int8 range, -128 included; the weight codes are zero past the
# layout's lanes by construction, and column 0 keeps nonzero codes only in
# the last n8 tile that holds a real lane. (kernel size, packed)
CONV_LAYOUT_CASES = {"unpacked_3x3": (3, False), "unpacked_1x1": (1, False),
                     "packed_3x3": (3, True)}


def _conv_layout_operands(name, seed):
    from repro_torch.core.groups import fpga_conv_groups
    from repro_torch.kernels.conv_lowering import im2col_patches
    from repro_torch.sparse.conv_plan import conv_gemm_layout
    k, packed = CONV_LAYOUT_CASES[name]
    cin, cout, n_cu = 4, 24, 12
    rs = np.random.RandomState(seed)
    spec = fpga_conv_groups((k, k, cin, cout), n_cu)
    layout = conv_gemm_layout(spec, packed=packed)
    gm = (rs.rand(spec.num_groups) < 0.5).astype(np.float32)
    gm.reshape(cin, -1)[0, :] = 1             # every column has a live group
    w = torch.from_numpy(rs.randint(-128, 128, (k, k, cin, cout)).astype(np.int8))
    w = w * spec.expand(gm).to(torch.int8)
    wp = layout.pack_weight(w).contiguous()
    bn = layout.block[1]
    lanes = torch.nonzero(wp[:, :bn].any(dim=0)).flatten()
    last = int(lanes.max()) // 8 * 8            # the last n8 tile with a real lane
    wp[:, :last] = 0
    assert bool(wp[:, last:bn].any()) and not bool(wp[:, layout.output_lanes:bn].any())
    wp[tuple(torch.nonzero(wp[:, :bn])[0])] = -128
    xa = torch.from_numpy(rs.randint(-128, 128, (1, 4, 6, cin)).astype(np.int8))
    xa[0, 1, 2] = -128
    p2d = layout.pack_patches(im2col_patches(xa, k, k, 1, "SAME")).contiguous()
    plan = TB.plan_from_tile_mask(layout.tile_mask(gm), layout.block)
    N = wp.shape[1]
    rows = {"scale": ((rs.rand(N) + 0.5) * 1e-3).astype(np.float32),
            "bias": rs.randn(N).astype(np.float32),
            "out_scale": np.full(N, 16.0, np.float32)}
    return p2d.numpy(), wp.numpy(), plan, layout.block, rows


@pytest.mark.parametrize("bm", [8, 24])
@pytest.mark.parametrize("epilogue", ["f32", "requant"])
@pytest.mark.parametrize("layout", list(CONV_LAYOUT_CASES))
def test_int8_conv_layout_operands_match_jax(layout, epilogue, bm):
    """The port's wrapper (plain version on CPU tensors) and JAX's kernel in
    interpret mode on the same packed conv operands, bit-equal: f32 out
    (dequant, ReLU: one rounding) or requantized codes (dequant, bias, ReLU,
    requantize); the f32 sums also equal an int64 oracle."""
    x, w, plan, block, rows = _conv_layout_operands(layout, {"f32": 21, "requant": 22}[epilogue])
    assert x.shape[0] == 24 and (x == -128).any() and (w == -128).any()
    kw = dict(scale=rows["scale"], relu=True)
    if epilogue == "requant":
        kw.update(bias=rows["bias"], out_scale=rows["out_scale"])
    jy, ty = _both(x, w, plan, block, bm, **kw)
    np.testing.assert_array_equal(ty, jy)
    if epilogue == "f32":
        acc = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.float32)
        np.testing.assert_array_equal(ty, np.maximum(acc * rows["scale"], np.float32(0)))
    else:
        assert ty.dtype == np.int8 and np.abs(ty.astype(np.int32)).max() <= 127
