"""The CUDA kernels against their plain PyTorch versions **on a GPU**, at
shapes the smoke run does not reach: every rows-per-thread instance
(bm 8 ... 128), bf16 operands, column-segmented wide rows, windows that need
more than 48 KB of shared memory, fully pruned tables, the wrapper's
refusals and the bind's (``bm`` above 128 on CUDA); for the block-sparse
matmul's f32 and bf16 instance (tensor-core products over the lanes that
can be nonzero) every tile shape of the forward and of the dX, ``x_lanes``
of the whole tile, 12, 120 and 1 lane, element copies of an unaligned x,
the pruned column's flush and two launches bit-identical; for its int8
instance (tensor-core products over the n8 tiles that hold a nonzero code)
bk 8-128 with codes in the next, dead tile, bn 8-128, bm 8-128, weights
nonzero only in some lanes of a tile or in none of a live tile, -128 codes
with sums past 2^24, 8-, 4-byte and element copies, the packed operands of
the CIFAR net's eight conv geometries in both layouts, every epilogue, the
empty column's flush and two launches bit-identical; for the implicit conv
kernel's f32 (3xTF32) and bf16 instances (tensor-core products) the row
shape, a column whose last nonzero lane lies inside an n8 tile, live tiles
whose weights are all zero, K-tiles over two weight units, narrow window
copies, the per-step window path, and two launches bit-identical; for the
implicit conv kernel's int8 instance (tensor-core
products) the serving row shape at batch 32 and 1, M-blocks that are not a
multiple of 16 rows, 16-, 32- and 128-row K-tiles, K-steps that span two
channels, columns with no live tile, all-zero windows at stride 2, windows
whose untapped pixels alone are nonzero, column segments, windows beyond 48
KB and beyond what fits with all channels, the served net's eight layer
geometries at batch 2048 and a batch of 1031 on the resident body with
compacted K operands and on the per-block body with padded ones (the body
the rule picks, counted), codes over the whole range on both bodies, two
launches bit-identical and skip counters equal; for the weight-gradient kernel (tensor-core
products over stacks of one column's live tiles) every tile shape of the
training path, one live tile and all of them in a shuffled order, row
counts that are not a multiple of the 32-row step or of the row chunk,
M = 131072, columns with more live tiles than a stack holds and with
different stack counts, g zero past 12 lanes or dense, the element-copy
instances (unaligned operands, a 6-row tile), the bind's lane count
(``g_lanes``), a malformed stack table or lane count refused, and
bit-identical results across two launches; for the dense int8 matmul (K4,
tensor-core products on a block tile it picks itself) every block tile,
M and N that are no multiple of it (8 to 8192), K from 1 to 2048 with
tails shorter than a 32- or 16-deep step, 16-, 8-, 4-byte and element
copies (operands one byte off alignment), -128 and 127 rows and columns with
sums past 2^24 and both scale forms, bit-equal to the plain version and to
``int8_matmul_ref`` and across two launches; and the transformer LM
family, which launches none of these kernels: each smoke config's logits on
the card against the CPU, the KV ring buffer at a prefill longer than its
window, ``moe_manual_tp`` through a one-rank NCCL group, and ``prefetch``'s
copy-stream ordering on 256 MB batches; and the event-timed fallback of
the bench timers against the profiler; and the block-sparse matmul and the
weight gradient at an LM's FFN shape (mistral-nemo-12b's 5120 x 14336
``ffn/wi`` on 2048 rows, half its tiles live) forward and backward. Marked ``gpu``: skipped (with a
reason, decided inside a fixture) on a machine without a CUDA device, run
on one with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py

Bars as everywhere: int8 outputs and skip counters bit-equal, f32 <= 1e-4
(summation order), bf16 one output ulp; the weight gradient (f32
accumulation of f32 or bf16 operands) within 1e-4 of the scale of its
sums, max(|x|ᵀ|g|)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels, tracing
from repro_torch.core import groups as TG, quant as TQ
from repro_torch.kernels import block_sparse_matmul as BSM, implicit_conv as IC
from repro_torch.kernels import int8_matmul as I8, ref as REF
from repro_torch.kernels import ops as OPS
from repro_torch.sparse import block_mask as TB, conv_plan as TP

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _matmul_case(M, K, N, block, dtype, seed, dev, density=0.5):
    rs = np.random.RandomState(seed)
    bk, bn = block
    tm = rs.rand(K // bk, N // bn) < density
    tm[:, -1] = False
    plan = TB.plan_from_tile_mask(tm, block)
    if dtype == torch.int8:
        x = torch.from_numpy(rs.randint(-127, 128, (M, K)).astype(np.int8))
        w = torch.from_numpy(rs.randint(-127, 128, (K, N)).astype(np.int8))
    else:
        x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).to(dtype)
        w = torch.from_numpy((rs.randn(K, N) / np.sqrt(K)).astype(np.float32)).to(dtype)
    rows = dict(bias=torch.from_numpy(rs.randn(N).astype(np.float32)),
                scale=torch.from_numpy(((rs.rand(N) + 0.5) * 1e-3).astype(np.float32)),
                out_scale=torch.full((N,), 16.0))
    to = lambda t: t.to(dev)
    return (to(x), to(w), to(torch.from_numpy(plan.idx)), to(torch.from_numpy(plan.cnt)),
            {k: to(v) for k, v in rows.items()})


def _check(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    if tol == 0:
        assert torch.equal(got, want)
    else:
        err = float((got.double() - want.double()).abs().max())
        assert err <= tol, err


@pytest.mark.parametrize("bm", [8, 16, 24, 32, 64, 96, 128])
@pytest.mark.parametrize("block", [(128, 128), (16, 128), (8, 128), (24, 64)])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "int8_requant"])
def test_block_sparse_matmul_kernel_vs_plain(dev, bm, block, mode):
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}.get(mode, torch.int8)
    x, w, idx, cnt, rows = _matmul_case(3 * bm, 4 * block[0], 3 * block[1], block, dtype,
                                        bm + block[0], dev)
    kw = dict(block=block, bm=bm, relu=True, bias=rows["bias"])
    if dtype == torch.int8:
        kw["scale"] = rows["scale"]
    if mode == "int8_requant":
        kw["out_scale"] = rows["out_scale"]
    before = kernels.launch_counts()["block_sparse_matmul"]
    got = BSM.block_sparse_matmul(x, w, idx, cnt, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["block_sparse_matmul"] == before + 1
    want = BSM.block_sparse_matmul_plain(x, w, idx, cnt, **kw)
    _check(got, want, {"f32": 1e-4, "bf16": 3.2e-2}.get(mode, 0))


def test_block_sparse_matmul_all_columns_pruned(dev):
    x, w, idx, cnt, rows = _matmul_case(64, 64, 256, (16, 128), torch.int8, 1, dev)
    cnt = torch.zeros_like(cnt)
    got = BSM.block_sparse_matmul(x, w, idx, cnt, rows["bias"], rows["scale"],
                                  block=(16, 128), bm=64, relu=True)
    assert torch.equal(got, torch.clamp(rows["bias"], min=0).expand(64, 256))


# K1's f32/bf16 instance (tensor cores): the forward tiles of both layouts,
# the dX tiles of the transposed plans ((128, 16), (128, 8), (128, 128)) and
# a 24-row tile
K1_MMA_BLOCKS = [(128, 128), (16, 128), (8, 128), (24, 64), (128, 16), (128, 8)]


def _zero_past_lanes(x, bk, lanes):
    x = x.clone()
    x.view(x.shape[0], -1, bk)[:, :, lanes:] = 0
    return x


@pytest.mark.parametrize("bm", [8, 16, 24, 32, 64, 96, 128])
@pytest.mark.parametrize("block", K1_MMA_BLOCKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sparse_matmul_tensor_core_x_lanes(dev, bm, block, dtype):
    """K1's tensor-core instance against its plain version for each
    ``x_lanes`` of {bk, 12, 120, 1} that fits the tile, on an x zero past it
    (bias and ReLU fused): two launches bit-identical, and the column with
    no live tile flushes relu(bias)."""
    bk, bn = block
    x, w, idx, cnt, rows = _matmul_case(3 * bm, 4 * bk, 3 * bn, block, dtype,
                                        bm + bk + bn, dev)
    assert int(cnt[-1]) == 0
    for lanes in sorted({bk, 12, 120, 1} & set(range(1, bk + 1)), reverse=True):
        xz = _zero_past_lanes(x, bk, lanes)
        kw = dict(block=block, bm=bm, relu=True, bias=rows["bias"], x_lanes=lanes)
        before = kernels.launch_counts()["block_sparse_matmul"]
        got = BSM.block_sparse_matmul(xz, w, idx, cnt, **kw)
        again = BSM.block_sparse_matmul(xz, w, idx, cnt, **kw)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["block_sparse_matmul"] == before + 2
        assert torch.equal(got, again), lanes
        want = BSM.block_sparse_matmul_plain(xz, w, idx, cnt, **kw)
        _check(got, want, 1e-4 if dtype == torch.float32 else 3.2e-2)
        zero_col = torch.clamp(rows["bias"][-bn:], min=0).to(dtype).expand(3 * bm, bn)
        assert torch.equal(got[:, -bn:], zero_col), lanes


@pytest.mark.parametrize("block,lanes", [((128, 16), 12), ((16, 128), 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sparse_matmul_tensor_core_element_copies(dev, block, lanes, dtype):
    """An x that starts one element past a 16-byte boundary takes the
    tensor-core instance's element copies: the same bits as the 16-byte
    copies of an aligned x, which stage the same values."""
    bk, bn = block
    x, w, idx, cnt, rows = _matmul_case(64, 4 * bk, 3 * bn, block, dtype, 5, dev)
    x = _zero_past_lanes(x, bk, lanes)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    xu = flat[1:].view(x.shape)
    xu.copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16 != 0
    kw = dict(block=block, bm=64, relu=True, bias=rows["bias"], x_lanes=lanes)
    got = BSM.block_sparse_matmul(xu, w, idx, cnt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, BSM.block_sparse_matmul(x, w, idx, cnt, **kw))
    _check(got, BSM.block_sparse_matmul_plain(x, w, idx, cnt, **kw),
           1e-4 if dtype == torch.float32 else 3.2e-2)


# K1's int8 instance (tensor cores): every epilogue of the int8 contract
IMMA_EPILOGUES = ("f32", "f32_bias_relu", "requant")


def _imma_codes(rs, shape):
    """int8 codes over the whole range, -128 included."""
    return torch.from_numpy(rs.randint(-128, 128, shape).astype(np.int8))


def _imma_rows(rs, N):
    return dict(bias=torch.from_numpy(rs.randn(N).astype(np.float32)),
                scale=torch.from_numpy(((rs.rand(N) + 0.5) * 1e-3).astype(np.float32)),
                out_scale=torch.full((N,), 16.0))


def _imma_check(x, w, idx, cnt, rows, block, bm, twice=True):
    """K1's int8 kernel bit-equal to its plain version in each epilogue of
    IMMA_EPILOGUES (and, with ``twice``, two launches bit-identical);
    returns the f32 outputs of the first epilogue."""
    first = None
    for epi in IMMA_EPILOGUES:
        kw = dict(block=block, bm=bm, scale=rows["scale"])
        if epi != "f32":
            kw.update(bias=rows["bias"], relu=True)
        if epi == "requant":
            kw["out_scale"] = rows["out_scale"]
        before = kernels.launch_counts()["block_sparse_matmul"]
        got = BSM.block_sparse_matmul(x, w, idx, cnt, **kw)
        if twice:
            again = BSM.block_sparse_matmul(x, w, idx, cnt, **kw)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["block_sparse_matmul"] == before + 1 + twice
        if twice:
            assert torch.equal(got, again), epi
        _check(got, BSM.block_sparse_matmul_plain(x, w, idx, cnt, **kw), 0)
        first = got if first is None else first
    return first


@pytest.mark.parametrize("bm", [8, 16, 24, 40, 64, 96, 128])
@pytest.mark.parametrize("bn", [8, 16, 24, 64, 128])
@pytest.mark.parametrize("bk", [8, 16, 24, 32, 128])
def test_block_sparse_matmul_imma_tiles(dev, bk, bn, bm):
    """Every tile shape the int8 instance takes: codes over the whole range
    everywhere, dead tiles included, so that a read past a live tile into
    the next (dead) one shows. Column 0 has the even K-tiles live (each
    followed by a dead one), column 1 a random half, column 2 none (it
    flushes the epilogue of a zero accumulator)."""
    rs = np.random.RandomState(bk * 1000 + bn * 10 + bm)
    nK, M = 6, 2 * bm
    tm = np.zeros((nK, 3), bool)
    tm[::2, 0] = True
    tm[:, 1] = rs.rand(nK) < 0.5
    tm[1, 1] = True
    plan = TB.plan_from_tile_mask(tm, (bk, bn))
    to = lambda t: t.to(dev)
    x, w = _imma_codes(rs, (M, nK * bk)), _imma_codes(rs, (nK * bk, 3 * bn))
    rows = {k: to(v) for k, v in _imma_rows(rs, 3 * bn).items()}
    idx, cnt = to(torch.from_numpy(plan.idx)), to(torch.from_numpy(plan.cnt))
    assert int(cnt[2]) == 0
    got = _imma_check(to(x), to(w), idx, cnt, rows, (bk, bn), bm)
    assert torch.equal(got[:, 2 * bn:], torch.zeros(M, bn, device=dev))


@pytest.mark.parametrize("block", [(16, 128), (8, 128), (128, 128), (24, 64), (32, 24)])
@pytest.mark.parametrize("pattern", ["past_lane_12", "n8_tile_0", "last_n8_tile",
                                     "zero_live_tile"])
def test_block_sparse_matmul_imma_weight_lanes(dev, block, pattern):
    """Weights whose nonzero codes lie only in some lanes of each output
    tile: only past lane 12, only in n8 tile 0, only in the last n8 tile
    (a partial one at bn = 24), or none at all in one live tile of each
    column. The kernel multiplies up to the last n8 tile it finds a nonzero
    code in; the rest must hold the zero-accumulator epilogue."""
    bk, bn = block
    rs = np.random.RandomState(bk + bn + len(pattern))
    nK, M, bm = 5, 96, 48
    tm = rs.rand(nK, 3) < 0.6
    tm[0, :2] = True
    tm[:, 2] = False
    plan = TB.plan_from_tile_mask(tm, block)
    x, w = _imma_codes(rs, (M, nK * bk)), _imma_codes(rs, (nK * bk, 3 * bn))
    lanes = w.view(nK * bk, 3, bn)
    if pattern == "past_lane_12":
        lanes[:, :, :min(12, bn)] = 0
    elif pattern == "n8_tile_0":
        lanes[:, :, 8:] = 0
    elif pattern == "last_n8_tile":
        lanes[:, :, :(bn - 1) // 8 * 8] = 0
    else:
        w[:bk] = 0                      # K-tile 0 is live in columns 0 and 1
    to = lambda t: t.to(dev)
    rows = {k: to(v) for k, v in _imma_rows(rs, 3 * bn).items()}
    _imma_check(to(x), to(w), to(torch.from_numpy(plan.idx)),
                to(torch.from_numpy(plan.cnt)), rows, block, bm)


@pytest.mark.parametrize("bm", [8, 128])
def test_block_sparse_matmul_imma_extreme_codes(dev, bm):
    """Codes of -128 and 127 only, 16 live K-tiles of 128 lanes: sums up to
    2048 * 2^14, past 2^24, where the int32 -> f32 conversion rounds."""
    rs = np.random.RandomState(bm)
    M, nK, bk, bn = 2 * bm, 16, 128, 128
    pick = lambda shape: torch.from_numpy(
        np.where(rs.rand(*shape) < 0.5, -128, 127).astype(np.int8))
    x, w = pick((M, nK * bk)), pick((nK * bk, 2 * bn))
    x[0], w[:, 0] = -128, -128
    tm = np.ones((nK, 2), bool)
    plan = TB.plan_from_tile_mask(tm, (bk, bn))
    to = lambda t: t.to(dev)
    rows = {k: to(v) for k, v in _imma_rows(rs, 2 * bn).items()}
    acc = REF.int_matmul_exact(to(x), to(w))
    assert int(acc.abs().max()) > 2 ** 24
    _imma_check(to(x), to(w), to(torch.from_numpy(plan.idx)),
                to(torch.from_numpy(plan.cnt)), rows, (bk, bn), bm, twice=False)


def _offset(t, nbytes):
    """A copy of ``t`` whose data starts ``nbytes`` past an aligned address."""
    flat = torch.empty(t.numel() + nbytes, dtype=t.dtype, device=t.device)
    out = flat[nbytes:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == nbytes % 16
    return out


# (variant, block): rows of 8 and 4 bytes, rows of odd length, operands one
# byte past an aligned address, and a weight tile narrower than a 4-byte copy
IMMA_COPY_CASES = [("k_multiple_of_8", (8, 128)), ("k_multiple_of_8", (24, 64)),
                   ("k_multiple_of_4", (12, 128)), ("k_odd", (9, 128)),
                   ("x_one_byte_off", (16, 128)), ("w_one_byte_off", (16, 128)),
                   ("bn_6", (16, 6))]


@pytest.mark.parametrize("variant,block", IMMA_COPY_CASES, ids=lambda v: str(v))
def test_block_sparse_matmul_imma_copy_widths(dev, variant, block):
    """Operands whose rows (K, N bytes) or pointers are not 16-byte aligned
    take the same kernel with 8-, 4-byte or element copies: bit-equal to the
    plain version, and (for a shifted operand) to the aligned copy's result."""
    bk, bn = block
    rs = np.random.RandomState(bk * 7 + bn)
    nK, M, bm = 5, 80, 40
    tm = rs.rand(nK, 4) < 0.5
    tm[0, :3] = True
    tm[:, 3] = False
    plan = TB.plan_from_tile_mask(tm, block)
    to = lambda t: t.to(dev)
    x, w = to(_imma_codes(rs, (M, nK * bk))), to(_imma_codes(rs, (nK * bk, 4 * bn)))
    rows = {k: to(v) for k, v in _imma_rows(rs, 4 * bn).items()}
    idx, cnt = to(torch.from_numpy(plan.idx)), to(torch.from_numpy(plan.cnt))
    want = _imma_check(x, w, idx, cnt, rows, block, bm)
    if variant in ("x_one_byte_off", "w_one_byte_off"):
        xs = _offset(x, 1) if variant == "x_one_byte_off" else x
        ws = _offset(w, 1) if variant == "w_one_byte_off" else w
        assert torch.equal(_imma_check(xs, ws, idx, cnt, rows, block, bm), want)


# the eight layer geometries of the CIFAR net: (k, cin, cout, stride, h)
CIFAR_GEOMS = [(3, 3, 16, 1, 32), (3, 16, 16, 1, 32), (3, 16, 32, 2, 32), (3, 32, 32, 1, 16),
               (1, 16, 32, 2, 32), (3, 32, 64, 2, 16), (3, 64, 64, 1, 8), (1, 32, 64, 2, 16)]


@pytest.mark.parametrize("geom", CIFAR_GEOMS, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode", ["int8", "streamed"])
def test_block_sparse_matmul_imma_conv_layouts(dev, geom, packed, mode):
    """The materializing path's operands: int8 activation codes' patches and
    the masked weight codes packed by ``conv_gemm_layout`` (unpacked 16- or
    8-row tiles, 12 real lanes of 128; packed (128, 128) tiles), half the
    groups pruned and the last f-block column entirely, rows padded to the
    adaptive bm, at batch 2; f32 out (``int8``) or requantized codes
    (``streamed``), bias and ReLU fused."""
    from repro_torch.kernels.conv_lowering import im2col_patches
    k, cin, cout, stride, h = geom
    rs = np.random.RandomState(sum(geom) + packed)
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), 12), packed=packed)
    gm = (rs.rand(layout.spec.num_groups) < 0.5).astype(np.float32)
    gm.reshape(cin, -1)[:, -1] = 0
    w = torch.from_numpy((rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))
                          ).astype(np.float32)).to(dev)
    x = torch.from_numpy(np.maximum(rs.randn(2, h, h, cin), 0).astype(np.float32)).to(dev)
    q = TQ.QuantSpec.calibrate(w)
    wp = layout.pack_weight(q.weight_codes(layout.spec.expand(gm).to(dev) * w)).contiguous()
    p2d = layout.pack_patches(im2col_patches(q.act_codes(x), k, k, stride, "SAME"))
    bm = TP.adaptive_bm(p2d.shape[0])
    p2d, _ = OPS._pad_rows(p2d, bm)
    plan = layout.plan(gm)
    kw = dict(block=layout.block, bm=bm, relu=True, scale=layout.pack_bias(
        q.dequant_row(cout, dev)), bias=layout.pack_bias(
        torch.from_numpy(rs.randn(cout).astype(np.float32)).to(dev)))
    if mode == "streamed":
        kw["out_scale"] = layout.pack_bias(torch.full((cout,), 16.0, device=dev))
    idx, cnt = (torch.from_numpy(a).to(dev) for a in (plan.idx, plan.cnt))
    assert int((cnt == 0).sum()) >= (0 if packed else 1)
    got = BSM.block_sparse_matmul(p2d.contiguous(), wp, idx, cnt, **kw)
    torch.cuda.synchronize()
    _check(got, BSM.block_sparse_matmul_plain(p2d.contiguous(), wp, idx, cnt, **kw), 0)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, w, idx, cnt, rows = _matmul_case(256, 64, 512, (16, 256), torch.float32, 2, dev)
    with pytest.raises(ValueError, match="bn <= 128"):
        BSM.block_sparse_matmul(x, w, idx, cnt, block=(16, 256), bm=128)
    x, w, idx, cnt, rows = _matmul_case(64, 64, 256, (16, 128), torch.float32, 3, dev)
    with pytest.raises(ValueError, match="is on cpu"):
        BSM.block_sparse_matmul(x, w.cpu(), idx, cnt, block=(16, 128), bm=64)
    with pytest.raises(TypeError, match="takes f32/bf16/int8"):
        BSM.block_sparse_matmul(x.double(), w.double(), idx, cnt, block=(16, 128), bm=64)
    with pytest.raises(TypeError, match="must be int32"):
        BSM.block_sparse_matmul(x, w, idx.long(), cnt, block=(16, 128), bm=64)
    with pytest.raises(ValueError, match=r"x_lanes must be in 1\.\.16"):
        BSM.block_sparse_matmul(x, w, idx, cnt, block=(16, 128), bm=64, x_lanes=17)
    mb = IC.choose_m_block(1, 128)
    big = torch.zeros(1, 130, 130, 8, device=dev)
    with pytest.raises(ValueError, match="does not fit a thread block"):
        IC.implicit_block_sparse_conv(
            big, torch.zeros(128, 128, device=dev),
            torch.zeros(1, 1, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev), kx=129, ky=3, stride=1,
            mb=mb, block=(128, 128), cpk=8, slot=16)


CONV_CASES = [  # (k, cin, cout, stride, h, w, batch, cap)
    (3, 8, 16, 1, 12, 12, 2, 128),     # bm 128 -> 8 rows per thread
    (3, 8, 16, 2, 12, 12, 2, 128),     # bm 40
    (1, 8, 16, 2, 16, 16, 3, 128),     # 1x1 projection
    (3, 5, 10, 1, 4, 4, 1, 128),       # bm 16 -> 1 row per thread
    (3, 6, 12, 1, 5, 5, 2, 128),       # bm 32 -> 2 rows per thread
    (3, 4, 8, 1, 3, 150, 1, 128),      # wide row: 2 column segments
    (5, 40, 24, 1, 20, 20, 1, 128),    # 5x5: 32-row channel slots
    (1, 16, 16, 4, 32, 64, 2, 128),    # stride 4: packed window 113 KB (> 48 KB)
    (3, 8, 16, 1, 9, 9, 2, 16),        # pinned small cap: 1 row blocks
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "streamed_dsb"])
def test_implicit_conv_kernel_vs_plain(dev, case, packed, mode):
    k, cin, cout, stride, h, w_, batch, cap = case
    rs = np.random.RandomState(sum(case))
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), 4), packed=packed)
    gm = (rs.rand(layout.spec.num_groups) < 0.6).astype(np.float32)
    gm.reshape(cin, -1)[:, -1] = 0
    w = torch.from_numpy((rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))
                          ).astype(np.float32)).to(dev)
    x = np.maximum(rs.randn(batch, h, w_, cin), 0).astype(np.float32)
    x[0, : h // 2] = 0.0
    x = torch.from_numpy(x).to(dev)
    wm = layout.spec.expand(gm).to(dev) * w
    bias = layout.pack_bias(torch.from_numpy(rs.randn(cout).astype(np.float32)).to(dev))
    scale = out_scale = None
    if mode in ("f32", "bf16"):
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        wp, xin = layout.pack_weight(wm).to(dt), x.to(dt)
    else:
        q = TQ.QuantSpec.calibrate(w)
        wp, xin = layout.pack_weight(q.weight_codes(wm)), q.act_codes(x)
        scale = layout.pack_bias(q.dequant_row(cout, dev))
        if mode == "streamed_dsb":
            out_scale = layout.pack_bias(torch.full((cout,), 16.0, device=dev))
    from repro_torch.kernels.conv_lowering import conv_out_size
    ho, wo = conv_out_size(h, k, stride, "SAME"), conv_out_size(w_, k, stride, "SAME")
    mb = IC.choose_m_block(ho, wo, cap=cap)
    geo = layout.implicit_geometry()
    rows, cols = IC.window_shape(mb, k, k, stride)
    assert IC.window_fits_card(rows, cols, geo["cpk"])
    xp = IC.pad_input(xin, k, k, stride, "SAME", mb, layout.tiles[0] * geo["cpk"])
    plan = layout.plan(gm)
    idx, cnt = (torch.from_numpy(a).to(dev) for a in (plan.idx, plan.cnt))
    dsb = mode == "streamed_dsb"
    kw = dict(kx=k, ky=k, stride=stride, mb=mb, block=layout.block, cpk=geo["cpk"],
              slot=geo["slot"], relu=True, activation_dsb=dsb, count_skips=dsb)
    got = IC.implicit_block_sparse_conv(xp, wp.contiguous(), idx, cnt, bias, scale,
                                        out_scale, **kw)
    torch.cuda.synchronize()
    want = IC.implicit_block_sparse_conv_plain(xp, wp, idx, cnt, bias, scale,
                                               out_scale, **kw)
    tol = {"f32": 1e-4, "bf16": 3.2e-2}.get(mode, 0)
    if dsb:
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    _check(got, want, tol)


IMMA_CASES = [  # (k, cin, cout, stride, h, w, batch, cap, n_cu, activation pattern)
    (3, 16, 16, 1, 32, 32, 32, 128, 12, "half_batch"),  # the row shape s0b0/conv1, batch 32
    (3, 16, 16, 1, 32, 32, 1, 128, 12, "half_batch"),   # the same at batch 1
    (3, 8, 16, 1, 8, 8, 2, 8, 4, "half"),               # bm 8: half an m16 tile
    (3, 8, 16, 1, 12, 12, 2, 24, 4, "half"),            # bm 24
    (3, 8, 16, 2, 12, 12, 2, 128, 4, "half"),           # bm 40, stride 2
    (5, 40, 24, 1, 20, 20, 1, 128, 4, "half"),          # bk 32 (unpacked 5x5): one k32 step
    (7, 6, 16, 1, 10, 10, 2, 128, 4, "half"),           # packed slot 56: a K-step spans 2 channels
    (3, 4, 8, 1, 3, 150, 1, 128, 4, "half"),            # spi 2 column segments
    (1, 16, 16, 4, 32, 64, 2, 128, 4, "half"),          # window + weight ring above 48 KB
    (3, 40, 8, 7, 77, 77, 1, 128, 4, "half"),           # all channels too large: per-step window
    (3, 16, 32, 2, 32, 32, 4, 128, 12, "zero_windows"),  # stride 2, whole windows zero
    (1, 16, 16, 2, 16, 16, 2, 128, 4, "odd_only"),      # stride 2: only untapped pixels nonzero
    # the served net's eight layer geometries at batch 2048: the resident body
    # on compacted operands, the per-block body on padded ones
    *[(k, cin, cout, stride, h, h, 2048, 128, 12, "half_batch")
      for k, cin, cout, stride, h in CIFAR_GEOMS],
    (3, 16, 16, 1, 32, 32, 1031, 128, 12, "half_batch"),  # M-blocks no multiple of the grid
    (3, 16, 16, 1, 32, 32, 64, 64, 12, "half_batch"),     # bm 64: 47.8 KB + 2.1 KB static
    (3, 64, 64, 1, 8, 8, 2048, 128, 12, "full_range"),    # codes -128 .. 127, batch 2048
    (3, 16, 16, 1, 32, 32, 32, 128, 12, "full_range"),    # the same on the per-block path
]


def _imma_operands(case, packed, mode, dev):
    """Int8 operands of one conv layer for the tensor-core instance, with an
    activation pattern that exercises the skip: ``half_batch`` zeroes the top
    half of the first half of the images (as the smoke run does), ``half``
    the top half of image 0, ``zero_windows`` image 0 and the first M-block
    window of image 1, ``odd_only`` every even row and column (at stride 2
    the tapped pixels of a 1x1 conv are zero, its windows are not);
    ``full_range`` draws every weight code of the packed tiles and every
    activation code from -128 .. 127."""
    k, cin, cout, stride, h, w_, batch, cap, n_cu, pattern = case
    rs = np.random.RandomState(sum(case[:9]))
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), n_cu), packed=packed)
    gm = (rs.rand(layout.spec.num_groups) < 0.6).astype(np.float32)
    gm.reshape(cin, -1)[:, -1] = 0
    w = torch.from_numpy((rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))
                          ).astype(np.float32)).to(dev)
    x = np.maximum(rs.randn(batch, h, w_, cin), 0).astype(np.float32)
    if pattern == "half_batch":
        x[: max(batch // 2, 1), : h // 2] = 0.0
    elif pattern == "half":
        x[0, : h // 2] = 0.0
    elif pattern == "zero_windows":
        x[0] = 0.0
        x[1, : h // 2 + 1] = 0.0
    elif pattern == "odd_only":
        x[:, ::2] = 0.0
        x[:, :, ::2] = 0.0
    x = torch.from_numpy(x).to(dev)
    q = TQ.QuantSpec.calibrate(w)
    wp = layout.pack_weight(q.weight_codes(layout.spec.expand(gm).to(dev) * w)).contiguous()
    xin = q.act_codes(x)
    if pattern == "full_range":
        codes = lambda shape: torch.from_numpy(rs.randint(-128, 128, shape).astype(np.int8))
        wp, xin = codes(tuple(wp.shape)).to(dev), codes(tuple(xin.shape)).to(dev)
    scale = layout.pack_bias(q.dequant_row(cout, dev))
    bias = layout.pack_bias(torch.from_numpy(rs.randn(cout).astype(np.float32)).to(dev))
    out_scale = (layout.pack_bias(torch.full((cout,), 16.0, device=dev))
                 if mode.startswith("streamed") else None)
    from repro_torch.kernels.conv_lowering import conv_out_size
    ho, wo = conv_out_size(h, k, stride, "SAME"), conv_out_size(w_, k, stride, "SAME")
    mb = IC.choose_m_block(ho, wo, cap=cap)
    geo = layout.implicit_geometry()
    assert IC.window_fits_card(*IC.window_shape(mb, k, k, stride), geo["cpk"])
    xp = IC.pad_input(xin, k, k, stride, "SAME", mb, layout.tiles[0] * geo["cpk"]).contiguous()
    plan = layout.plan(gm)
    idx, cnt = (torch.from_numpy(a).to(dev) for a in (plan.idx, plan.cnt))
    dsb = mode == "streamed_dsb"
    kw = dict(kx=k, ky=k, stride=stride, mb=mb, block=layout.block, cpk=geo["cpk"],
              slot=geo["slot"], relu=True, activation_dsb=dsb, count_skips=True)
    if mode == "streamed_compact":
        kw["compact"] = IC.compact_k(wp, plan.idx, plan.cnt, kx=k, ky=k, cin=cin,
                                     cpk=geo["cpk"], slot=geo["slot"], block=layout.block)
    return (xp, wp, idx, cnt, bias, scale, out_scale), kw


@pytest.mark.parametrize("case", IMMA_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode", ["int8", "streamed_dsb", "streamed_compact"])
def test_implicit_conv_int8_tensor_core_instance(dev, case, packed, mode):
    """The int8 instance (tensor-core products) bit-equal to the plain
    version on the padded tiles, outputs and skip counters, two launches
    bit-identical, one launch counted per call; on compacted K operands
    launches of 1024 M-blocks or more take the resident body and those of
    256 or fewer the per-block body, as the rule says (a window of all
    channels no block holds beside the weight ring refuses them); on padded
    operands (``int8``, ``streamed_dsb``) every launch takes the per-block
    body, 1024 M-blocks or more included."""
    args, kw = _imma_operands(case, packed, mode, dev)
    xp, mb = args[0], kw["mb"]
    rows, cols = IC.window_shape(mb, kw["kx"], kw["ky"], kw["stride"])
    ck = kw.get("compact")
    if ck is not None and not IC.takes_compact_path(rows, cols, xp.shape[3]):
        assert case[:4] == (3, 40, 8, 7)
        with pytest.raises(ValueError, match="compacted K operands need it"):
            IC.implicit_block_sparse_conv(*args, **kw)
        return
    n_blocks = xp.shape[0] * mb.bpi
    resident = ck is not None and IC.takes_resident_path(
        n_blocks, mb.bm, rows * cols * IC.window_pitch(xp.shape[3]),
        torch.cuda.get_device_properties(dev).multi_processor_count, ck.k_units)
    if n_blocks >= 1024:
        assert resident == (ck is not None)
    elif n_blocks <= 256:
        assert not resident
    before = (kernels.launch_counts()["implicit_block_sparse_conv"],
              tracing.counter(IC.RESIDENT), tracing.counter(IC.COMPACT))
    got = IC.implicit_block_sparse_conv(*args, **kw)
    again = IC.implicit_block_sparse_conv(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["implicit_block_sparse_conv"] == before[0] + 2
    assert tracing.counter(IC.RESIDENT) == before[1] + 2 * resident
    assert tracing.counter(IC.COMPACT) == before[2] + 2 * (ck is not None)
    want = IC.implicit_block_sparse_conv_plain(*args, **{**kw, "compact": None})
    assert torch.equal(got[1], want[1]) and torch.equal(again[1], got[1])
    if case[-1] == "zero_windows" and kw["activation_dsb"]:
        assert int(got[1].sum()) > 0
    got, again, want = got[0], again[0], want[0]
    assert torch.equal(got, again)
    _check(got, want, 0)
    if not packed:
        assert int((args[3] == 0).sum()) > 0        # a column with cnt == 0


FLOAT_CASES = [  # (k, cin, cout, stride, h, w, batch, cap, n_cu, weights)
    (3, 16, 16, 1, 32, 32, 32, 128, 12, "random"),  # row shape: last nonzero lane 11, in n8 tile 1
    (3, 16, 32, 1, 16, 16, 4, 128, 12, "zero_fblock"),  # f-block 0 live but all-zero weights
    (3, 3, 16, 1, 16, 16, 2, 128, 12, "random"),    # cin 3: 12- / 6-byte pixels, narrow copies
    (3, 8, 16, 1, 8, 8, 2, 8, 4, "random"),         # bm 8: half an m16 tile
    (3, 8, 16, 1, 12, 12, 2, 24, 4, "random"),      # bm 24
    (3, 8, 16, 2, 12, 12, 2, 128, 4, "random"),     # bm 40, stride 2
    (5, 40, 24, 1, 20, 20, 1, 128, 4, "random"),    # bk 32 (unpacked 5x5)
    (7, 6, 16, 1, 10, 10, 2, 128, 4, "random"),     # bk 56: a K-tile over two f32 units
    (3, 4, 8, 1, 3, 150, 1, 128, 4, "random"),      # spi 2 column segments
    (1, 16, 16, 4, 32, 64, 2, 128, 4, "random"),    # stride 4: 113 KB window, all channels
    (3, 40, 8, 7, 77, 77, 1, 128, 4, "random"),     # all channels too large: per-step window
]


def _float_operands(case, packed, dtype, dev):
    """f32 or bf16 operands of one conv layer; ``zero_fblock`` zeroes the
    weights of filter block 0 while its groups stay live, so its tiles are
    in the table with all-zero lanes (unpacked: a whole column; packed: the
    first n8 tile of the column and half of the second)."""
    k, cin, cout, stride, h, w_, batch, cap, n_cu, weights = case
    rs = np.random.RandomState(sum(case[:9]))
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), n_cu), packed=packed)
    gm = (rs.rand(layout.spec.num_groups) < 0.6).astype(np.float32)
    gm.reshape(cin, -1)[:, -1] = 0
    w = (rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
    if weights == "zero_fblock":
        gm.reshape(cin, -1)[:, 0] = 1
        w[..., :n_cu] = 0.0
    x = np.maximum(rs.randn(batch, h, w_, cin), 0).astype(np.float32)
    x[0, : h // 2] = 0.0
    wm = layout.spec.expand(gm).to(dev) * torch.from_numpy(w).to(dev)
    wp = layout.pack_weight(wm).to(dtype).contiguous()
    xin = torch.from_numpy(x).to(dev).to(dtype)
    bias = layout.pack_bias(torch.from_numpy(rs.randn(cout).astype(np.float32)).to(dev))
    from repro_torch.kernels.conv_lowering import conv_out_size
    ho, wo = conv_out_size(h, k, stride, "SAME"), conv_out_size(w_, k, stride, "SAME")
    mb = IC.choose_m_block(ho, wo, cap=cap)
    geo = layout.implicit_geometry()
    assert IC.window_fits_card(*IC.window_shape(mb, k, k, stride), geo["cpk"])
    xp = IC.pad_input(xin, k, k, stride, "SAME", mb, layout.tiles[0] * geo["cpk"]).contiguous()
    plan = layout.plan(gm)
    idx, cnt = (torch.from_numpy(a).to(dev) for a in (plan.idx, plan.cnt))
    kw = dict(kx=k, ky=k, stride=stride, mb=mb, block=layout.block, cpk=geo["cpk"],
              slot=geo["slot"], relu=True)
    return (xp, wp, idx, cnt, bias), kw


def _bf16_ulp_of_largest(want):
    """One bf16 ulp at the output's largest magnitude (the bar the f32 sums'
    order leaves after rounding to bf16; 3.2e-2 above is that bar at 4..8)."""
    return 2.0 ** (np.floor(np.log2(max(float(want.float().abs().max()), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("case", FLOAT_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_implicit_conv_float_tensor_core_instance(dev, case, packed, dtype):
    """The f32 (3xTF32) and bf16 instances against the plain version: f32
    within 1e-4, bf16 within one output ulp; two launches bit-identical,
    one launch counted per call; skip counters zero."""
    args, kw = _float_operands(case, packed, dtype, dev)
    before = kernels.launch_counts()["implicit_block_sparse_conv"]
    got, skips = IC.implicit_block_sparse_conv(*args, count_skips=True, **kw)
    again = IC.implicit_block_sparse_conv(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["implicit_block_sparse_conv"] == before + 2
    assert torch.equal(got, again)
    assert int(skips.abs().sum()) == 0
    want = IC.implicit_block_sparse_conv_plain(*args, **kw)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        _check(got, want, 1e-4)
    else:
        _check(got, want, _bf16_ulp_of_largest(want))
    if case[-1] == "zero_fblock":
        cnt, n_cu = args[3], case[8]
        if not packed:      # column 0 is live and flushes the bias through ReLU alone
            assert int(cnt[0]) > 0
            b0 = torch.clamp(args[4][:n_cu], min=0).to(dtype)
            assert torch.equal(got[:, :n_cu], b0.expand(got.shape[0], n_cu))


def _offset_copy(t, elems):
    """``t`` copied into a buffer ``elems`` elements past its start: the same
    values, contiguous, at a pointer off the 16-byte alignment."""
    buf = torch.zeros(t.numel() + elems, dtype=t.dtype, device=t.device)
    buf[elems:].copy_(t.reshape(-1))
    return buf[elems:].view(t.shape)


@pytest.mark.parametrize("bn", [128, 20])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_implicit_conv_float_unaligned_and_narrow_tiles(dev, bn, packed, dtype):
    """The float instance's element-copy paths: weight and activation
    pointers off the 16-byte alignment (weights copied element by element,
    the window in narrower chunks), and 20-lane tiles (bf16 rows not a whole
    number of 16-byte chunks, a partial last n8 tile, no zero-row flush)."""
    k, cin, cout, stride, h = 3, 12, 20, 1, 10
    rs = np.random.RandomState(bn + packed)
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((k, k, cin, cout), 4), packed=packed,
                                 bn=bn)
    gm = (rs.rand(layout.spec.num_groups) < 0.6).astype(np.float32)
    w = torch.from_numpy((rs.randn(k, k, cin, cout) / np.sqrt(k * k * cin)
                          ).astype(np.float32)).to(dev)
    x = torch.from_numpy(np.maximum(rs.randn(2, h, h, cin), 0).astype(np.float32)).to(dev)
    wp = layout.pack_weight(layout.spec.expand(gm).to(dev) * w).to(dtype).contiguous()
    mb = IC.choose_m_block(h, h)
    geo = layout.implicit_geometry()
    xp = IC.pad_input(x.to(dtype), k, k, stride, "SAME", mb,
                      layout.tiles[0] * geo["cpk"]).contiguous()
    bias = layout.pack_bias(torch.from_numpy(rs.randn(cout).astype(np.float32)).to(dev))
    plan = layout.plan(gm)
    idx, cnt = (torch.from_numpy(a).to(dev) for a in (plan.idx, plan.cnt))
    kw = dict(kx=k, ky=k, stride=stride, mb=mb, block=layout.block, cpk=geo["cpk"],
              slot=geo["slot"], relu=True)
    want = IC.implicit_block_sparse_conv_plain(xp, wp, idx, cnt, bias, **kw)
    for xa, wa in ((xp, wp), (_offset_copy(xp, 1), _offset_copy(wp, 1))):
        got = IC.implicit_block_sparse_conv(xa, wa, idx, cnt, bias, **kw)
        again = IC.implicit_block_sparse_conv(xa, wa, idx, cnt, bias, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        tol = 1e-4 if dtype == torch.float32 else _bf16_ulp_of_largest(want)
        _check(got, want, tol)


def test_bind_execution_refuses_bm_over_cap_on_cuda(dev):
    rs = np.random.RandomState(0)
    params = {"conv0": {"w": torch.from_numpy(rs.randn(3, 3, 3, 16).astype(np.float32))}}
    from repro_torch.models import cnn as TC
    cfg = TC.ResNetConfig(stages=(1,), widths=(16,), image_size=8)
    with pytest.raises(TC.PermanentBindError, match="bm <= 128"):
        TC.bind_execution(params, cfg, spec=TC.ExecSpec(bm=256, dense_fallback=2.0),
                          device="cuda")
    with pytest.raises(ValueError, match="bm <= 128"):
        TP.make_sparse_conv(TP.conv_gemm_layout(TG.fpga_conv_groups((3, 3, 3, 16), 12)),
                            np.ones(3 * 2, np.float32), bm=256,
                            weight=params["conv0"]["w"].to(dev))
    # at the cap the bind runs on the card
    ex = TC.bind_execution(params, cfg, spec=TC.ExecSpec(bm=128, dense_fallback=2.0),
                           device="cuda")
    assert ex.table[("conv0", "w")] is not None


@pytest.mark.parametrize("packed", [False, True])
def test_bound_conv_gpu_equals_cpu(dev, packed):
    """One layer through ``make_sparse_conv`` on both devices, streamed."""
    rs = np.random.RandomState(11)
    w = torch.from_numpy((rs.randn(3, 3, 16, 32) * 0.1).astype(np.float32))
    b = torch.from_numpy((rs.randn(32) * 0.1).astype(np.float32))
    x = torch.from_numpy(np.maximum(rs.randn(4, 16, 16, 16), 0).astype(np.float32))
    layout = TP.conv_gemm_layout(TG.fpga_conv_groups((3, 3, 16, 32), 12), packed=packed)
    gm = (rs.rand(layout.spec.num_groups) < 0.5).astype(np.float32)
    outs = []
    for d in (dev, torch.device("cpu")):
        conv = TP.make_sparse_conv(layout, gm, weight=w.to(d), bias=b.to(d), relu=True,
                                   quant=TQ.QuantSpec.calibrate(w), out_quant=TQ.QuantSpec(),
                                   activation_dsb=True)
        y, stats = conv.skip_counts(x.to(d), stride=2)
        outs.append((y.cpu(), stats))
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]
    with pytest.raises(ValueError, match="bind and call on one device"):
        conv(x.to(dev))


def _grad_case(M, block, dtype, all_tiles, seed, dev):
    rs = np.random.RandomState(seed)
    bk, bn = block
    nKb, nNb = 4, 3
    cells = rs.permutation(nKb * nNb)[:(nKb * nNb if all_tiles else 1)]
    kk = torch.from_numpy((cells // nNb).astype(np.int32)).to(dev)
    nn = torch.from_numpy((cells % nNb).astype(np.int32)).to(dev)
    x = torch.from_numpy(rs.randn(M, nKb * bk).astype(np.float32)).to(dev).to(dtype)
    g = torch.from_numpy(rs.randn(M, nNb * bn).astype(np.float32)).to(dev).to(dtype)
    return x, g, kk, nn


def _grad_scale(x, g, kk, nn, block):
    bk, bn = block
    ax, ag = x.float().abs(), g.float().abs()
    return max(float((ax[:, k * bk:(k + 1) * bk].T @ ag[:, n * bn:(n + 1) * bn]).max())
               for k, n in zip(kk.tolist(), nn.tolist()))


@pytest.mark.parametrize("block", [(8, 128), (16, 128), (128, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,bm,all_tiles", [(200, 8, False), (200, 8, True),
                                            (4096, 128, True), (131072, 128, False),
                                            (131072, 128, True)])
def test_grad_weight_kernel_vs_plain(dev, block, dtype, M, bm, all_tiles):
    x, g, kk, nn = _grad_case(M, block, dtype, all_tiles, M + block[0], dev)
    before = kernels.launch_counts()["block_sparse_grad_weight"]
    got = BSM.block_sparse_grad_weight(x, g, kk, nn, block=block, bm=bm)
    again = BSM.block_sparse_grad_weight(x, g, kk, nn, block=block, bm=bm)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["block_sparse_grad_weight"] == before + 2
    assert torch.equal(got, again)                  # fixed reduction order
    want = BSM.block_sparse_grad_weight_plain(x, g, kk, nn, block=block, bm=bm)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float((got.double() - want.double()).abs().max())
    assert err <= 1e-4 * _grad_scale(x, g, kk, nn, block), err


@pytest.mark.parametrize("block", [(16, 128), (128, 128)])
def test_grad_weight_scatter_on_gpu_dead_tiles_zero(dev, block):
    rs = np.random.RandomState(5)
    tm = rs.rand(4, 3) < 0.5
    tm[0, 0], tm[1, 1] = True, False
    bk, bn = block
    x = torch.from_numpy(rs.randn(1000, 4 * bk).astype(np.float32)).to(dev)
    g = torch.from_numpy(rs.randn(1000, 3 * bn).astype(np.float32)).to(dev)
    dw = OPS.make_block_sparse_grad_weight(tm, block, bm=128)(x, g)
    torch.cuda.synchronize()
    dead = torch.from_numpy(~np.repeat(np.repeat(tm, bk, 0), bn, 1)).to(dev)
    assert bool((dw[dead] == 0).all())
    want = x.T @ g
    assert float((dw[~dead] - want[~dead]).abs().max()) <= 1e-4 * float(
        (x.abs().T @ g.abs()).max())


# mistral-nemo-12b's ffn/wi (d_model x d_ff) on 2048 rows, (128, 128) tiles
LM_WI = (2048, 5120, 14336)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_block_sparse_matmul_and_grad_weight_at_the_lm_wi_shape(dev, dtype):
    """K1 (forward, and dX on the transposed plan) and K3 (dW) through
    ``make_block_sparse_matmul`` at the shape of an LM's FFN input weight:
    40 x 112 tiles, half of them live, 2048 rows; each against its plain
    version on the same CUDA operands (f32 1e-4 x max(1, max |want|), dW 1e-4
    x max(|x|ᵀ|g|), bf16 one ulp of the largest output); pruned tiles' dW
    bitwise 0."""
    M, K, N = LM_WI
    block = (128, 128)
    rs = np.random.RandomState(27)
    tm = rs.rand(K // 128, N // 128) < 0.5
    plan = TB.plan_from_tile_mask(tm, block)
    t_plan = TB.transpose_plan(plan, tm)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).to(dev).to(dtype)
    w = torch.from_numpy((rs.randn(K, N) / np.sqrt(K)).astype(np.float32)).to(dev).to(dtype)
    g = torch.from_numpy(rs.randn(M, N).astype(np.float32)).to(dev).to(dtype)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = kernels.launch_counts()
    y = OPS.make_block_sparse_matmul(plan, tm)(xr, wr)
    y.backward(g)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["block_sparse_matmul"] == before["block_sparse_matmul"] + 2
    assert after["block_sparse_grad_weight"] == before["block_sparse_grad_weight"] + 1
    t = lambda a: torch.from_numpy(a).to(dev)
    live = np.argwhere(tm)
    kk, nn = t(live[:, 0].astype(np.int32)), t(live[:, 1].astype(np.int32))
    want_y = BSM.block_sparse_matmul_plain(x, w, t(plan.idx), t(plan.cnt), block=block, bm=128)
    want_dx = BSM.block_sparse_matmul_plain(g, w.t().contiguous(), t(t_plan.idx),
                                            t(t_plan.cnt), block=t_plan.block, bm=128)
    compact = BSM.block_sparse_grad_weight_plain(x.float(), g.float(), kk, nn, block=block,
                                                 bm=128)
    dw = torch.zeros((K // 128, N // 128, 128, 128), device=dev)
    dw[kk.long(), nn.long()] = compact
    want_dw = dw.permute(0, 2, 1, 3).reshape(K, N).to(dtype)
    scale_dw = float((x.float().abs().t() @ g.float().abs()).max())
    for got, want, f32_bar in ((y, want_y, 1e-4 * max(1.0, float(want_y.abs().max()))),
                               (xr.grad, want_dx, 1e-4 * max(1.0, float(want_dx.abs().max()))),
                               (wr.grad, want_dw, 1e-4 * scale_dw)):
        assert got.dtype == dtype and got.shape == want.shape
        bar = f32_bar if dtype == torch.float32 else 2.0 ** -7 * float(want.abs().max())
        err = float((got.double() - want.double()).abs().max())
        assert err <= bar, (err, bar)
    dead = ~torch.from_numpy(np.kron(tm, np.ones(block, bool))).to(dev)
    assert bool((wr.grad[dead] == 0).all())


def test_grad_weight_wrapper_refusals(dev):
    x, g, kk, nn = _grad_case(256, (16, 128), torch.float32, True, 1, dev)
    with pytest.raises(ValueError, match="bk <= 128"):
        BSM.block_sparse_grad_weight(x.repeat(1, 4), g, kk, nn, block=(256, 128), bm=128)
    with pytest.raises(ValueError, match="is on cpu"):
        BSM.block_sparse_grad_weight(x, g.cpu(), kk, nn, block=(16, 128), bm=128)
    with pytest.raises(TypeError, match="must be int32"):
        BSM.block_sparse_grad_weight(x, g, kk.long(), nn, block=(16, 128), bm=128)
    with pytest.raises(TypeError, match="takes f32/bf16"):
        BSM.block_sparse_grad_weight(x.double(), g.double(), kk, nn, block=(16, 128), bm=128)


def _stack_case(M, block, dtype, layout, lanes, seed, dev):
    """Live tiles in a shuffled order. ``layout`` "multi": three output
    columns holding 2*width + 3, width and 1 live tiles (three stacks, one,
    one; width = tiles a stack holds), so one column needs more stacks than
    one and the columns' stack counts differ; "one": a single live tile.
    ``lanes`` < bn zeroes g past that many lanes of every column, as the
    conv path's packed output gradient is past a group's filters."""
    rs = np.random.RandomState(seed)
    bk, bn = block
    width = BSM.stack_width(bk)
    nKb, nNb = 2 * width + 4, 3
    if layout == "multi":
        cells = [(k, n) for n, c in enumerate((2 * width + 3, width, 1))
                 for k in rs.permutation(nKb)[:c]]
    else:
        cells = [(int(rs.randint(nKb)), int(rs.randint(nNb)))]
    cells = [cells[i] for i in rs.permutation(len(cells))]
    kk = torch.tensor([k for k, _ in cells], dtype=torch.int32, device=dev)
    nn = torch.tensor([n for _, n in cells], dtype=torch.int32, device=dev)
    x = torch.from_numpy(rs.randn(M, nKb * bk).astype(np.float32))
    g = torch.from_numpy(rs.randn(M, nNb, bn).astype(np.float32))
    g[:, :, lanes:] = 0.0
    return x.to(dev).to(dtype), g.reshape(M, nNb * bn).to(dev).to(dtype), kk, nn


@pytest.mark.parametrize("block", [(8, 128), (16, 128), (128, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["multi", "one"])
@pytest.mark.parametrize("lanes", [12, 128], ids=["lanes12", "dense"])
@pytest.mark.parametrize("M", [3000, 40000])
def test_grad_weight_kernel_stacks(dev, block, dtype, layout, lanes, M):
    """Stacks of one column's live tiles: more tiles than a stack holds,
    columns with different stack counts, g zero past 12 lanes or dense, M
    not a multiple of the row chunk, L = 1; within 1e-4 of the sums' scale
    of the plain version, two launches bit-identical, the bind's stack table
    and the call's own giving the same bits, and (g zero past 12 lanes) the
    same bits again when the call is told so (``g_lanes=12``: those lanes
    not read)."""
    x, g, kk, nn = _stack_case(M, block, dtype, layout, lanes, M + block[0] + lanes, dev)
    stacks = torch.from_numpy(BSM.grad_weight_stacks(kk.cpu().numpy(), nn.cpu().numpy(),
                                                     block[0])).to(dev)
    if layout == "multi":                        # 3 + 1 + 1 stacks, 7 for packed tiles
        assert stacks.shape[0] == 4 - (-3 // BSM.stack_width(block[0]))
    run = lambda **kw: BSM.block_sparse_grad_weight(x, g, kk, nn, block=block, bm=8, **kw)
    got = run(stacks=stacks)
    again = run(stacks=stacks)
    own = run()
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, own)
    want = BSM.block_sparse_grad_weight_plain(x, g, kk, nn, block=block, bm=8)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float((got.double() - want.double()).abs().max())
    assert err <= 1e-4 * _grad_scale(x, g, kk, nn, block), err
    if lanes < block[1]:
        assert float(got[:, :, lanes:].abs().max()) == 0.0
        told = run(stacks=stacks, g_lanes=lanes)
        torch.cuda.synchronize()
        assert torch.equal(told, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", ["misaligned", "misaligned_g_lanes", "narrow_tile"])
def test_grad_weight_kernel_element_copies(dev, dtype, variant):
    """The element-copy instances: operands at an address that is not 16-byte
    aligned (all lanes, or g zero past 12 lanes and ``g_lanes=12``), or a
    (6, 20) tile whose rows are not whole 16-byte units (21 tiles a stack);
    same bars as the 16-byte path."""
    block = (6, 20) if variant == "narrow_tile" else (16, 128)
    lanes = 12 if variant == "misaligned_g_lanes" else block[1]
    x, g, kk, nn = _stack_case(1000, block, dtype, "multi", lanes, 7, dev)
    if variant != "narrow_tile":
        def shift(t):
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
            out = buf[1:].view(t.shape)
            out.copy_(t)
            return out
        x, g = shift(x), shift(g)
        assert x.data_ptr() % 16 and g.data_ptr() % 16
    got = BSM.block_sparse_grad_weight(x, g, kk, nn, block=block, bm=8, g_lanes=lanes)
    again = BSM.block_sparse_grad_weight(x, g, kk, nn, block=block, bm=8, g_lanes=lanes)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = BSM.block_sparse_grad_weight_plain(x, g, kk, nn, block=block, bm=8)
    err = float((got.double() - want.double()).abs().max())
    assert err <= 1e-4 * _grad_scale(x, g, kk, nn, block), err


def test_grad_weight_refuses_g_lanes_out_of_range(dev):
    x, g, kk, nn = _grad_case(256, (16, 128), torch.float32, True, 1, dev)
    for bad in (0, 129):
        with pytest.raises(ValueError, match="g_lanes must be"):
            BSM.block_sparse_grad_weight(x, g, kk, nn, block=(16, 128), bm=128, g_lanes=bad)


def test_grad_weight_refuses_a_malformed_stack_table(dev):
    x, g, kk, nn = _grad_case(256, (16, 128), torch.float32, True, 1, dev)
    good = torch.from_numpy(BSM.grad_weight_stacks(kk.cpu().numpy(), nn.cpu().numpy(), 16))
    for bad in (good.to(dev)[:, :4], good.to(dev).long(), good,
                torch.zeros((kk.shape[0] + 1, 8), dtype=torch.int32, device=dev)):
        with pytest.raises(ValueError, match="stacks must be"):
            BSM.block_sparse_grad_weight(x, g, kk, nn, block=(16, 128), bm=128, stacks=bad)


# --- K4: dense int8 matmul -------------------------------------------------

def _int8_case(M, K, N, per_cout, seed, dev):
    """Codes over the whole int8 range, -128 included, plus a row and a
    column of -128 and of 127, so some sums pass 2^24 once K >= 1024 and the
    int -> f32 conversion rounds."""
    rs = np.random.RandomState(seed)
    x = rs.randint(-128, 128, (M, K)).astype(np.int8)
    w = rs.randint(-128, 128, (K, N)).astype(np.int8)
    x[0], w[:, 0] = -128, -128
    x[-1], w[:, -1] = 127, 127
    scale = (rs.uniform(1e-3, 1e-1, N).astype(np.float32) if per_cout
             else np.asarray([1.0 / 512], np.float32))
    to = lambda a: torch.from_numpy(a).to(dev)
    return to(x), to(w), to(scale)


@pytest.mark.parametrize("M,K,N,bm,bk,bn", [
    (128, 128, 128, 128, 128, 128), (256, 384, 256, 128, 128, 128),
    (512, 1152, 256, 128, 128, 128), (256, 2048, 384, 128, 128, 128),
    (48, 40, 96, 16, 8, 32), (96, 100, 64, 32, 4, 64), (192, 36, 24, 64, 4, 8),
    (24, 33, 40, 8, 1, 8)], ids=lambda v: str(v))
@pytest.mark.parametrize("per_cout", [False, True], ids=["scalar", "per_cout"])
def test_int8_matmul_kernel_vs_plain(dev, M, K, N, bm, bk, bn, per_cout):
    x, w, scale = _int8_case(M, K, N, per_cout, M + K + N, dev)
    before = kernels.launch_counts()["int8_matmul"]
    got = I8.int8_matmul(x, w, scale, bm=bm, bk=bk, bn=bn)
    again = I8.int8_matmul(x, w, scale, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["int8_matmul"] == before + 2
    assert torch.equal(got, again)
    want = I8.int8_matmul_plain(x, w, scale, bm=bm, bk=bk, bn=bn)
    _check(got, want, 0)
    _check(got, REF.int8_matmul_ref(x, w, scale if per_cout else 1.0 / 512), 0)
    # the CPU's plain version gives the same bits
    _check(got.cpu(), I8.int8_matmul_plain(x.cpu(), w.cpu(), scale.cpu(), bm=bm,
                                           bk=bk, bn=bn), 0)


def test_fixed_point_matmul_gpu_equals_cpu(dev):
    rs = np.random.RandomState(3)
    x = rs.uniform(-4, 4, (100, 256)).astype(np.float32)
    w = rs.uniform(-2, 2, (256, 128)).astype(np.float32)
    g = rs.randn(100, 128).astype(np.float32)
    outs = {}
    for d in (dev, torch.device("cpu")):
        xt = torch.from_numpy(x).to(d).requires_grad_()
        wt = torch.from_numpy(w).to(d).requires_grad_()
        before = kernels.launch_counts()["int8_matmul"]
        y = OPS.fixed_point_matmul(xt, wt)
        y.backward(torch.from_numpy(g).to(d))
        outs[d.type] = (y.detach().cpu(), xt.grad.cpu(), wt.grad.cpu(),
                        kernels.launch_counts()["int8_matmul"] - before)
    (y, dx, dw, n), (y0, dx0, dw0, n0) = outs["cuda"], outs["cpu"]
    assert n == 1 and n0 == 0
    assert torch.equal(y, y0)
    assert float((dx - dx0).abs().max()) <= 1e-4
    assert float((dw - dw0).abs().max()) <= 1e-4 * float((np.abs(x).T @ np.abs(g)).max())


def test_int8_matmul_wrapper_refusals(dev):
    x, w, scale = _int8_case(128, 128, 128, True, 1, dev)
    with pytest.raises(ValueError, match="bm <= 128"):
        I8.int8_matmul(x.repeat(2, 1), w, scale, bm=256)
    with pytest.raises(ValueError, match="is on cpu"):
        I8.int8_matmul(x, w.cpu(), scale)
    with pytest.raises(TypeError, match="int8 codes"):
        I8.int8_matmul(x.float(), w, scale)
    with pytest.raises(ValueError, match="tile-aligned"):
        I8.int8_matmul(x[:100], w, scale)
    with pytest.raises(ValueError, match="scale must be"):
        I8.int8_matmul(x, w, scale[:7])


def _kernel_tile_rule(M, N, sms):
    """The launcher's rule, restated: the first of 128 x 128, 64 x 128 and
    64 x 64 that gives a block for every SM, else 64 x 64."""
    for bm, bn in ((128, 128), (64, 128), (64, 64)):
        blocks = -(-M // bm) * -(-N // bn)
        if blocks >= sms:
            break
    return bm, bn, blocks


def _caller_tile(n):
    """The largest caller tile <= 128 that divides n (8 always does here)."""
    return max(d for d in (8, 24, 72, 128, n) if d <= 128 and n % d == 0)


def _int8_matmul_checked(x, w, scale, per_cout, bm, bk, bn):
    """Two launches of K4, bit-identical, each counted once, bit-equal to the
    plain version and to ``int8_matmul_ref``; sums past 2^24 once K >= 1152."""
    before = kernels.launch_counts()["int8_matmul"]
    got = I8.int8_matmul(x, w, scale, bm=bm, bk=bk, bn=bn)
    again = I8.int8_matmul(x, w, scale, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["int8_matmul"] == before + 2
    assert torch.equal(got, again)
    _check(got, I8.int8_matmul_plain(x, w, scale, bm=bm, bk=bk, bn=bn), 0)
    _check(got, REF.int8_matmul_ref(x, w, scale if per_cout else float(scale)), 0)
    if x.shape[1] >= 1152:
        assert int(REF.int_matmul_exact(x, w).abs().max()) > 2 ** 24
    return got


@pytest.mark.parametrize("K", [100, 1152])
@pytest.mark.parametrize("N", [8, 24, 72, 136, 8192])
@pytest.mark.parametrize("M", [8, 24, 72, 136, 8192])
@pytest.mark.parametrize("per_cout", [False, True], ids=["scalar", "per_cout"])
def test_int8_matmul_imma_ragged_tiles(dev, M, N, K, per_cout):
    """Outputs whose M and N are no multiple of the kernel's block tile (nor,
    past 128, of the caller's): rows and columns past M, N zero-filled and
    not stored; K = 100 takes 4-byte copies, K = 1152 16-byte copies where N
    allows (N = 8192) and 8-byte ones elsewhere."""
    x, w, scale = _int8_case(M, K, N, per_cout, M + 3 * N + K, dev)
    _int8_matmul_checked(x, w, scale, per_cout, _caller_tile(M), K, _caller_tile(N))


@pytest.mark.parametrize("K", [1, 4, 16, 24, 32, 33, 48, 100, 1152, 2048])
@pytest.mark.parametrize("M,N", [(136, 72), (200, 128)])
@pytest.mark.parametrize("per_cout", [False, True], ids=["scalar", "per_cout"])
def test_int8_matmul_imma_k_tails(dev, M, N, K, per_cout):
    """Depths that end inside a 128-deep stage, a 32-deep step or a 16-deep
    tail (1, 4, 24, 33, 48, 100), whole steps and stages, and sums past
    2^24; element copies at K = 1 and 33, 4-, 8- and 16-byte copies
    elsewhere as K and N allow."""
    x, w, scale = _int8_case(M, K, N, per_cout, 7 * K + N, dev)
    _int8_matmul_checked(x, w, scale, per_cout, 8, 1, 8)


@pytest.mark.parametrize("which", ["x", "w", "both"])
@pytest.mark.parametrize("M,K,N", [(72, 100, 136), (8192, 640, 128)])
def test_int8_matmul_imma_one_byte_off(dev, M, K, N, which):
    """x and w as views one byte past an aligned address: the launcher takes
    element copies, the same kernel."""
    x, w, scale = _int8_case(M, K, N, True, M + K + N + len(which), dev)
    if which in ("x", "both"):
        x = _offset(x, 1)
    if which in ("w", "both"):
        w = _offset(w, 1)
    _int8_matmul_checked(x, w, scale, True, _caller_tile(M), K, _caller_tile(N))


@pytest.mark.parametrize("M,N", [(128, 128), (128, 256), (8192, 128), (4096, 4096),
                                 (4096, 512), (8, 8)])
def test_int8_matmul_kernel_tile(dev, M, N):
    """The tile the kernel reports is the launcher's rule on this card's SM
    count, not the caller's (bm, bn) = (128, 128); at the im2col row shape
    it runs at least 128 blocks."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert I8.kernel_tile(M, N, dev) == _kernel_tile_rule(M, N, sms)
    if (M, N) == (8192, 128):
        assert I8.kernel_tile(M, N, dev)[2] >= 128



def test_dense_training_gradients_are_full_f32(dev):
    """The dense rung's backward runs in full f32 (TF32 off): the dense
    training step of the executed-sparsity bench's net (HAPM 0.5, batch 4)
    stays within 1e-5 of float64 (the backward picked by autograd, on cuDNN
    with TF32, read 4.1e-4 on the conv0 weight)."""
    import torch.nn.functional as F
    from benchmarks import bench_sparse_cnn_torch as BENCH
    from repro_torch.core import apply_masks
    from repro_torch.core.masks import tree_flatten_with_path, tree_map
    from repro_torch.models import cnn
    from repro_torch.train.loop import value_and_grad

    params, state, specs = BENCH.make_model(dev)
    pruned, gm = BENCH.hapm_prune(params, specs, 0.5)
    masks = BENCH.element_masks(specs, gm, dev)
    x = BENCH.frames(4, dev)
    y = torch.from_numpy(np.random.RandomState(2).randint(0, 10, 4)).to(dev)

    def grads(p, s, xx):
        def loss(q):
            logits, ns = cnn.apply(apply_masks(q, masks), s, xx, BENCH.CFG, train=True)
            return -torch.mean(F.log_softmax(logits, -1).gather(1, y[:, None])), ns
        return {k: v.double() for k, v in tree_flatten_with_path(value_and_grad(loss, p)[1])}

    to64 = lambda t: t.double()
    g64 = grads(tree_map(to64, pruned), tree_map(to64, state), x.double())
    g = grads(pruned, state, x)
    assert max(float((g[k] - g64[k]).abs().max()) for k in g64) <= 1e-5


@pytest.mark.parametrize("shape", [(8, 8, 8, 16), (32, 4, 4, 64), (128, 8, 8, 64)])
def test_global_avg_pool_does_not_depend_on_the_batch(dev, shape):
    """The heads' pool reads the same bits for an image in any batch."""
    from repro_torch.models import cnn
    h = torch.rand(*shape, device=dev)
    pooled = cnn._global_avg_pool(h)
    for b in (1, 2, 4, shape[0] // 2):
        assert torch.equal(cnn._global_avg_pool(h[:b]), pooled[:b]), b
    assert float((pooled - h.mean(dim=(1, 2))).abs().max()) <= 1e-6


@pytest.mark.parametrize("config", ["smoke", "full"])
def test_served_logits_do_not_depend_on_the_bucket(dev, config):
    """Per-image independence on the card, as the serving bench's chaos
    scenario relies on it: two frames served alone and behind other frames
    in the largest bucket read the same bits, at every rung of the streamed
    server's ladder (the f32 rung did not while the head pooled with
    ``torch.mean``)."""
    from benchmarks import bench_serving_cnn_torch as BENCH
    from repro_torch.launch.serve_cnn import CnnServer
    from repro_torch.models import cnn
    _, _, cfg, n_cu, buckets, _, _ = BENCH._setup(
        BENCH.parse_args(["--smoke"] if config == "smoke" else []))
    params, state, _ = BENCH._pruned_model(cfg, n_cu, 0.5, device=dev)
    spec = cnn.ExecSpec(n_cu=n_cu, quantized=True, folded=True, streamed=True,
                        dense_fallback=2.0)
    srv = CnnServer(params, state, cfg, spec=spec, buckets=buckets, device=dev)
    h = cfg.image_size
    x2 = np.random.RandomState(1001).rand(2, h, h, 3).astype(np.float32)
    rest = np.random.RandomState(1000).rand(buckets[-1] - 2, h, h, 3).astype(np.float32)
    for level in range(len(srv.rungs)):
        srv.force_level(level)
        alone = srv.infer(x2).cpu()
        behind = srv.infer(np.concatenate([rest, x2])).cpu()[-2:]
        assert torch.equal(alone, behind), (level, float((alone - behind).abs().max()))


@pytest.mark.parametrize("target", [0.25, 0.5, 0.75])
def test_blocksparse_bench_levels_on_the_card(dev, target):
    """The tile-HAPM block-sparse bench (``bench_blocksparse_torch``) at each
    level, K1's f32 instance on the card: within 1e-4 of its plain version on
    the same CUDA operands, one launch per call, and the skipped tiles of a
    CPU run."""
    from benchmarks import bench_blocksparse_torch as BS
    t, x, w, tm, plan, f = next(lv for lv in BS.levels(dev) if lv[0] == target)
    cpu_tm = next(lv[3] for lv in BS.levels(torch.device("cpu")) if lv[0] == target)
    assert plan.skipped_tiles == int((~cpu_tm).sum()) == {0.25: 16, 0.5: 32, 0.75: 48}[target]
    before = kernels.launch_counts()["block_sparse_matmul"]
    got = f(x, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["block_sparse_matmul"] == before + 1
    want = BSM.block_sparse_matmul_plain(x, w, torch.from_numpy(plan.idx).to(dev),
                                         torch.from_numpy(plan.cnt).to(dev),
                                         block=BS.BLOCK, bm=128)
    _check(got, want, 1e-4)


def test_simulate_report_on_the_card_equals_the_cpu(dev):
    """One Table II row (HAPM 0.5 on the 100 MHz Zedboard, DSB on) priced by
    ``simulate`` with its accuracy forward and activation capture on the card:
    every field equal to a CPU run on the same models and frames."""
    import dataclasses
    from repro_torch.accel import BOARDS, simulate
    from repro_torch.core import (HAPMConfig, apply_masks, hapm_element_masks,
                                  hapm_epoch_update, hapm_init)
    from repro_torch.data.synthetic import SyntheticCifar
    from repro_torch.models import cnn
    cfg = cnn.ResNetConfig(quantized=True)
    params, state = cnn.init(0, cfg, device="cpu")
    specs = cnn.conv_group_specs(params, 12)
    hcfg = HAPMConfig(0.5, 1)
    st = hapm_epoch_update(hapm_init(specs, hcfg), specs, params, hcfg)
    params = apply_masks(params, hapm_element_masks(specs, st))
    ds = SyntheticCifar(num_train=8, num_test=32)
    reps = [simulate(params, state, cfg, BOARDS["zedboard_100mhz_72dsp"], ds.test_x,
                     ds.test_y, device=d) for d in (dev, "cpu")]
    for f in dataclasses.fields(reps[0]):
        a, b = (getattr(r, f.name) for r in reps)
        assert a == b, f.name
    assert reps[0].row() == reps[1].row()


def test_bn_inverse_std_is_the_same_bits_on_the_card(dev):
    """BN's 1/sqrt(var + eps) reads the same bits on the card as on the CPU
    (an f32 ``torch.sqrt`` does not: the Q3.4 codes after BN, and with them
    ``simulate``'s activation-column fractions, then differed between a card
    run and a CPU run of the same trained model)."""
    from repro_torch.models import cnn
    var = torch.rand(1_000_000, generator=torch.Generator().manual_seed(0)) * 10
    assert torch.equal(cnn._inv_std(var.to(dev), 1e-5).cpu(), cnn._inv_std(var, 1e-5))


# ---------------------------------------------------------------------------
# The transformer LM family on the card (no kernel of this repo: its
# products are library matmuls; these hold the card's run to the CPU's)
# ---------------------------------------------------------------------------

LM_ARCHS = ("gemma2-9b", "gemma-7b", "qwen3-32b", "mistral-nemo-12b", "paligemma-3b",
            "musicgen-medium", "granite-moe-3b-a800m", "mixtral-8x22b")


def _lm_batch(cfg, B, S, seed):
    rs = np.random.RandomState(seed)
    if cfg.family == "audio":
        return {"tokens": None,
                "embeds": (rs.randn(B, S, cfg.d_model) * 0.1).astype(np.float32)}
    if cfg.family == "vlm":
        P = cfg.num_prefix_tokens
        return {"tokens": rs.randint(0, cfg.vocab_size, (B, S - P)).astype(np.int32),
                "embeds": (rs.randn(B, P, cfg.d_model) * 0.1).astype(np.float32)}
    return {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_forward_and_prefill_on_the_card_match_the_cpu(dev, arch):
    """Each transformer-family smoke config (f32, TF32 off): the same
    weights and inputs on the card and on the CPU, logits within 1e-4 of
    the largest |logit| — the plain forward and a prefill through caches."""
    from repro_torch.configs import registry
    from repro_torch.core.masks import tree_map
    from repro_torch.models import transformer as TT
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = registry.get(arch).smoke
    params = TT.init(3, cfg, device="cpu")
    card = tree_map(lambda t: t.to(dev), params)
    b = _lm_batch(cfg, 2, 16, 5)
    on = lambda d: {k: None if v is None else torch.from_numpy(v).to(d) for k, v in b.items()}
    for caches in (False, True):
        kw = lambda d: {"caches": TT.init_caches(cfg, 2, 20, device=d)} if caches else {}
        lc, _, ac = TT.forward(card, on(dev), cfg, **kw(dev))
        lh, _, ah = TT.forward(params, on("cpu"), cfg, **kw("cpu"))
        assert float((lc.cpu() - lh).abs().max()) <= 1e-4 * float(lh.abs().max())
        assert abs(float(ac) - float(ah)) <= 1e-5


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_lm_recurrent_smoke_on_the_card_matches_the_cpu(dev, arch):
    """The recurrent families' smoke configs (f32, TF32 off) through the
    front door: the same weights and inputs on the card and on the CPU,
    logits within 1e-4 of the largest |logit| — the plain forward, a prefill
    through caches, and four decode steps after it."""
    from repro_torch.configs import registry
    from repro_torch.core.masks import tree_map
    from repro_torch.models import lm as LM
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = registry.get(arch).smoke
    params = LM.init(3, cfg, device="cpu")
    card = tree_map(lambda t: t.to(dev), params)
    toks = torch.from_numpy(_lm_batch(cfg, 2, 20, 5)["tokens"])
    for caches in (False, True):
        kw = lambda d: {"caches": LM.init_caches(cfg, 2, 20, device=d)} if caches else {}
        lc, _, _ = LM.forward(card, {"tokens": toks[:, :16].to(dev)}, cfg, **kw(dev))
        lh, _, _ = LM.forward(params, {"tokens": toks[:, :16]}, cfg, **kw("cpu"))
        assert float((lc.cpu() - lh).abs().max()) <= 1e-4 * float(lh.abs().max())
    _, cc = LM.prefill(card, {"tokens": toks[:, :16].to(dev)}, cfg, max_len=20)
    _, ch = LM.prefill(params, {"tokens": toks[:, :16]}, cfg, max_len=20)
    for t in range(16, 20):
        pos = torch.full((2,), t, dtype=torch.int32)
        lc, cc = LM.decode_step(card, cc, toks[:, t].to(dev), pos.to(dev), cfg)
        lh, ch = LM.decode_step(params, ch, toks[:, t], pos, cfg)
        assert float((lc.cpu() - lh).abs().max()) <= 1e-4 * float(lh.abs().max())


def test_lm_ring_buffer_longer_prefill_on_the_card(dev):
    """A prefill of 16 positions into an 8-slot ring (S > W) on CUDA: each
    slot keeps the last position that maps to it (``index_put_`` with
    duplicate indices would pick one at random), the same as the CPU."""
    from repro_torch.configs import registry
    from repro_torch.models import layers as L
    cfg = registry.get("gemma2-9b").smoke
    g = torch.Generator().manual_seed(1)
    p = L.attn_init(g, cfg, torch.float32)
    x = torch.randn(3, 16, cfg.d_model, generator=g)
    pos = torch.arange(16, dtype=torch.int32)[None].expand(3, 16)
    for _ in range(3):
        out = {}
        for d in (dev, torch.device("cpu")):
            cache = L.attn_cache_init(cfg, 3, 8, torch.float32, device=d)
            o, c = L.attn_apply({k: v.to(d) for k, v in p.items()}, x.to(d), cfg, pos.to(d),
                                8, cache)
            out[d.type] = (o.cpu(), {k: v.cpu() for k, v in c.items()})
        assert torch.equal(out["cuda"][1]["pos"], out["cpu"][1]["pos"])
        assert torch.equal(out["cuda"][1]["pos"][0], torch.arange(8, 16, dtype=torch.int32))
        assert float((out["cuda"][1]["k"] - out["cpu"][1]["k"]).abs().max()) <= 1e-5
        assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= 1e-4


def test_moe_manual_tp_through_a_one_rank_nccl_group(dev):
    """``moe_manual_tp`` on the card's (1, 1) mesh: the f32-boundary branch,
    its sum over ``model`` an ``all_reduce`` on a one-rank NCCL group, equal
    to the local path run in f32 and cast back."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.dist import ShardFlags, make_rules, use_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as M
    mesh = make_host_mesh()
    assert dist.get_backend(mesh.get_group("model")) in ("nccl", "cpu:gloo,cuda:nccl")
    cfg = dataclasses.replace(registry.get("granite-moe-3b-a800m").smoke, dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(2)
    p = M.moe_init(g, cfg, torch.bfloat16, device=dev)
    x = torch.randn(2, 12, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    with use_rules(make_rules(mesh, "serve", ShardFlags(moe_manual_tp=True))):
        got, aux = M.moe_apply(p, x, cfg)
    want, aux_w = M.moe_apply({k: v.float() for k, v in p.items()}, x.float(),
                              dataclasses.replace(cfg, dtype="float32"))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16)) and torch.equal(aux, aux_w)


def test_prefetch_waits_for_its_copies_on_a_large_batch(dev):
    """``prefetch`` copies 256 MB batches on its own stream from a
    background thread; the consumer's stream reads each batch at once, and
    it must be the whole batch (the consumer waits on the copy's event)."""
    from repro_torch.data.pipeline import prefetch
    n = 64 * 1024 * 1024                 # int32: 256 MB a batch

    def source():
        for i in range(6):
            yield {"x": np.full((n,), i, np.int32), "none": None}

    seen = []
    for i, b in enumerate(prefetch(source(), depth=2, device=dev)):
        assert b["none"] is None and b["x"].device.type == "cuda"
        seen.append(bool((b["x"] == i).all()))
    assert seen == [True] * 6


def test_queued_device_ms_agrees_with_the_profiler_and_refuses_a_waiting_call(dev):
    """``queued_device_ms`` (the bench timers' way past a profiler that
    lost every record of a kernel) reads a product's device time within
    10 % of the profiler's time per record, and reads ``None`` for a call
    that waits on the device, which a spin kernel cannot hold back."""
    from repro_torch.kernels import profile_device_records, queued_device_ms
    a = torch.randn(2048, 2048, device=dev)
    fn = lambda: torch.mm(a, a)
    got = queued_device_ms(fn, 20, dev)
    records = profile_device_records(fn, 20, dev).records
    us, n = map(sum, zip(*records.values()))
    per_call = max(1, round(n / 20))            # the product's kernels a call
    assert n > 0 and got == pytest.approx(us / n * per_call / 1e3, rel=0.1)
    assert queued_device_ms(lambda: fn().sum().item(), 5, dev) is None
