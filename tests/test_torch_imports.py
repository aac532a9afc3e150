"""The port stands alone: no module under ``src/repro_torch``, no bench twin
``benchmarks/*_torch.py`` and not ``chip_smoke.py`` imports ``jax`` or
anything of the JAX package ``repro``, and nothing imports ``triton`` or
builds a kernel at import time."""
import ast
import os
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
TWIN_FILES = sorted((ROOT / "benchmarks").glob("*_torch.py"))
FILES = PORT_FILES + TWIN_FILES + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "triton", "flax", "optax"}


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_has_its_modules():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES}
    for want in ("core/quant.py", "core/groups.py", "core/masks.py", "core/hapm.py",
                 "sparse/block_mask.py", "sparse/conv_plan.py",
                 "kernels/conv_lowering.py", "kernels/ref.py",
                 "kernels/block_sparse_matmul.py", "kernels/implicit_conv.py",
                 "kernels/ops.py", "models/cnn.py", "configs/resnet21_cifar.py",
                 "launch/exec_cache.py", "launch/resilience.py",
                 "launch/serve_cnn.py", "launch/train_cnn.py", "core/uniform.py",
                 "data/synthetic.py", "train/optimizer.py", "train/compression.py",
                 "train/loop.py", "train/checkpoint.py", "train/cnn_training.py",
                 "accel/config.py", "accel/cycle_model.py", "accel/scheduler.py",
                 "accel/simulator.py", "kernels/int8_matmul.py",
                 "launch/quickstart.py"):
        assert want in names, want
    twins = {p.name for p in TWIN_FILES}
    assert {"bench_sparse_cnn_torch.py", "check_sparse_regression_torch.py",
            "bench_serving_cnn_torch.py"} <= twins


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [(mod, line) for mod, line in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_importing_the_port_needs_no_compiler():
    """Importing every module and bench twin, in a fresh interpreter, builds
    nothing, loads no CUDA library and imports neither ``triton`` nor
    ``jax``."""
    import subprocess

    pytest.importorskip("torch")
    mods = []
    for p in PORT_FILES:
        rel = p.relative_to(ROOT / "src").with_suffix("")
        mods.append(".".join(rel.parts).removesuffix(".__init__"))
    mods += [f"benchmarks.{p.stem}" for p in TWIN_FILES]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._lib is None and _build.build_seconds is None\n"
        "bad = [m for m in ('triton', 'jax', 'repro') if m in sys.modules]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                          capture_output=True, timeout=300, cwd=str(ROOT))
    assert done.returncode == 0, done.stderr


def test_kernel_sources_share_one_epilogue_header():
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    cu = sorted(p.name for p in csrc.glob("*.cu"))
    assert cu == ["block_sparse_grad_weight.cu", "block_sparse_matmul.cu",
                  "implicit_conv.cu", "int8_matmul.cu"]
    for name in cu:
        text = (csrc / name).read_text()
        assert '#include "epilogue.cuh"' in text
        assert "torch/extension.h" not in text
    assert "flush_epilogue" in (csrc / "epilogue.cuh").read_text()
    # K4 multiplies on the tensor cores through the shared int8 fragments
    # header, with no CUDA-core dot product (__dp4a) left
    k4 = (csrc / "int8_matmul.cu").read_text()
    assert '#include "mma_s8.cuh"' in k4 and '#include "epilogue.cuh"' in k4
    assert "__dp4a" not in k4
    # K2's float instances take their 3xTF32 / bf16 fragments from the
    # shared header that the other float kernels are to include
    conv = (csrc / "implicit_conv.cu").read_text()
    assert '#include "mma_f32.cuh"' in conv and '#include "epilogue.cuh"' in conv
    header = (csrc / "mma_f32.cuh").read_text()
    for name in ("split_tf32", "mma_3xtf32", "mma_bf16", "m16n8k8.row.col.f32.tf32",
                 "m16n8k16.row.col.f32.bf16"):
        assert name in header, name
