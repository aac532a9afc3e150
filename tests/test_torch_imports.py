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


# modules of the JAX package with no twin, on purpose
NOT_PORTED = {"dist/compat.py": "a shim over JAX versions' sharding APIs; PyTorch needs none"}
# the examples' twins are entry points of the port
EXAMPLE_TWINS = {"prune_lm_blocksparse.py": "launch/prune_lm_blocksparse.py",
                 "quickstart.py": "launch/quickstart.py",
                 "serve_lm.py": "launch/serve_lm.py",
                 "train_cifar_hapm.py": "launch/train_cnn.py"}


def test_port_has_its_modules():
    """A walk of both packages: every module of ``src/repro`` has its twin
    at the same path under ``src/repro_torch`` (but those in
    ``NOT_PORTED``), every example its entry point, every bench and
    ``run.py`` its ``_torch`` twin."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES}
    reference = {str(p.relative_to(ROOT / "src" / "repro"))
                 for p in (ROOT / "src" / "repro").rglob("*.py")}
    assert reference - names == set(NOT_PORTED)
    assert not set(NOT_PORTED) & names
    examples = {p.name for p in (ROOT / "examples").glob("*.py")}
    assert examples == set(EXAMPLE_TWINS)
    assert set(EXAMPLE_TWINS.values()) <= names
    twins = {p.name for p in TWIN_FILES}
    benches = {p.stem for p in (ROOT / "benchmarks").glob("bench_*.py")
               if not p.stem.endswith("_torch")}
    assert {"bench_roofline", "bench_blocksparse"} <= benches
    assert {f"{b}_torch.py" for b in benches} | {"run_torch.py",
                                                 "check_sparse_regression_torch.py"} <= twins
    assert "train/cnn_training.py" in names      # the twin of benchmarks/cnn_training.py
    for want in ("launch/train.py", "launch/analysis.py", "launch/dryrun.py",
                 "models/lm.py", "configs/shapes.py",
                 *(f"configs/{a}.py" for a in COPIED_CONFIGS)):
        assert want in names, want


COPIED_CONFIGS = ("gemma2_9b", "gemma_7b", "granite_moe_3b_a800m", "mistral_nemo_12b",
                  "mixtral_8x22b", "musicgen_medium", "paligemma_3b", "qwen3_32b",
                  "xlstm_350m", "zamba2_7b")


def _statements(path: pathlib.Path) -> list:
    """The module's statements, its docstring left out."""
    body = ast.parse(path.read_text(), filename=str(path)).body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    return [ast.dump(node) for node in body]


@pytest.mark.parametrize("rel", ["models/lm_config.py", "configs/registry.py",
                                 *(f"configs/{a}.py" for a in COPIED_CONFIGS)])
def test_copied_modules_equal_their_originals(rel):
    """The pure-Python modules the port copies (the LM config, the
    architecture registry and its per-arch files) say what the JAX
    package's say, statement by statement; only the docstring may differ."""
    assert _statements(ROOT / "src" / "repro_torch" / rel) == \
        _statements(ROOT / "src" / "repro" / rel)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [(mod, line) for mod, line in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


REFERENCE_BENCHES = {p.stem for p in (ROOT / "benchmarks").glob("*.py")
                     if not p.stem.endswith("_torch") and p.stem != "__init__"}


def _benchmark_modules(path: pathlib.Path):
    """(module of ``benchmarks/`` imported, line), by absolute
    (``benchmarks.x``, ``from benchmarks import x``) or relative
    (``from . import x``, ``from .x import y``) import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if parts[0] == "benchmarks" and len(parts) > 1:
                    yield parts[1], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and node.module.split(".")[0] != "benchmarks":
                continue
            if node.level > 1:
                continue
            sub = (node.module or "").split(".")
            if node.level == 0:
                sub = sub[1:]
            if sub and sub[0]:
                yield sub[0], node.lineno
            else:
                for a in node.names:
                    yield a.name, node.lineno


def test_reference_bench_modules_are_known():
    assert {"cnn_training", "run", "bench_training", "bench_inference",
            "bench_cycle_model", "bench_blocksparse", "bench_sparse_cnn",
            "bench_serving_cnn", "check_sparse_regression"} <= REFERENCE_BENCHES


@pytest.mark.parametrize("path", TWIN_FILES, ids=lambda p: p.name)
def test_twins_import_no_reference_bench(path):
    bad = [(m, line) for m, line in _benchmark_modules(path) if m in REFERENCE_BENCHES]
    assert not bad, f"{path}: imports reference bench modules {bad}"


@pytest.mark.parametrize("source,found", [
    ("from . import cnn_training as CT", ["cnn_training"]),
    ("from .bench_training import run", ["bench_training"]),
    ("from benchmarks import run, bench_training_torch", ["run", "bench_training_torch"]),
    ("import benchmarks.bench_inference", ["bench_inference"]),
    ("from benchmarks.run_torch import main", ["run_torch"]),
    ("from repro_torch import accel", []),
])
def test_benchmark_import_finder(tmp_path, source, found):
    f = tmp_path / "x.py"
    f.write_text(source + "\n")
    assert [m for m, _ in _benchmark_modules(f)] == found


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
