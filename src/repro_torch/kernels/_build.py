"""Build and load the CUDA kernels under ``repro_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. The build happens at the first use of a
kernel on a CUDA tensor, never at import: importing this package needs
neither ``nvcc`` nor a GPU.

The library lands in ``build/repro_torch/`` beside ``src/`` (derived from
this package's own path) under a name keyed on a hash of every source
file, so a stale library is never loaded. A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None     # wall time of this process's build
                                          # (0.0 when a cached library loaded)


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def build_dir() -> Path:
    # <root>/src/repro_torch/kernels/_build.py -> <root>/build/repro_torch
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    cu, cuh = sources()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda) — the CUDA "
        "kernels are compiled from repro_torch/csrc at first use")


def library_path() -> Path:
    return build_dir() / f"libhapm_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc -c`` per source, all started
    together) and link them into the hashed shared library. Returns its
    path; reuses an existing library of the same hash."""
    global build_seconds
    out = library_path()
    if out.exists():
        if build_seconds is None:
            build_seconds = 0.0
        return out
    nvcc = find_nvcc()
    cu, _ = sources()
    if not cu:
        raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    objs, procs = [], []
    for src in cu:
        # per-process names: two processes may build the same hash at once
        obj = out.parent / f"{src.stem}_{out.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)                  # atomic: no half-written library
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.time() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call. ``argtypes`` are set here:
    without them ctypes would pass a pointer as a 32-bit int."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.hapm_block_sparse_matmul.argtypes = [P] * 8 + [I] * 10 + [P]
    lib.hapm_block_sparse_matmul.restype = I
    lib.hapm_implicit_block_sparse_conv.argtypes = [P] * 9 + [I] * 21 + [P]
    lib.hapm_implicit_block_sparse_conv.restype = I
    lib.hapm_block_sparse_grad_weight.argtypes = [P] * 7 + [I] * 12 + [P]
    lib.hapm_block_sparse_grad_weight.restype = I
    lib.hapm_int8_matmul.argtypes = [P] * 4 + [I] * 5 + [P]
    lib.hapm_int8_matmul.restype = I
    lib.hapm_int8_matmul_tile.argtypes = [I, I, P]
    lib.hapm_int8_matmul_tile.restype = I
    _lib = lib
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise on a refused launch (``cudaGetLastError`` of the C wrapper): a
    refused launch never runs and a later synchronize does not report it."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
