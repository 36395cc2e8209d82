"""Hand-written Hopper kernels of the port and their shared build step.

Each kernel package holds ``csrc/<name>.cu`` (CUDA C++ with a plain C
interface), ``ref.py`` (the plain PyTorch version) and ``ops.py`` (the
wrapper that checks its operands, launches the kernel on PyTorch's
current stream and counts its launches). Sources are compiled at first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

into ``src/repro_torch/_build/`` (git-ignored) and loaded with
``ctypes``. The file name carries a hash of the source, so an edited
source is rebuilt and a cached library is reused across processes.
Nothing is compiled at import time: the CPU tests import every module
and there is no ``nvcc`` there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "_build"

# name -> source, one shared library per kernel package
SOURCES = {
    "lmi_filter": _PKG / "lmi_filter" / "csrc" / "lmi_filter.cu",
    "kmeans_assign": _PKG / "kmeans_assign" / "csrc" / "kmeans_assign.cu",
    "beam_eval": _PKG / "beam_eval" / "csrc" / "beam_eval.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "pairwise_l2": _PKG / "pairwise_l2" / "csrc" / "pairwise_l2.cu",
    "embedding_bag": _PKG / "embedding_bag" / "csrc" / "embedding_bag.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: dict[str, str] = {}  # name -> nvcc's output (ptxas register / smem report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one kernel package; None when already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{out}")
    os.replace(tmp, target)


def build_all(names=None) -> float:
    """Compile every kernel package in parallel (one nvcc per source, all
    started together) and return the wall seconds the build took."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel package, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


def stream_handle() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream as a ctypes pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check_status(name: str, status: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
