"""Build and load the package's CUDA kernels (``hot_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. The build happens at first
use, into ``build/hot_tpu_torch/`` at the root of the checkout, under a file
name that carries a hash of the sources and flags, so a stale library is
never loaded. There is no fallback: a missing compiler, a failed build or a
failed launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "hot_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_SIGNATURES = {
    # (dtype, dim, w, node_ids, gwn, F, U, V, A, bp, bm, V0, dt, df, n, stream)
    "hot_fused_apply": [ctypes.c_int, ctypes.c_int] + [_P] * 10
                       + [ctypes.c_double, _P, ctypes.c_longlong, _P],
    # (model, dtype, dim, v, node_ids, gwn, F, mu, lam, V0, dt, project,
    #  f, U, V, A, bp, bm, n, stream)
    "hot_fused_linearize": [ctypes.c_int] * 3 + [_P] * 7
                           + [ctypes.c_double, ctypes.c_int] + [_P] * 6
                           + [ctypes.c_longlong, _P],
}


class _Library:
    """The loaded library and what its build reported."""

    def __init__(self):
        self.lib = None
        self.path = None
        self.build_seconds = 0.0
        self.ptxas_log = ""


_LIB = _Library()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of hot_tpu_torch cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load():
    """The ctypes library, built on first use."""
    if _LIB.lib is not None:
        return _LIB.lib
    path = BUILD_DIR / f"libhot_tpu_torch_{_digest()}.so"
    log_path = path.with_suffix(".log")
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = [str(s) for s in sorted(CSRC.glob("*.cu"))]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, *cu],
                              capture_output=True, text=True)
        _LIB.build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    _LIB.ptxas_log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB.lib, _LIB.path = lib, path
    return lib


def build_report() -> dict:
    """Seconds the build took in this process (0 if it was already built),
    the library path and nvcc's ptxas report (registers, spills)."""
    return {"seconds": _LIB.build_seconds, "path": str(_LIB.path),
            "ptxas": _LIB.ptxas_log}


def check_inputs(ref, specs):
    """Raise unless every (name, tensor, shape, dtype) of `specs` is a
    contiguous tensor of that shape and dtype on ref's device."""
    for name, t, shape, dtype in specs:
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, expected {ref.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def dtype_code(t) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA kernels take float32 or float64, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]
