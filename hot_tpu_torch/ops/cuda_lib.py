"""Build and load the package's CUDA kernels (``hot_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all at once) and links them into one shared library with a plain C
interface, loaded with ``ctypes``. The build happens at first
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_RES = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # (dtype, dim, width, w, x, dx, res, lookup, tile, F, U, V, A, bp, bm, V0,
    #  dt, df, n, nodes, batch, threads, window_nodes, stats, stream)
    "hot_fused_apply": [ctypes.c_int] * 3 + [_P, _P, ctypes.c_double, _RES, _P, ctypes.c_int]
                       + [_P] * 7
                       + [ctypes.c_double, _P, ctypes.c_longlong, ctypes.c_longlong]
                       + [ctypes.c_int] * 3 + [_P, _P],
    # (model, dtype, dim, width, v, x, dx, res, lookup, tile, F, mu, lam, V0,
    #  dt, project, f, U, V, A, bp, bm, n, nodes, batch, threads, window_nodes,
    #  stats, stream)
    "hot_fused_linearize": [ctypes.c_int] * 4 + [_P, _P, ctypes.c_double, _RES, _P,
                                                 ctypes.c_int] + [_P] * 4
                           + [ctypes.c_double, ctypes.c_int] + [_P] * 6
                           + [ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 3
                           + [_P, _P],
    # (dtype, dim, vals, col_row, x, y, n_rows, K, stream)
    "hot_bsr_spmv": [ctypes.c_int, ctypes.c_int] + [_P] * 4
                    + [ctypes.c_longlong, ctypes.c_int, _P],
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


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path, stem: str):
    """Build every ``*.cu`` of `csrc` into ``BUILD_DIR/<stem>_<hash>.so``
    unless that library exists: one nvcc per source, all started together,
    then one link. Returns (path, seconds of the build, nvcc's log)."""
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    path = BUILD_DIR / f"{stem}_{_digest(sources)}.so"
    log_path = path.with_suffix(".log")
    seconds = 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            procs = [(cu, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", f"{tmp}/{cu.stem}.o", str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
                for cu in sources if cu.suffix == ".cu"]
            logs = [(cu, proc.communicate()[0], proc.returncode) for cu, proc in procs]
            failed = [f"{cu.name} ({rc}):\n{log}" for cu, log, rc in logs if rc != 0]
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            link = subprocess.run([nvcc, "-shared", "-o", f"{tmp}/lib.so",
                                   *(f"{tmp}/{cu.stem}.o" for cu, _, _ in logs)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
            log_path.write_text("".join(log for _, log, _ in logs))
            os.replace(f"{tmp}/lib.so", path)
        seconds = time.perf_counter() - t0
    return path, seconds, log_path.read_text() if log_path.exists() else ""


def load():
    """The ctypes library, built on first use."""
    if _LIB.lib is not None:
        return _LIB.lib
    path, _LIB.build_seconds, _LIB.ptxas_log = build(CSRC, "libhot_tpu_torch")
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


def int_array(values):
    """A ctypes int array (a grid's res) for an ``int*`` argument."""
    return (ctypes.c_int * len(values))(*(int(v) for v in values))


_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def dtype_code(t) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA kernels take float32 or float64, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]
