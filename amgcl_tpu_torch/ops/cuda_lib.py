"""Build and load the port's hand-written CUDA kernels.

The sources under ``amgcl_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use (each source compiles in its own
``nvcc`` process, all started together, then one link) into
``amgcl_tpu_torch/_build/``, keyed by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused. On a machine
with a card a failed build raises: there is no fallback to the plain
versions for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("dia.cu", "vec.cu", "vcycle.cu", "well_block.cu", "densewin.cu",
           "gather.cu")
HEADERS = ("reduce.cuh", "bf16.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels of amgcl_tpu_torch cannot be "
        "built on this machine")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        errors = []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            if proc.returncode:
                errors.append("%s:\n%s" % (src, out.decode(errors="replace")))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(so, target)     # atomic: concurrent builders agree


def _bind(lib) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(i32)
    lib.amgcl_dia.argtypes = [i32, i32, i64, i64, i32] + [vp] * 6 \
        + [i32, vp]
    lib.amgcl_dia.restype = i32
    lib.amgcl_dia_dots.argtypes = [i32, i32, i64, i64, i32, ip] \
        + [vp] * 8 + [i32, i32, i32, vp]
    lib.amgcl_dia_dots.restype = i32
    lib.amgcl_xr.argtypes = [i32, i64] + [vp] * 9 + [i32, vp]
    lib.amgcl_xr.restype = i32
    lib.amgcl_bicg_tail.argtypes = [i32, i64] + [vp] * 13 + [i32, vp]
    lib.amgcl_bicg_tail.restype = i32
    lib.amgcl_axpby_dot.argtypes = [i32, i64] + [vp] * 8 + [i32, vp]
    lib.amgcl_axpby_dot.restype = i32
    lib.amgcl_well_block.argtypes = [i32, i32, i32, i32, i64, i64, i32,
                                     i32] + [vp] * 9 + [i32, vp]
    lib.amgcl_well_block.restype = i32
    lib.amgcl_densewin.argtypes = [i32, i32, i64, i64, i32, i32, i32, i32] \
        + [vp] * 6 + [vp]
    lib.amgcl_densewin.restype = i32
    lib.amgcl_gather_spmv.argtypes = [i32, i32, i32, i64, i64, i32] \
        + [vp] * 5 + [i32, vp]
    lib.amgcl_gather_spmv.restype = i32
    lib.amgcl_fused_down.argtypes = [i32] * 9 + [ip, ip] + [i32] * 4 \
        + [ip] + [vp] * 8 + [vp]
    lib.amgcl_fused_down.restype = i32
    lib.amgcl_fused_up.argtypes = [i32] * 8 + [ip, ip, i32, i32, ip] \
        + [vp] * 9 + [vp]
    lib.amgcl_fused_up.restype = i32
    lib.amgcl_error_string.argtypes = [i32]
    lib.amgcl_error_string.restype = ctypes.c_char_p


def lib():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            target = BUILD_DIR / ("libamgcl_kernels_%s.so" % _digest())
            if not target.exists():
                _build(target)
            handle = ctypes.CDLL(str(target))
            _bind(handle)
            _lib = handle
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc:
        msg = lib().amgcl_error_string(rc).decode(errors="replace")
        raise RuntimeError("CUDA error %d (%s) launching %s" % (rc, msg, what))
