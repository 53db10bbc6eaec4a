"""The native set-up library: the host passes of the set-up in C++ with
OpenMP (counterpart of ``amgcl_tpu/native.py``).

``csrc/setup_kernels.cpp`` is compiled with ``g++ -O3 -fopenmp`` at first
use, never at import, into ``amgcl_tpu_torch/_build/`` under a name keyed
by a hash of the source and the flags, and loaded over ctypes. Where no
``g++`` is on ``PATH``, :func:`lib` returns None and every caller runs its
numpy pass, which gives the same results; where ``g++`` is there and the
build or the load fails, :func:`lib` raises with the compiler's message
rather than fall back quietly. :func:`available` says which of the two
holds.

Each wrapper returns None (False for :func:`native_dia_fnma_batch`)
where the JAX package's declines: no library, complex values, or a block
or dtype case its C functions do not take; the SpGEMM also where OpenMP
has fewer than two threads (scipy's product is faster on one), unless
``force_spgemm`` is set. ``calls`` counts each C function's calls, and
each call runs inside a ``native/<function>`` stage of the set-up
profile (``telemetry/tracing.setup_substage``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from amgcl_tpu_torch.telemetry.tracing import setup_substage

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "setup_kernels.cpp"
BUILD_DIR = _PKG / "_build"
#: the JAX package's flags (amgcl_tpu/native.py:35-36)
FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

#: calls of each C function since the process started (or the last
#: ``calls.clear()``)
calls = collections.Counter()
#: take the native SpGEMM on one OpenMP thread too (a seam for tests,
#: whose workers run with one thread)
force_spgemm = False
#: seconds the last build in this process took (None: none was built)
build_seconds = None

_lock = threading.Lock()
_lib = None


def compiler():
    """The ``g++`` on ``PATH``, or None."""
    return shutil.which("g++")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def _build(gxx: str, target: Path) -> None:
    global build_seconds
    import time
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then an atomic rename: parallel test workers that
    # build at once each finish their own file and agree on the result
    tmp = target.with_name("%s.tmp%d.%d" % (target.name, os.getpid(),
                                             threading.get_ident()))
    proc = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if proc.returncode:
        try:
            tmp.unlink()
        except FileNotFoundError:
            pass
        raise RuntimeError(
            "g++ failed (exit %d) building the native set-up library from "
            "%s:\n%s" % (proc.returncode, SOURCE,
                         (proc.stderr + proc.stdout).decode(
                             errors="replace")))
    os.replace(tmp, target)
    build_seconds = time.perf_counter() - t0


def _bind(h) -> None:
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    sig = {
        "aggregate_d2": (i64, [i64] + [vp] * 4),
        "strength_mask": (None, [i64, vp, vp, vp, ctypes.c_double, vp]),
        "symmetrize_mask": (None, [i64] + [vp] * 3),
        "omp_max_threads": (ctypes.c_int, []),
        "spgemm_symbolic": (None, [i64] + [vp] * 5),
        "spgemm_numeric": (None, [i64] + [vp] * 9),
        "spgemm_numeric_f32": (None, [i64] + [vp] * 9),
        "spgemm_numeric_block": (None, [i64] + [vp] * 9 + [i64] * 3),
        "spgemm_masked": (None, [i64] + [vp] * 9),
        "spai0_diag": (None, [i64] + [vp] * 4),
        "ell_pack": (None, [i64, vp, vp, vp, i64, i64, vp, vp]),
        "ell_pack_f32": (None, [i64, vp, vp, vp, i64, i64, vp, vp]),
        "filter_count": (None, [i64, vp, vp, vp, ctypes.c_double, vp]),
        "filter_count_f32": (None, [i64, vp, vp, vp, ctypes.c_double, vp]),
        "filter_fill": (None, [i64, vp, vp, vp, ctypes.c_double]
                        + [vp] * 4),
        "filter_fill_f32": (None, [i64, vp, vp, vp, ctypes.c_double]
                            + [vp] * 4),
        "iluk_symbolic": (i64, [i64, vp, vp, i64, i64, vp, vp]),
        "dia_mark": (None, [i64] + [vp] * 3),
        "dia_pack_f64_f32": (None, [i64] + [vp] * 5),
        "dia_pack_f64_f64": (None, [i64] + [vp] * 5),
        "dia_pack_f32_f32": (None, [i64] + [vp] * 5),
        "dia_fnma_batch_f64": (None, [i64, i64] + [vp] * 7),
        "dia_fnma_batch_f32": (None, [i64, i64] + [vp] * 7),
        "rs_cfsplit": (None, [i64] + [vp] * 6),
    }
    for name, (res, args) in sig.items():
        fn = getattr(h, name)
        fn.restype = res
        fn.argtypes = args


def lib():
    """The loaded library, built on first use; None where no ``g++`` is
    on ``PATH``. Raises where ``g++`` is there and the build or the load
    fails."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                gxx = compiler()
                if gxx is None:
                    _lib = False
                else:
                    target = BUILD_DIR / ("libamgcl_setup_%s.so"
                                          % _digest())
                    if not target.exists():
                        _build(gxx, target)
                    try:
                        handle = ctypes.CDLL(str(target))
                    except OSError as e:
                        raise RuntimeError(
                            "cannot load the native set-up library %s: %s"
                            % (target, e)) from e
                    _bind(handle)
                    _lib = handle
    return _lib or None


def available() -> bool:
    """True where the library is built and loaded, False where no
    ``g++`` exists (the numpy passes run)."""
    return lib() is not None


def omp_max_threads() -> int:
    """OpenMP's thread count for the library's next parallel region."""
    return int(lib().omp_max_threads())


def _call(name, *args):
    calls[name] += 1
    with setup_substage("native/" + name):
        return getattr(_lib, name)(*args)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _pattern(A):
    return (np.ascontiguousarray(A.ptr, dtype=np.int64),
            np.ascontiguousarray(A.col, dtype=np.int32))


def native_aggregates(A, eps_strong: float):
    """(agg, n_agg) of the greedy distance-2 pass over the symmetrized
    strength mask, or None (no library, block or complex values)."""
    if lib() is None or A.is_block or np.iscomplexobj(A.val):
        return None
    try:
        val = np.ascontiguousarray(A.val, dtype=np.float64)
    except (TypeError, ValueError):
        return None
    ptr, col = _pattern(A)
    n = A.nrows
    strong = np.empty(A.nnz, dtype=np.uint8)
    _call("strength_mask", n, _ptr(ptr), _ptr(col), _ptr(val),
          float(eps_strong), _ptr(strong))
    _call("symmetrize_mask", n, _ptr(ptr), _ptr(col), _ptr(strong))
    agg = np.empty(n, dtype=np.int64)
    n_agg = _call("aggregate_d2", n, _ptr(ptr), _ptr(col), _ptr(strong),
                  _ptr(agg))
    return agg, int(n_agg)


def native_spgemm(A, B):
    """C = A @ B by the two-pass hash SpGEMM: (ptr, col, val), val (nnz,)
    or (nnz, br, bc) with each row's columns sorted; or None where the
    JAX package declines (no library, fewer than two OpenMP threads,
    mixed block and scalar operands, complex values)."""
    if lib() is None or (omp_max_threads() < 2 and not force_spgemm):
        return None
    if A.is_block != B.is_block:
        return None
    if A.is_block and A.block_size[1] != B.block_size[0]:
        return None
    if A.ncols != B.nrows:
        raise ValueError("spgemm dimension mismatch: %s x %s"
                         % (A.shape, B.shape))
    if np.iscomplexobj(A.val) or np.iscomplexobj(B.val):
        return None
    f32 = (not A.is_block and A.val.dtype == np.float32
           and B.val.dtype == np.float32)
    vdt = np.float32 if f32 else np.float64
    try:
        aval = np.ascontiguousarray(A.val, dtype=vdt)
        bval = np.ascontiguousarray(B.val, dtype=vdt)
    except (TypeError, ValueError):
        return None
    aptr, acol = _pattern(A)
    bptr, bcol = _pattern(B)
    n = A.nrows
    rn = np.empty(n, dtype=np.int64)
    _call("spgemm_symbolic", n, _ptr(aptr), _ptr(acol), _ptr(bptr),
          _ptr(bcol), _ptr(rn))
    cptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(rn, out=cptr[1:])
    ccol = np.empty(cptr[-1], dtype=np.int32)
    if A.is_block:
        br, bk = A.block_size
        bc = B.block_size[1]
        cval = np.empty((cptr[-1], br, bc), dtype=np.float64)
        _call("spgemm_numeric_block", n, _ptr(aptr), _ptr(acol),
              _ptr(aval), _ptr(bptr), _ptr(bcol), _ptr(bval), _ptr(cptr),
              _ptr(ccol), _ptr(cval), br, bk, bc)
        return cptr, ccol, cval
    cval = np.empty(cptr[-1], dtype=vdt)
    _call("spgemm_numeric_f32" if f32 else "spgemm_numeric", n, _ptr(aptr),
          _ptr(acol), _ptr(aval), _ptr(bptr), _ptr(bcol), _ptr(bval),
          _ptr(cptr), _ptr(ccol), _ptr(cval))
    return cptr, ccol, cval


def native_spgemm_masked(n, aptr, acol, aval, bptr, bcol, bval, tptr,
                         tcol):
    """(A B)[i, tcol[q]] on the target pattern (tptr, tcol), float64,
    without the full product (the Chow–Patel sweep's product), or None
    without the library."""
    if lib() is None:
        return None
    aval = np.ascontiguousarray(aval, dtype=np.float64)
    bval = np.ascontiguousarray(bval, dtype=np.float64)
    aptr = np.ascontiguousarray(aptr, dtype=np.int64)
    acol = np.ascontiguousarray(acol, dtype=np.int32)
    bptr = np.ascontiguousarray(bptr, dtype=np.int64)
    bcol = np.ascontiguousarray(bcol, dtype=np.int32)
    tptr = np.ascontiguousarray(tptr, dtype=np.int64)
    tcol = np.ascontiguousarray(tcol, dtype=np.int32)
    tval = np.empty(len(tcol), dtype=np.float64)
    _call("spgemm_masked", int(n), _ptr(aptr), _ptr(acol), _ptr(aval),
          _ptr(bptr), _ptr(bcol), _ptr(bval), _ptr(tptr), _ptr(tcol),
          _ptr(tval))
    return tval


def native_filtered(A, eps_strong):
    """(ptr, col, val, dinv) of the strength-filtered matrix with its weak
    entries lumped onto the diagonal, in A's float64 or float32, or
    None."""
    if lib() is None or A.is_block or np.iscomplexobj(A.val):
        return None
    vdt = np.dtype(A.val.dtype)
    if vdt == np.float64:
        count_fn, fill_fn = "filter_count", "filter_fill"
    elif vdt == np.float32:
        count_fn, fill_fn = "filter_count_f32", "filter_fill_f32"
    else:
        return None
    val = np.ascontiguousarray(A.val)
    ptr, col = _pattern(A)
    n = A.nrows
    rn = np.empty(n, dtype=np.int64)
    _call(count_fn, n, _ptr(ptr), _ptr(col), _ptr(val), float(eps_strong),
          _ptr(rn))
    optr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(rn, out=optr[1:])
    ocol = np.empty(optr[-1], dtype=np.int32)
    oval = np.empty(optr[-1], dtype=vdt)
    dinv = np.empty(n, dtype=vdt)
    _call(fill_fn, n, _ptr(ptr), _ptr(col), _ptr(val), float(eps_strong),
          _ptr(optr), _ptr(ocol), _ptr(oval), _ptr(dinv))
    return optr, ocol, oval, dinv


def native_ell_pack(A, K: int, out_dtype):
    """(cols, vals) ELL planes of A with K slots a row, the cast to
    ``out_dtype`` (float32 or float64) fused in; vals is (n, K) or
    (n, K, br, bc). None for other dtypes and complex values."""
    if lib() is None or np.iscomplexobj(A.val):
        return None
    odt = np.dtype(out_dtype)
    if odt == np.float32:
        fn = "ell_pack_f32"
    elif odt == np.float64:
        fn = "ell_pack"
    else:
        return None
    try:
        val = np.ascontiguousarray(A.val, dtype=np.float64)
    except (TypeError, ValueError):
        return None
    ptr, col = _pattern(A)
    n = A.nrows
    br, bc = A.block_size
    bs = br * bc
    cols = np.zeros((n, K), dtype=np.int32)
    vals = np.zeros((n, K) if bs == 1 else (n, K, br, bc), dtype=odt)
    _call(fn, n, _ptr(ptr), _ptr(col), _ptr(val), K, bs, _ptr(cols),
          _ptr(vals))
    return cols, vals


def native_spai0_diag(A):
    """SPAI-0's m_i = a_ii / Σ_j a_ij² in float64, or None (block or
    complex values)."""
    if lib() is None or A.is_block or np.iscomplexobj(A.val):
        return None
    try:
        val = np.ascontiguousarray(A.val, dtype=np.float64)
    except (TypeError, ValueError):
        return None
    ptr, col = _pattern(A)
    m = np.empty(A.nrows, dtype=np.float64)
    _call("spai0_diag", A.nrows, _ptr(ptr), _ptr(col), _ptr(val), _ptr(m))
    return m


def native_iluk_pattern(A, k: int):
    """(ptr, col) of the level-of-fill ILU(k) pattern of A's sorted
    pattern, rows sorted; None for block values or without the
    library."""
    if lib() is None or A.is_block:
        return None
    ptr, col = _pattern(A)
    n = A.nrows
    budget = max(A.nnz * (k + 2), 64)
    for _ in range(8):
        optr = np.zeros(n + 1, dtype=np.int64)
        ocol = np.empty(budget, dtype=np.int32)
        got = _call("iluk_symbolic", n, _ptr(ptr), _ptr(col), int(k),
                    budget, _ptr(optr), _ptr(ocol))
        if got >= 0:
            return optr, ocol[:got]
        budget *= 2
    raise MemoryError("iluk pattern did not fit after retries")


def native_dia_offsets(A):
    """The distinct diagonal offsets of a scalar CSR, sorted, or None."""
    if lib() is None or A.is_block:
        return None
    ptr, col = _pattern(A)
    base = A.nrows - 1
    hits = np.zeros(base + A.ncols, dtype=np.uint8)
    _call("dia_mark", A.nrows, _ptr(ptr), _ptr(col), _ptr(hits))
    return np.flatnonzero(hits) - base


def native_dia_pack(A, offsets, out_dtype):
    """The (ndiag, nrows) diagonal-major values of a scalar CSR along
    ``offsets``, the cast to ``out_dtype`` fused into the scatter; None
    for a pair of dtypes other than float64 → float32 or float64 and
    float32 → float32."""
    out_dtype = np.dtype(out_dtype)
    if lib() is None or A.is_block:
        return None
    fn = {(np.dtype(np.float64), np.dtype(np.float32)): "dia_pack_f64_f32",
          (np.dtype(np.float64), np.dtype(np.float64)): "dia_pack_f64_f64",
          (np.dtype(np.float32), np.dtype(np.float32)): "dia_pack_f32_f32",
          }.get((np.dtype(A.val.dtype), out_dtype))
    if fn is None:
        return None
    ptr, col = _pattern(A)
    val = np.ascontiguousarray(A.val)
    base = A.nrows - 1
    slot = np.zeros(base + A.ncols, dtype=np.int32)
    slot[np.asarray(offsets) + base] = np.arange(len(offsets),
                                                 dtype=np.int32)
    out = np.zeros((len(offsets), A.nrows), dtype=out_dtype)
    _call(fn, A.nrows, _ptr(ptr), _ptr(col), _ptr(val), _ptr(slot),
          _ptr(out))
    return out


def native_dia_fnma_batch(abase, a_idx, bbase, b_idx, shifts, obase,
                          out_idx):
    """``obase[out_idx[p]] -= abase[a_idx[p]] * shift(bbase[b_idx[p]],
    shifts[p])`` for every pair p in one call; pairs that share an
    output row must be contiguous (the rows are split among the
    threads). False where the library or the dtype is missing, or an
    operand is not contiguous."""
    if lib() is None:
        return False
    dt = np.dtype(obase.dtype)
    if abase.dtype != dt or bbase.dtype != dt:
        return False
    if dt == np.float64:
        fn = "dia_fnma_batch_f64"
    elif dt == np.float32:
        fn = "dia_fnma_batch_f32"
    else:
        return False
    for a in (abase, bbase, obase):
        if not a.flags.c_contiguous:
            return False
    n = obase.shape[1]
    a_idx = np.ascontiguousarray(a_idx, dtype=np.int64)
    b_idx = np.ascontiguousarray(b_idx, dtype=np.int64)
    shifts = np.ascontiguousarray(shifts, dtype=np.int64)
    out_idx = np.ascontiguousarray(out_idx, dtype=np.int64)
    # two threads on one output row would race: refuse interleaved rows
    if len(out_idx) and np.count_nonzero(np.diff(out_idx)) \
            != len(np.unique(out_idx)) - 1:
        raise ValueError(
            "native_dia_fnma_batch requires pairs sharing an output row "
            "to be contiguous in out_idx")
    _call(fn, n, len(a_idx), _ptr(abase), _ptr(a_idx), _ptr(bbase),
          _ptr(b_idx), _ptr(shifts), _ptr(obase), _ptr(out_idx))
    return True


def native_rs_cfsplit(ptr, col, strong, stp, stc, cf):
    """The classic Ruge–Stüben C/F split (0 undecided, 1 C, 2 F; rows with
    no strong connection arrive as 2) on a copy of ``cf``, or None."""
    if lib() is None:
        return None
    n = len(ptr) - 1
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int32)
    strong = np.ascontiguousarray(strong, dtype=np.uint8)
    stp = np.ascontiguousarray(stp, dtype=np.int64)
    stc = np.ascontiguousarray(stc, dtype=np.int32)
    out = np.ascontiguousarray(cf, dtype=np.int8).copy()
    _call("rs_cfsplit", n, _ptr(ptr), _ptr(col), _ptr(strong), _ptr(stp),
          _ptr(stc), _ptr(out))
    return out
