"""Chip smoke test of amgcl_tpu_torch on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the hand-written
   kernels (``amgcl_tpu_torch/csrc/*.cu``) from the checkout.
2. Drives the main path once through the package's entry points:
   ``poisson3d(128)`` → ``make_solver(A, AMGParams(dtype=float32),
   CG(maxiter=100, tol=1e-6), refine=3)``, then solves twice. Every
   kernel's launch count is set to 0 just before and read just after; the
   run fails unless the hierarchy has 4 levels of 2,097,152 / 262,144 /
   32,768 / 1,331 rows, CG takes 12 ± 1 iterations, the true residual
   (host float64) is ≤ 1e-6, every kernel on the path launched and no
   plain version ran.
3. Holds each kernel against its plain PyTorch version on the main path's
   own operators (random vectors from a seeded numpy generator), and times
   kernel, plain version and, where one PyTorch call computes the same
   function, that call (CUDA events, median of 20 after warm-up, L2 flushed
   before each launch), beside the least time the card could take.

Prints one JSON line of kernel records, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, when
no CUDA device is present or any phase fails.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and non-tensor-core
#: float32 / float64 operations per second
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}

LEVEL_ROWS = [2097152, 262144, 32768, 1331]
ITERS_EXPECTED = 12

SOURCES = {"dia": "amgcl_tpu_torch/csrc/dia.cu",
           "vec": "amgcl_tpu_torch/csrc/vec.cu"}
REPLACES = {
    "dia_spmv": "amgcl_tpu/ops/pallas_spmv.py:318",
    "dia_residual": "amgcl_tpu/ops/pallas_spmv.py:389",
    "dia_scaled_correction": "amgcl_tpu/ops/pallas_spmv.py:389",
    "dia_spmv_dots": "amgcl_tpu/ops/pallas_spmv.py:461",
    "dia_residual_dot": "amgcl_tpu/ops/pallas_spmv.py:552",
    "xr_update": "amgcl_tpu/ops/fused_vec.py:251",
}
ON_PATH = ("dia_residual", "dia_scaled_correction", "dia_spmv_dots",
           "dia_residual_dot", "xr_update")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def wrappers():
    from amgcl_tpu_torch.ops import dia_kernels as dk
    from amgcl_tpu_torch.ops import fused_vec as fv
    return {"dia_spmv": (dk.dia_spmv, dk.dia_spmv_plain),
            "dia_residual": (dk.dia_residual, dk.dia_residual_plain),
            "dia_scaled_correction": (dk.dia_scaled_correction,
                                      dk.dia_scaled_correction_plain),
            "dia_spmv_dots": (dk.dia_spmv_dots, dk.dia_spmv_dots_plain),
            "dia_residual_dot": (dk.dia_residual_dot,
                                 dk.dia_residual_dot_plain),
            "xr_update": (fv.xr_update, fv.xr_update_plain)}


def reset_counts():
    for kern, plain in wrappers().values():
        kern.launches = 0
        plain.calls = 0


def read_counts():
    return ({k: kern.launches for k, (kern, _) in wrappers().items()},
            {k: plain.calls for k, (_, plain) in wrappers().items()})


# -- phase 2: the main path -------------------------------------------------

def main_path(failures):
    from amgcl_tpu_torch import AMGParams, CG, make_solver, poisson3d
    t0 = time.perf_counter()
    A, rhs = poisson3d(128)
    t_problem = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    solve = make_solver(A, AMGParams(dtype=torch.float32),
                        CG(maxiter=100, tol=1e-6), refine=3)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    print("problem: poisson3d(128), %d rows, %d nnz, built in %.3f s"
          % (A.nrows, A.nnz, t_problem))
    print("setup: %.3f s wall (make_solver), %.3f s in AMG._build"
          % (t_setup, solve.precond.setup_seconds))
    print(solve.precond)
    x, info = solve(rhs)
    print("solve 1 (cold): %d iterations, reported resid %.3e, %.4f s"
          % (info.iters, info.resid, info.wall_time_s))
    first, _ = read_counts()
    x, info = solve(rhs)
    counts, plain_calls = read_counts()
    print("solve 2 (warm): %d iterations, reported resid %.3e, %.4f s"
          % (info.iters, info.resid, info.wall_time_s))
    x64 = x.double().cpu().numpy()
    true_res = float(np.linalg.norm(rhs - A.spmv(x64))
                     / np.linalg.norm(rhs))
    print("true relative residual (host float64): %.3e" % true_res)
    warm = {k: counts[k] - first[k] for k in counts}
    print("launches over the main path (setup + 2 solves): %s"
          % json.dumps(counts))
    print("launches in the warm solve: %s; per CG iteration: %s"
          % (json.dumps(warm), json.dumps(
              {k: round(v / max(info.iters, 1), 3)
               for k, v in warm.items()})))
    print("plain-version calls over the main path: %s"
          % json.dumps(plain_calls))
    profile_solve(solve, rhs, info.wall_time_s * 1e3)
    rows = [h[0].nrows for h in solve.precond.host_levels]
    if rows != LEVEL_ROWS:
        failures.append("levels %s, expected %s" % (rows, LEVEL_ROWS))
    if abs(info.iters - ITERS_EXPECTED) > 1:
        failures.append("%d iterations, expected %d ± 1"
                        % (info.iters, ITERS_EXPECTED))
    if not (np.all(np.isfinite(x64)) and true_res <= 1e-6):
        failures.append("true residual %.3e > 1e-6" % true_res)
    for k in ON_PATH:
        if counts[k] == 0:
            failures.append("kernel %s never launched on the main path" % k)
    if any(plain_calls.values()):
        failures.append("plain versions ran on the main path: %s"
                        % plain_calls)
    return solve, counts, {
        "setup_s": t_setup, "warm_solve_s": info.wall_time_s,
        "iters": info.iters, "resid": info.resid, "true_resid": true_res,
        "warm_launches": warm}


def profile_solve(solve, rhs, warm_ms):
    """One more warm solve under torch.profiler: device time by kernel and
    the device's busy share of that solve's wall time (profiler overhead
    included in the wall). Its busy time over the unprofiled warm solve's
    wall (``warm_ms``) is printed as an estimate that combines two
    solves."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(rhs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print("profiled warm solve: no device time recorded "
              "(device busy share not measured)")
        return
    busy = sum(r[0] for r in rows)
    print("profiled warm solve: wall %.3f ms, device busy %.3f ms (%.1f%%"
          " of the same solve's wall)" % (wall_ms, busy, 100 * busy / wall_ms))
    print("estimate over two solves: profiled busy / unprofiled warm wall "
          "%.3f ms = %.1f%%" % (warm_ms, 100 * busy / warm_ms))
    for ms, count, key in rows[:12]:
        print("  %9.3f ms %5d x  %s" % (ms, count, key[:90]))


# -- phase 3: kernel against plain version, timings -------------------------

_FLUSH = None


def time_ms(fn, reps=20, warmup=3):
    """Median device time of one call: CUDA events around each call, with
    a 512 MiB write before it that evicts the 50 MB L2 and keeps the
    device busy while the host enqueues the call."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        _FLUSH.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def live_entries(M):
    """Stored DIA entries whose column lies inside the operator: the
    multiply-adds a product needs."""
    n, m = M.shape
    return sum(max(0, min(n, m - d) - max(0, -d)) for d in M.offsets)


def bound(nbytes, ops, dtype):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def library_csr(M):
    """The DIA operator as a CUDA sparse CSR tensor (the library
    yardstick; the port never calls it)."""
    n, m = M.shape
    data = M.data.double().cpu().numpy()
    rows, cols, vals = [], [], []
    for k, d in enumerate(M.offsets):
        i = np.arange(max(0, -d), min(n, m - d))
        v = data[k, i]
        keep = v != 0
        rows.append(i[keep])
        cols.append(i[keep] + d)
        vals.append(v[keep])
    C = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(n, m))
    C.sort_indices()
    return torch.sparse_csr_tensor(
        torch.as_tensor(C.indptr, dtype=torch.int64),
        torch.as_tensor(C.indices, dtype=torch.int64),
        torch.as_tensor(C.data).to(M.data.dtype), size=(n, m)).to("cuda")


def check_kernels(solve, failures):
    from amgcl_tpu_torch.ops import device as dev
    hier = solve.precond.hierarchy
    L = hier.levels
    rng = np.random.RandomState(20261016)

    def vec(n, dtype):
        return torch.as_tensor(rng.standard_normal(n)).to(
            device="cuda", dtype=dtype)

    def absprod(M, x):
        """|A| |x|, entry by entry: the size of the product's terms."""
        return dev.DiaMatrix(M.offsets, M.data.abs(), M.shape).mv(x.abs())

    W = wrappers()
    cases = [
        # (kernel, label, operator)
        ("dia_spmv", "L0 A", L[0].A), ("dia_spmv", "L1 A", L[1].A),
        ("dia_residual", "L0 A", L[0].A), ("dia_residual", "L1 A", L[1].A),
        ("dia_residual", "L2 A", L[2].A),
        ("dia_residual", "L0 M", L[0].P.M),
        ("dia_residual", "L0 Mt", L[0].R.Mt),
        ("dia_residual", "L1 Mt", L[1].R.Mt),
        ("dia_residual", "L0 A f64", solve.A_dev64),
        ("dia_scaled_correction", "L0 A", L[0].A),
        ("dia_scaled_correction", "L1 A", L[1].A),
        ("dia_spmv_dots", "L0 A", L[0].A),
        ("dia_residual_dot", "L0 A", L[0].A),
        ("xr_update", "L0 n", L[0].A),
    ]
    records = {}
    # the correction's weights are the level's own SPAI-0 scale
    weights = {"L0 A": L[0].relax.scale, "L1 A": L[1].relax.scale}
    for name, label, M in cases:
        kern, plain = W[name]
        dt = M.dtype
        n, m = M.shape
        s = M.data.element_size()
        x, f = vec(m, dt), vec(n, dt)
        off = M.offsets_t
        live = live_entries(M)
        ax = absprod(M, x)
        # |Δ| ≤ rtol · (the largest sum of |terms| of one output entry)
        scale = float((ax + f.abs()).max())
        rtol = 1e-5 if dt == torch.float32 else 1e-12
        dots = []
        lib = None
        if name == "dia_spmv":
            args = (off, M.data, x)
            nbytes, ops = (M.data.numel() + m + n) * s, 2 * live
            scale = float(ax.max())
            C = library_csr(M)
            lib = lambda: torch.mv(C, x)
        elif name == "dia_residual":
            args = (off, M.data, f, x)
            nbytes, ops = (M.data.numel() + m + 2 * n) * s, 2 * live
            C = library_csr(M)
            lib = lambda: torch.addmv(f, C, x, alpha=-1.0)
        elif name == "dia_scaled_correction":
            w = weights[label]
            args = (off, M.data, w, f, x)
            nbytes, ops = (M.data.numel() + m + 3 * n) * s, 2 * live + 2 * n
            scale = float((w.abs() * (ax + f.abs()) + x.abs()).max())
        elif name == "dia_spmv_dots":
            args = (off, M.data, x)
            nbytes, ops = (M.data.numel() + m + n) * s, 2 * live + 4 * n
            scale = float(ax.max())
            dots = [1, 2]
        elif name == "dia_residual_dot":
            args = (off, M.data, f, x)
            nbytes, ops = (M.data.numel() + m + 2 * n) * s, 2 * live + 2 * n
            dots = [1]
        else:                                       # xr_update
            p, q = vec(n, dt), vec(n, dt)
            alpha = torch.tensor(0.37, dtype=dt, device="cuda")
            args = (alpha, p, q, x, f)
            nbytes, ops = 6 * n * s, 6 * n
            scale = float(x.abs().max() + f.abs().max()
                          + 0.37 * (p.abs().max() + q.abs().max()))
            dots = [2]
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((g - p_).abs().max())
                  for g, p_ in zip(got, want)
                  if g is not None and g.dim() == 1)
        ok = err <= rtol * scale
        dot_err = 0.0
        for j in dots:
            # summation order differs: |Δ| ≤ rtol · Σ|terms|
            g, p_ = float(got[j]), float(want[j])
            terms = {("dia_spmv_dots", 1): (want[0], want[0]),
                     ("dia_spmv_dots", 2): (want[0], x),
                     ("dia_residual_dot", 1): (want[0], want[0]),
                     ("xr_update", 2): (want[1], want[1])}[(name, j)]
            mag = float((terms[0].double() * terms[1].double()).abs().sum())
            dot_err = max(dot_err, abs(g - p_) / mag)
            ok = ok and abs(g - p_) <= rtol * mag
        ms = time_ms(lambda: kern(*args))
        plain_ms = time_ms(lambda: plain(*args))
        lib_ms = None
        if lib is not None:
            try:
                lib_ms = time_ms(lib)
            except RuntimeError as e:      # a yardstick, not the port
                print("library call for %s unavailable: %s"
                      % (name, str(e).splitlines()[0]))
        b_ms, b_by = bound(nbytes, ops, dt)
        print("%-22s %-9s n=%-8d ndiag=%-4d %s  err %.3e (tol %.3e)  "
              "dot rel err %.2e  ms %.4f  plain %.4f  library %s  "
              "bound %.4f (%s)  %s"
              % (name, label, n, len(M.offsets), str(dt).split(".")[-1],
                 err, rtol * scale, dot_err, ms, plain_ms,
                 "%.4f" % lib_ms if lib_ms is not None else "none",
                 b_ms, b_by, "ok" if ok else "FAIL"))
        if not ok:
            failures.append("%s %s disagrees with its plain version"
                            % (name, label))
        if name not in records:      # the first case is the L0 shape
            records[name] = {"max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": lib_ms,
                             "shape": ("n=%d, %s" % (n, dt)
                                       if name == "xr_update" else
                                       "%s %dx%d, %d diagonals, %s"
                                       % (label, n, m, len(M.offsets),
                                          dt))}
    return records


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    print(card_line())
    print("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    from amgcl_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.lib()
    print("kernel build: %.2f s (nvcc, %s)"
          % (time.perf_counter() - t0, " + ".join(cuda_lib.SOURCES)))
    failures = []
    solve, counts, summary = main_path(failures)
    records = check_kernels(solve, failures)
    print("main path: %s" % json.dumps(summary))
    kernels = []
    for name in REPLACES:
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES["vec" if name == "xr_update" else "dia"],
            "replaces": REPLACES[name], "launches": counts[name],
            **rec})
    if failures:
        for f in failures:
            print("FAIL: %s" % f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
