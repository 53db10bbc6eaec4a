"""Time the scalar windowed-ELL and dense-window kernels of one checkout
of amgcl_tpu_torch at the shapes of their chip_smoke.py records, so that
two checkouts can be compared inside one run on one card.

    python3 kernel_ab.py TREE LABEL

imports ``amgcl_tpu_torch`` from the directory TREE (a checkout, or an
unpacked ``git archive`` of one), builds its kernels there, and prints
one line ``AB {json}``: the median device time in ms (chip_smoke.py's
``time_ms``: CUDA events, L2 flushed before each of 20 calls) of
``windowed_ell_spmv`` at U2's and U1's L0, ``windowed_ell_residual``,
``windowed_ell_scaled_correction`` and ``windowed_ell_spmv_dots`` (with
w) at U1's L0, and ``dense_window_spmv``, ``dense_window_residual`` and
``dense_window_scaled_correction`` at D2's L0, with ``torch.bmm`` over
the gathered x windows beside them. Run the two checkouts in turns (A,
B, B, A) in one command, each in its own process. Needs a CUDA card.
"""

import json
import sys
import time

import numpy as np
import torch

from chip_smoke import time_ms


def main(tree, label):
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    import amgcl_tpu_torch
    from amgcl_tpu_torch import fe_like_problem
    from amgcl_tpu_torch.ops import cuda_lib
    from amgcl_tpu_torch.ops import densewin_kernels as dwk
    from amgcl_tpu_torch.ops import well_kernels as wk
    from amgcl_tpu_torch.ops.densewin import csr_to_dense_window
    from amgcl_tpu_torch.ops.unstructured import csr_to_windowed_ell
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    if not amgcl_tpu_torch.__file__.startswith(tree):
        raise RuntimeError("imported %s, not the tree %s"
                           % (amgcl_tpu_torch.__file__, tree))
    t0 = time.perf_counter()
    cuda_lib.lib()
    out = {"tree": label, "build_s": round(time.perf_counter() - t0, 2)}
    rng = np.random.RandomState(7)
    A, _ = fe_like_problem()
    Ap = permute(A, cuthill_mckee(A))
    n = A.nrows

    def vec():
        return torch.as_tensor(rng.standard_normal(n)).float().cuda()
    for name, C in (("U2 L0", Ap), ("U1 L0", A)):
        M = csr_to_windowed_ell(C, torch.float32, device="cuda")
        g = (M.window_starts, M.cols_local, M.vals)
        x, f, w = vec(), vec(), vec()
        out[name + " spmv"] = time_ms(
            lambda: wk.windowed_ell_spmv(*g, x, n))
        if name == "U1 L0":
            out[name + " residual"] = time_ms(
                lambda: wk.windowed_ell_residual(*g, f, x, n))
            out[name + " correction"] = time_ms(
                lambda: wk.windowed_ell_scaled_correction(*g, w, f, x, n))
            out[name + " spmv_dots w"] = time_ms(
                lambda: wk.windowed_ell_spmv_dots(*g, x, w, n))
        del M, g
    D = csr_to_dense_window(Ap, torch.float32, device="cuda")
    st, B = D.window_starts, D.blocks
    win = B.shape[2]
    x, f, w = vec(), vec(), vec()
    xw = torch.cat([x, x.new_zeros(win)])[
        st.long()[:, None] + torch.arange(win, device="cuda")].unsqueeze(-1)
    out["D2 L0 bmm"] = time_ms(lambda: torch.bmm(B, xw))
    out["D2 L0 spmv"] = time_ms(lambda: dwk.dense_window_spmv(st, B, x, n))
    out["D2 L0 residual"] = time_ms(
        lambda: dwk.dense_window_residual(st, B, f, x, n))
    out["D2 L0 correction"] = time_ms(
        lambda: dwk.dense_window_scaled_correction(st, B, w, f, x, n))
    print("AB " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
