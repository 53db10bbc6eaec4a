"""Structure analytics, format-candidate costing and the executed
reorder (counterpart of the reorder half of
``amgcl_tpu/telemetry/structure.py``).

* :func:`fingerprint` — a blake2b digest of a sparsity pattern (shape,
  block size, ``ptr`` and ``col`` bytes), byte-identical to the JAX
  package's.
* :func:`structure_metrics` — bandwidth profile, diagonal occupancy, ELL
  row-length spread and window fill of one host CSR.
* :func:`candidate_table` — predicted bytes and operations of one SpMV
  in each device format the matrix could take, priced from the host CSR
  alone (nothing is converted), each with its eligibility.
  ``ops/device.to_device('auto')`` tries its formats in this table's
  order (:func:`~amgcl_tpu_torch.ops.device.ranked_formats`).
* :func:`advise` — the reorder advisor: a reverse Cuthill–McKee
  permutation and its reversal, each priced by the same table, and the
  predicted byte gain over the identity order.
* :func:`reorder_plan` — the advisor's verdict turned into a plan that
  ``AMG`` executes: ``perm``/``iperm``, ``val_perm`` (values of the
  original order into the permuted frame), ``variant``, ``fingerprint``
  and ``predicted_gain``, cached by fingerprint.

Host numpy and scipy only. The window constants are those of
``ops/unstructured.py`` (``_TILE``, ``_WIN_ALIGN``), ``ops/densewin.py``
(its 64-row tile) and ``ops/device.py`` (``_ELL_PAD``).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

_TILE = 1024
_WIN_ALIGN = 1024
_DWIN_TILE = 64
_ELL_PAD = 4
_DWIN_MAX_BYTES = 6 << 30

#: density-curve granules (rows, columns): an element, the JAX package's
#: (8, 128) register tile and a (64, 1024) super-tile
DENSITY_GRANULES: Tuple[Tuple[int, int], ...] = ((1, 1), (8, 128),
                                                 (64, 1024))

#: the formats the table prices; "ell" is the unconditional last resort
CANDIDATE_FORMATS = ("dense", "dia", "dwin", "well", "ell")

#: predicted gain below which the advisor does not reorder
GAIN_FLOOR = 1.15

#: the advisor's permutation variants: scipy's reverse Cuthill–McKee and
#: its reversal
ADVISOR_VARIANTS = ("rcm", "cm")

#: the executed reorder leaves larger patterns alone (an RCM and a
#: symmetric permutation are O(nnz log nnz) host work)
MAX_ADVISE_NNZ = 3_000_000

#: the stencil pre-filter: a pattern of at most this many diagonals...
PREFILTER_DIAGS = 16
#: ...stored at most this many times its nonzeros is left as it is
PREFILTER_FILL = 1.5


def fingerprint(A) -> str:
    """Hex digest of the sparsity pattern (values excluded), cached on
    the matrix as ``_sparsity_fp``."""
    cached = getattr(A, "_sparsity_fp", None)
    if cached is not None:
        return cached
    h = hashlib.blake2b(digest_size=16)
    br, bc = getattr(A, "block_size", (1, 1))
    h.update(np.asarray([A.nrows, A.ncols, A.nnz, br, bc],
                        np.int64).tobytes())
    h.update(np.ascontiguousarray(A.ptr).tobytes())
    h.update(np.ascontiguousarray(A.col).tobytes())
    fp = h.hexdigest()
    A._sparsity_fp = fp
    return fp


def _row_min_max(A):
    """Per-row min and max column of a sorted CSR (m and −1 on empty
    rows)."""
    n, m = A.shape
    row_min = np.full(n, m, dtype=np.int64)
    row_max = np.full(n, -1, dtype=np.int64)
    nz = np.flatnonzero(np.diff(A.ptr))
    if len(nz):
        row_min[nz] = A.col[A.ptr[nz]]
        row_max[nz] = A.col[A.ptr[nz + 1] - 1]
    return row_min, row_max


def tile_windows_host(A, tile: int = _TILE):
    """(n_tiles, rows, tiles, starts, win): the aligned per-tile column
    windows of ``ops/unstructured.tile_windows`` from the rows' first and
    last columns."""
    n, m = A.shape
    n_tiles = -(-n // tile)
    rows = A.expanded_rows()
    tiles = rows // tile
    row_min, row_max = _row_min_max(A)
    pad = n_tiles * tile - n
    grid_min = np.pad(row_min, (0, pad), constant_values=m) \
        .reshape(n_tiles, tile)
    grid_max = np.pad(row_max, (0, pad), constant_values=-1) \
        .reshape(n_tiles, tile)
    starts = grid_min.min(axis=1)
    ends = grid_max.max(axis=1) + 1
    empty = ends <= starts
    starts[empty] = m
    ends[empty] = m + 1
    starts = (starts // _WIN_ALIGN) * _WIN_ALIGN
    span = ends - starts
    win = int(span.max()) if n_tiles else 1
    win = -(-win // _WIN_ALIGN) * _WIN_ALIGN
    return n_tiles, rows, tiles, starts, win


def fast_facts(A, tile: int = _TILE, itemsize: int = 4) -> Dict[str, Any]:
    """The facts the candidate table prices from (diagonal census,
    row lengths, window spans), cached on the matrix as
    ``_xray_facts``."""
    cached = getattr(A, "_xray_facts", None)
    if cached is not None and cached.get("itemsize") == itemsize \
            and cached.get("tile") == tile:
        return cached
    n, m = A.shape
    facts: Dict[str, Any] = {"itemsize": itemsize, "tile": tile,
                             "rows": int(n), "cols": int(m),
                             "nnz": int(A.nnz)}
    if n == 0 or A.nnz == 0:
        facts.update({"ndiags": 0, "dia_fill": 0.0, "k": 0,
                      "k_padded": _ELL_PAD, "tiles": 0, "win": 1,
                      "win_bytes": 0, "dwin_tiles": 0, "dwin_win": 1,
                      "dwin_bytes": 0})
        return facts
    off = getattr(A, "_dia_offsets_cache", None)
    if off is None:
        d = A.col.astype(np.int64) - A.expanded_rows()
        base = n - 1
        hits = np.bincount(d + base, minlength=base + m)
        off = np.flatnonzero(hits) - base
        facts["_occ_off"] = off
        facts["_occ_cnt"] = hits[off + base]
        A._dia_offsets_cache = off
    facts["ndiags"] = int(len(off))
    facts["dia_fill"] = round(len(off) * n / max(A.nnz, 1), 4)
    k_raw = int(np.diff(A.ptr).max())
    facts["k"] = k_raw
    facts["k_padded"] = max(_ELL_PAD, -(-k_raw // _ELL_PAD) * _ELL_PAD)
    n_tiles, _, _, _, win = tile_windows_host(A, tile)
    facts["tiles"] = int(n_tiles)
    facts["win"] = int(win)
    facts["win_bytes"] = int(n_tiles * tile * win * itemsize)
    dw_tiles, _, _, _, dw_win = tile_windows_host(A, _DWIN_TILE)
    facts["dwin_tiles"] = int(dw_tiles)
    facts["dwin_win"] = int(dw_win)
    facts["dwin_bytes"] = int(dw_tiles * _DWIN_TILE * dw_win * itemsize)
    A._xray_facts = facts
    return facts


def _distinct(a: np.ndarray) -> int:
    """The number of distinct values in ``a``, through a sort (numpy's
    hash-based ``unique`` is several times slower on large arrays)."""
    if not len(a):
        return 0
    s = np.sort(a)
    return 1 + int(np.count_nonzero(s[1:] != s[:-1]))


def _percentile(vals: np.ndarray, p: float) -> float:
    return float(np.percentile(vals, p)) if len(vals) else 0.0


def structure_metrics(A, tile: int = _TILE, itemsize: int = 4,
                      granules: Sequence[Tuple[int, int]] =
                      DENSITY_GRANULES) -> Dict[str, Any]:
    """Structural analytics of one host CSR (block units for a BCSR):
    bandwidth profile and envelope, diagonal occupancy, ELL row lengths
    and padding, window span, fill and density curve."""
    n, m = A.shape
    nnz = A.nnz
    br, bc = getattr(A, "block_size", (1, 1))
    out: Dict[str, Any] = {
        "rows": int(n), "cols": int(m), "nnz": int(nnz),
        "block": [int(br), int(bc)], "fingerprint": fingerprint(A)}
    if n == 0 or nnz == 0:
        out.update({
            "empty": True,
            "bandwidth": {"max": 0, "mean": 0.0, "p90": 0,
                          "envelope": 0},
            "diagonals": {"ndiags": 0, "fill": 0.0,
                          "occupancy_top": [], "occupancy_p50": 0},
            "ell": {"k": 0, "k_padded": _ELL_PAD,
                    "row_nnz": {"min": 0, "mean": 0.0, "p50": 0,
                                "max": 0},
                    "pad_frac": 0.0, "lane_pad_frac": 0.0},
            "window": {"tiles": 0, "tile": int(tile), "win": 1,
                       "fill": 0.0, "bytes": 0, "density_curve": []},
        })
        return out
    facts = fast_facts(A, tile=tile, itemsize=itemsize)
    rows = A.expanded_rows()
    col = A.col.astype(np.int64)
    d = col - rows

    row_min, row_max = _row_min_max(A)
    has = row_max >= 0
    half_bw = np.zeros(n, dtype=np.int64)
    span = np.zeros(n, dtype=np.int64)
    ridx = np.arange(n, dtype=np.int64)
    half_bw[has] = np.maximum(np.abs(row_max[has] - ridx[has]),
                              np.abs(ridx[has] - row_min[has]))
    span[has] = row_max[has] - row_min[has] + 1
    out["bandwidth"] = {
        "max": int(half_bw.max()),
        "mean": round(float(half_bw.mean()), 2),
        "p90": int(_percentile(half_bw, 90)),
        "envelope": int(span.sum()),
    }

    occ_off = facts.get("_occ_off")
    occ_cnt = facts.get("_occ_cnt")
    if occ_cnt is None:
        base = n - 1
        hits = np.bincount(d + base, minlength=base + m)
        occ_off = np.flatnonzero(hits) - base
        occ_cnt = hits[occ_off + base]
    order = np.argsort(-occ_cnt, kind="stable")[:8]
    out["diagonals"] = {
        "ndiags": facts["ndiags"],
        "fill": facts["dia_fill"],
        "occupancy_top": [[int(occ_off[k]), int(occ_cnt[k]),
                           round(float(occ_cnt[k]) / nnz, 4)]
                          for k in order],
        "occupancy_p50": int(_percentile(occ_cnt, 50)),
    }

    rnnz = np.diff(A.ptr)
    k_raw, k_pad = facts["k"], facts["k_padded"]
    out["ell"] = {
        "k": k_raw, "k_padded": k_pad,
        "row_nnz": {"min": int(rnnz.min()),
                    "mean": round(float(rnnz.mean()), 2),
                    "p50": int(_percentile(rnnz, 50)),
                    "max": k_raw},
        "pad_frac": round(1.0 - nnz / (n * max(k_raw, 1)), 4),
        "lane_pad_frac": round(1.0 - nnz / (n * k_pad), 4),
    }

    n_tiles, _, tiles, starts, win = tile_windows_host(A, tile)
    local = col - starts[tiles]
    r_in_tile = rows - tiles * tile
    curve: List[Dict[str, Any]] = []
    for gr, gc in granules:
        key = (tiles * (-(-tile // gr)) + r_in_tile // gr) \
            * (-(-win // gc)) + local // gc
        occupied = _distinct(key)
        total = n_tiles * (-(-tile // gr)) * (-(-win // gc))
        row_curve = {
            "granule": "%dx%d" % (gr, gc),
            "occupied_frac": round(occupied / max(total, 1), 6),
        }
        if (gr, gc) != (1, 1):
            row_curve["fill_in_occupied"] = round(
                nnz / max(occupied * gr * gc, 1), 6)
        curve.append(row_curve)
    out["window"] = {
        "tiles": int(n_tiles), "tile": int(tile), "win": int(win),
        "fill": round(nnz / max(n_tiles * tile * win, 1), 6),
        "bytes": int(n_tiles * tile * win * itemsize),
        "density_curve": curve,
    }
    return out


def candidate_table(A, itemsize: int = 4, on_tpu: bool = False,
                    dense_cutoff: int = 2048,
                    max_diags: Optional[int] = None,
                    max_fill: Optional[float] = None,
                    well_max_win_bytes: int = 4 << 20,
                    budget_remaining: Optional[int] = None,
                    budget_total: Optional[int] = None,
                    tile: int = _TILE) -> List[Dict[str, Any]]:
    """Predicted ``{flops, bytes}`` of one SpMV (the stored operator read
    once, x read, y written) for every candidate format of A, with each
    one's eligibility and decline reason, from the host CSR alone.
    Without explicit thresholds the DIA limits are the JAX package's off
    a TPU (40 diagonals, fill 1.5); the dense window is eligible only
    ``on_tpu``."""
    n, m = A.shape
    nnz = max(A.nnz, 1)
    br, bc = getattr(A, "block_size", (1, 1))
    is_block = (br, bc) != (1, 1)
    vec = (n * br + m * bc) * itemsize
    if max_diags is None:
        max_diags = 512 if on_tpu else 40
    if max_fill is None:
        max_fill = 16.0 if on_tpu else 1.5
    facts = fast_facts(A, tile=tile, itemsize=itemsize)
    rows: List[Dict[str, Any]] = []

    def cand(fmt, eligible, why, flops, stored):
        rows.append({
            "format": fmt, "eligible": bool(eligible),
            **({"why": why} if why else {}),
            "predicted": {"flops": int(flops),
                          "bytes": int(stored + vec)},
            "stored_bytes": int(stored)})

    dense_ok = (not is_block and max(n, m) <= dense_cutoff
                and nnz > 0.02 * n * m)
    cand("dense", dense_ok,
         None if dense_ok else (
             "block values" if is_block else
             "%d > dense cutoff %d" % (max(n, m), dense_cutoff)
             if max(n, m) > dense_cutoff else
             "density below the 2% dense floor"),
         2 * n * m, n * m * itemsize)

    nd = facts["ndiags"]
    fill = facts["dia_fill"] if nd else float("inf")
    dia_stored = nd * n * itemsize
    dia_ok = (not is_block and nd and nd <= max_diags
              and fill <= max_fill and dia_stored < 2 << 30)
    cand("dia", dia_ok,
         None if dia_ok else (
             "block values" if is_block else
             "%d diagonals > max_diags %d" % (nd, max_diags)
             if nd > max_diags else
             "fill %.3g > max_fill %.3g" % (fill, max_fill)
             if fill > max_fill else "data over the 2 GB guard"),
         2 * nd * n, dia_stored)

    need = facts["dwin_bytes"]
    cap_total = _DWIN_MAX_BYTES if budget_total is None else budget_total
    cap_now = cap_total if budget_remaining is None \
        else min(cap_total, budget_remaining)
    vmem_ok = (2 * _DWIN_TILE + 4) * facts["dwin_win"] * itemsize \
        <= 10 << 20
    dwin_why = None
    if is_block:
        dwin_why = "block values"
    elif n != m:
        dwin_why = "rectangular"
    elif need > cap_total:
        dwin_why = "window"
    elif need > cap_now:
        dwin_why = "budget"
    elif not vmem_ok:
        dwin_why = "vmem"
    elif not on_tpu:
        dwin_why = "auto picks dense windows on TPU only"
    cand("dwin", dwin_why is None, dwin_why,
         2 * facts["dwin_tiles"] * _DWIN_TILE * facts["dwin_win"], need)

    k_pad = max(4, facts["k_padded"])
    win = facts["win"]
    well_ok = win * bc * 4 <= well_max_win_bytes
    n_tiles = facts["tiles"]
    well_stored = (n_tiles * 4
                   + n_tiles * tile * k_pad * (4 + itemsize * br * bc))
    cand("well", well_ok,
         None if well_ok else
         "window %d col x 4 B > %d B VMEM budget"
         % (win * bc, well_max_win_bytes),
         2 * n_tiles * tile * k_pad * br * bc, well_stored)

    k_ell = max(_ELL_PAD, k_pad)
    cand("ell", True, None,
         2 * n * k_ell * br * bc,
         n * k_ell * (4 + itemsize * br * bc))
    return rows


def best_candidate(candidates: List[Dict[str, Any]],
                   eligible_only: bool = True
                   ) -> Optional[Dict[str, Any]]:
    """The row of least predicted bytes (among the eligible ones by
    default)."""
    rows = [c for c in candidates if c["eligible"]] if eligible_only \
        else list(candidates)
    return min(rows, key=lambda c: c["predicted"]["bytes"]) if rows \
        else None


def _rcm_perm(A) -> np.ndarray:
    """Reverse Cuthill–McKee permutation of the symmetrized pattern."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    mat = sp.csr_matrix(
        (np.ones(A.nnz, np.int8), A.col, A.ptr), shape=A.shape)
    return np.asarray(reverse_cuthill_mckee(mat, symmetric_mode=True))


class _Pattern:
    """A permuted sparsity pattern: the CSR fields the advisor reads."""

    def __init__(self, ptr, col, shape, block_size):
        self.ptr = ptr
        self.col = col
        self.shape = shape
        self.nrows, self.ncols = shape
        self.nnz = len(col)
        self.block_size = block_size

    def expanded_rows(self):
        r = getattr(self, "_rows_cache", None)
        if r is None:
            r = np.repeat(np.arange(self.nrows), np.diff(self.ptr))
            self._rows_cache = r
        return r


def permute_pattern(A, perm: np.ndarray) -> _Pattern:
    """The pattern of P A Pᵀ (values dropped)."""
    import scipy.sparse as sp
    mat = sp.csr_matrix(
        (np.ones(A.nnz, np.float32), A.col, A.ptr), shape=A.shape)
    mat = mat[perm][:, perm].tocsr()
    mat.sort_indices()
    return _Pattern(mat.indptr.astype(np.int64),
                    mat.indices.astype(np.int32), mat.shape,
                    getattr(A, "block_size", (1, 1)))


def advise(A, metrics: Optional[Dict[str, Any]] = None,
           variants: Sequence[str] = ADVISOR_VARIANTS,
           itemsize: int = 4, on_tpu: bool = False, tile: int = _TILE,
           dense_cutoff: int = 2048) -> Dict[str, Any]:
    """The reorder advisor for one operator: for each variant, the
    structural metrics and the candidate table under the permutation,
    and ``gain``, the best eligible predicted bytes of the identity order
    over the permuted one's. ``best`` names the variant of largest gain
    above 1, if any. Predicts only: nothing is converted."""
    met_id = metrics if metrics is not None else structure_metrics(
        A, tile=tile, itemsize=itemsize)
    cand_id = candidate_table(A, itemsize=itemsize, on_tpu=on_tpu,
                              dense_cutoff=dense_cutoff, tile=tile)
    best_id = best_candidate(cand_id)
    out: Dict[str, Any] = {
        "identity": {"best": best_id["format"] if best_id else None,
                     "bytes": best_id["predicted"]["bytes"]
                     if best_id else None},
        "variants": []}
    if A.nnz == 0 or A.nrows == 0:
        return out
    rcm = _rcm_perm(A)
    perms = {"rcm": rcm, "cm": rcm[::-1]}
    best_row = None
    for name in variants:
        perm = perms.get(name)
        if perm is None:
            continue
        B = permute_pattern(A, perm)
        met_p = structure_metrics(B, tile=tile, itemsize=itemsize)
        cand_p = candidate_table(B, itemsize=itemsize, on_tpu=on_tpu,
                                 dense_cutoff=dense_cutoff, tile=tile)
        best_p = best_candidate(cand_p)
        gain = None
        if best_id and best_p and best_p["predicted"]["bytes"]:
            gain = round(best_id["predicted"]["bytes"]
                         / best_p["predicted"]["bytes"], 4)
        by_id = {c["format"]: c["predicted"]["bytes"] for c in cand_id}
        per_format = {
            c["format"]: round(by_id[c["format"]]
                               / c["predicted"]["bytes"], 4)
            for c in cand_p
            if c["predicted"]["bytes"] and by_id.get(c["format"])}
        row = {
            "variant": name,
            "best": best_p["format"] if best_p else None,
            "bytes": best_p["predicted"]["bytes"] if best_p else None,
            "gain": gain,
            "per_format": per_format,
            "densify": {
                "ndiags": [met_id["diagonals"]["ndiags"],
                           met_p["diagonals"]["ndiags"]],
                "window_fill": [met_id["window"]["fill"],
                                met_p["window"]["fill"]],
                "window_win": [met_id["window"]["win"],
                               met_p["window"]["win"]],
                "ell_pad_frac": [met_id["ell"]["pad_frac"],
                                 met_p["ell"]["pad_frac"]],
                "bandwidth_max": [met_id["bandwidth"]["max"],
                                  met_p["bandwidth"]["max"]],
            },
            "candidates": cand_p,
        }
        out["variants"].append(row)
        if gain is not None and gain > 1.0 and (
                best_row is None or gain > best_row["gain"]):
            best_row = row
    if best_row is not None:
        out["best"] = {"variant": best_row["variant"],
                       "gain": best_row["gain"],
                       "format": best_row["best"],
                       "per_format": best_row["per_format"],
                       "densify": best_row["densify"]}
    return out


#: plans by (fingerprint, mode), the PERM_CACHE_SIZE used last: the
#: permutation depends on the pattern only, so a second build of the
#: same pattern reuses it
_PERM_CACHE: "OrderedDict[Tuple[str, str], Optional[Dict[str, Any]]]" = \
    OrderedDict()
PERM_CACHE_SIZE = 4


def stencil_prefiltered(A) -> bool:
    """Does A already pack into a few well-filled diagonals (at most
    PREFILTER_DIAGS, stored at most PREFILTER_FILL times its nonzeros)?
    Such a stencil is what a reorder would recover, not improve: "auto"
    leaves it without paying for an RCM."""
    nd = _distinct(np.repeat(np.arange(A.nrows, dtype=np.int64),
                             np.diff(A.ptr)) - A.col)
    return nd <= PREFILTER_DIAGS and nd * A.nrows <= PREFILTER_FILL * A.nnz


def auto_variant(A, itemsize: int = 4):
    """The "auto" mode's verdict on A: (variant or None, predicted gain or
    None, the advice or None when the stencil pre-filter decided)."""
    if stencil_prefiltered(A):
        return None, None, None
    adv = advise(A, itemsize=itemsize, on_tpu=False)
    best = adv.get("best")
    if best is not None and best.get("gain") \
            and best["gain"] >= GAIN_FLOOR:
        return best["variant"], float(best["gain"]), adv
    return None, None, adv


def reorder_plan(A, mode: str = "auto",
                 itemsize: int = 4) -> Optional[Dict[str, Any]]:
    """Whether to execute a reorder of the scalar square matrix A, and
    its plan, or None for the identity order (amgcl_tpu/telemetry/
    structure.py:745-836). ``mode``: "auto" reorders when the advisor
    (priced off a TPU) predicts at least GAIN_FLOOR, "rcm"/"cm" force that
    variant, "off" never reorders. The plan holds ``perm``/``iperm``
    (``A_perm = A[perm][:, perm]``), ``val_perm`` (``A_perm.val =
    A.val[val_perm]``), ``variant``, ``fingerprint`` (of A's pattern),
    ``predicted_gain`` (None when forced) and ``n``; a rebuild recognizes
    an original-order matrix by its fingerprint. Block values
    and patterns above MAX_ADVISE_NNZ are left as they are."""
    if mode == "off":
        return None
    if getattr(A, "block_size", (1, 1)) != (1, 1):
        return None
    if A.nnz == 0 or A.nrows == 0 or A.nrows != A.ncols:
        return None
    if A.nnz > MAX_ADVISE_NNZ:
        return None
    fp = fingerprint(A)
    key = (fp, mode)
    if key in _PERM_CACHE:
        _PERM_CACHE.move_to_end(key)
        return _PERM_CACHE[key]
    plan = None
    if mode == "auto":
        variant, gain, _ = auto_variant(A, itemsize)
    else:
        variant, gain = mode, None
    if variant is not None:
        import scipy.sparse as sp
        rcm = _rcm_perm(A)
        perm = rcm if variant == "rcm" else rcm[::-1]
        perm = np.ascontiguousarray(perm, dtype=np.int64)
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(A.nrows, dtype=np.int64)
        # the value map: a permuted matrix whose values are positions
        # (1-based: scipy would drop a stored 0)
        tag = sp.csr_matrix(
            (np.arange(1, A.nnz + 1, dtype=np.int64), A.col, A.ptr),
            shape=A.shape)
        tag = tag[perm][:, perm].tocsr()
        tag.sort_indices()
        plan = {"perm": perm, "iperm": iperm,
                "val_perm": np.ascontiguousarray(tag.data) - 1,
                "variant": variant, "fingerprint": fp,
                "predicted_gain": gain, "n": int(A.nrows)}
    _PERM_CACHE[key] = plan
    if len(_PERM_CACHE) > PERM_CACHE_SIZE:
        _PERM_CACHE.popitem(last=False)
    return plan


def banded_pattern(n: int, bw: int = 4):
    """(ptr, col, val) of a Toeplitz band of half-bandwidth ``bw``
    (``2·bw + 1`` full diagonals, SPD by diagonal dominance)."""
    offs = np.arange(-bw, bw + 1)
    rows_l, cols_l, vals_l = [], [], []
    ridx = np.arange(n, dtype=np.int64)
    for off in offs:
        c = ridx + off
        ok = (c >= 0) & (c < n)
        rows_l.append(ridx[ok])
        cols_l.append(c[ok])
        vals_l.append(np.full(ok.sum(),
                              2.0 * bw + 1.0 if off == 0 else -0.5))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    ptr = np.zeros(n + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    return ptr, cols.astype(np.int32), vals


def permuted_banded(n: int = 2048, bw: int = 4, seed: int = 0,
                    local: Optional[int] = None):
    """A banded SPD matrix under a random symmetric permutation (RCM
    recovers the band): ``(A_permuted, A_banded, perm)`` as CSRs.
    ``local`` shuffles within contiguous blocks of that size instead of
    globally."""
    import scipy.sparse as sp
    from amgcl_tpu_torch.ops.csr import CSR
    ptr, col, val = banded_pattern(n, bw)
    A0 = CSR(ptr, col, val, n)
    rng = np.random.RandomState(seed)
    if local:
        perm = np.arange(n)
        for s in range(0, n, int(local)):
            blk = perm[s:s + int(local)].copy()
            rng.shuffle(blk)
            perm[s:s + int(local)] = blk
    else:
        perm = rng.permutation(n)
    mat = sp.csr_matrix((A0.val, A0.col, A0.ptr), shape=(n, n))
    mat = mat[perm][:, perm].tocsr()
    mat.sort_indices()
    return CSR(mat.indptr, mat.indices, mat.data, n), A0, perm
