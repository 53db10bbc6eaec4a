// Native set-up kernels of amgcl_tpu_torch: the host passes of the
// hierarchy's set-up (strength filtering, greedy aggregation, the hash
// SpGEMM, the ELL and DIA packs, the diagonal-Galerkin multiply-adds, the
// ILU(k) pattern and the Ruge-Stuben split), over a plain C ABI loaded
// with ctypes by amgcl_tpu_torch/native.py. The package's own copy of the
// JAX package's csrc/setup_kernels.cpp: the same functions, the same
// arithmetic in the same order, so that both packages' set-ups agree bit
// for bit. Standard algorithms implemented afresh, not translated from the
// reference sources.
//
// Build (native.py does it at first use, into amgcl_tpu_torch/_build/):
//   g++ -O3 -fopenmp -shared -fPIC -std=c++17 \
//       -o libamgcl_setup_<hash>.so setup_kernels.cpp
// No -march: the default target of x86-64 has no FMA, so the multiply-adds
// below round their product and their sum apart, as numpy does.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Greedy distance-2 aggregation over a strength mask.
//
// ptr/col: CSR pattern of A (n rows); strong: per-entry 0/1 strength flag
// (diagonal entries must be 0). agg (out, size n): aggregate id per node or
// -1 for nodes with no strong connections. Returns the number of
// aggregates.
//
// Sweep: visiting nodes in index order, a node that was never claimed
// becomes the root of a new aggregate, finalizes all its unclaimed or
// tentatively-claimed strong neighbors, and tentatively claims their
// neighbors (a later root may steal tentative nodes as its own distance-1
// members; leftover tentative nodes keep the aggregate that claimed them).
int64_t aggregate_d2(int64_t n, const int64_t* ptr, const int32_t* col,
                     const uint8_t* strong, int64_t* agg) {
  const int64_t kUnset = -3, kTentative = -2, kIsolated = -1;
  std::vector<int64_t> owner(n, kUnset);  // tentative owner id
  for (int64_t i = 0; i < n; ++i) {
    bool has_strong = false;
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j)
      if (strong[j]) { has_strong = true; break; }
    agg[i] = has_strong ? kUnset : kIsolated;
  }

  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != kUnset) continue;
    if (owner[i] != kUnset) continue;  // tentatively claimed: not a root
    const int64_t id = count++;
    agg[i] = id;
    // finalize strong neighbors
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j) {
      if (!strong[j]) continue;
      const int32_t c = col[j];
      if (agg[c] == kUnset) {
        agg[c] = id;
        // tentatively claim the neighbors' neighbors
        for (int64_t k = ptr[c]; k < ptr[c + 1]; ++k) {
          if (!strong[k]) continue;
          const int32_t cc = col[k];
          if (agg[cc] == kUnset && owner[cc] == kUnset) owner[cc] = id;
        }
      }
    }
  }
  // leftover tentatives keep their claiming aggregate
  for (int64_t i = 0; i < n; ++i)
    if (agg[i] == kUnset) agg[i] = owner[i] != kUnset ? owner[i] : kIsolated;

  // aggregates can lose every finalized member only if they never had one;
  // compress ids to be safe (cheap single pass)
  std::vector<int64_t> seen(count, 0);
  for (int64_t i = 0; i < n; ++i)
    if (agg[i] >= 0) seen[agg[i]] = 1;
  std::vector<int64_t> remap(count, -1);
  int64_t live = 0;
  for (int64_t a = 0; a < count; ++a)
    if (seen[a]) remap[a] = live++;
  if (live != count)
    for (int64_t i = 0; i < n; ++i)
      if (agg[i] >= 0) agg[i] = remap[agg[i]];
  return live;
}

// Per-entry strength flag: |a_ij|^2 > eps^2 * |a_ii * a_jj| (off-diagonal).
void strength_mask(int64_t n, const int64_t* ptr, const int32_t* col,
                   const double* val, double eps, uint8_t* strong) {
  std::vector<double> dia(n, 0.0);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j)
      if (col[j] == i) dia[i] = val[j] < 0 ? -val[j] : val[j];
  const double e2 = eps * eps;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j) {
      const int32_t c = col[j];
      strong[j] =
          (c != i) && (val[j] * val[j] > e2 * dia[i] * dia[c]) ? 1 : 0;
    }
}

// Symmetrize a 0/1 strength mask in place: strong[i->j] |= strong[j->i].
// Requires sorted column indices per row (binary search on the reverse
// entry).
void symmetrize_mask(int64_t n, const int64_t* ptr, const int32_t* col,
                     uint8_t* strong) {
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j) {
      if (strong[j]) continue;
      const int32_t c = col[j];
      // find (c, i)
      int64_t lo = ptr[c], hi = ptr[c + 1];
      while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (col[mid] < i) lo = mid + 1; else hi = mid;
      }
      if (lo < ptr[c + 1] && col[lo] == (int32_t)i && strong[lo])
        strong[j] = 1;
    }
  }
}

int omp_max_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sparse general matrix-matrix multiply (CSR x CSR), two-phase, hash-based
// per-row accumulators (open addressing, power-of-2 capacity) — no large
// per-thread scratch, rows parallelized dynamically.

namespace {

struct HashAcc {
  std::vector<int32_t> keys;
  std::vector<double> vals;
  int64_t mask = 0;

  void reset_keys(int64_t cap_hint) {
    int64_t cap = 16;
    while (cap < cap_hint * 2) cap <<= 1;
    keys.assign(cap, -1);
    mask = cap - 1;
  }

  void reset(int64_t cap_hint) {
    reset_keys(cap_hint);
    vals.assign(mask + 1, 0.0);
  }

  // insert without value accumulation; returns true when the key is new
  inline bool insert_key(int32_t key) {
    int64_t h = (static_cast<uint32_t>(key) * 2654435761u) & mask;
    while (true) {
      if (keys[h] == key) return false;
      if (keys[h] == -1) { keys[h] = key; return true; }
      h = (h + 1) & mask;
    }
  }

  inline void add(int32_t key, double v) {
    int64_t h = (static_cast<uint32_t>(key) * 2654435761u) & mask;
    while (true) {
      if (keys[h] == key) { vals[h] += v; return; }
      if (keys[h] == -1) { keys[h] = key; vals[h] = v; return; }
      h = (h + 1) & mask;
    }
  }

  // accumulate only when the key is already present (masked products)
  inline void add_if_present(int32_t key, double v) {
    int64_t h = (static_cast<uint32_t>(key) * 2654435761u) & mask;
    while (true) {
      if (keys[h] == key) { vals[h] += v; return; }
      if (keys[h] == -1) return;
      h = (h + 1) & mask;
    }
  }

  inline double get(int32_t key) const {
    int64_t h = (static_cast<uint32_t>(key) * 2654435761u) & mask;
    while (true) {
      if (keys[h] == key) return vals[h];
      if (keys[h] == -1) return 0.0;
      h = (h + 1) & mask;
    }
  }
};

// Block-value accumulator: each slot owns a bs-element dense block.
struct BlockHashAcc {
  std::vector<int32_t> keys;
  std::vector<double> vals;  // (mask+1) * bs
  std::vector<int64_t> used;
  int64_t mask = 0;
  int64_t bs = 1;

  void reset(int64_t cap_hint, int64_t bs_) {
    int64_t cap = 16;
    while (cap < cap_hint * 2) cap <<= 1;
    keys.assign(cap, -1);
    mask = cap - 1;
    bs = bs_;
    vals.assign(cap * bs, 0.0);
    used.clear();
  }

  inline double* slot(int32_t key) {
    int64_t h = (static_cast<uint32_t>(key) * 2654435761u) & mask;
    while (true) {
      if (keys[h] == key) return &vals[h * bs];
      if (keys[h] == -1) {
        keys[h] = key;
        used.push_back(h);
        return &vals[h * bs];
      }
      h = (h + 1) & mask;
    }
  }
};

// Shared numeric pass over the value type (f64 / f32 front-ends below).
template <class T>
void spgemm_numeric_t(int64_t n, const int64_t* aptr, const int32_t* acol,
                      const T* aval, const int64_t* bptr,
                      const int32_t* bcol, const T* bval,
                      const int64_t* cptr, int32_t* ccol, T* cval) {
#pragma omp parallel
  {
    HashAcc acc;
    std::vector<int64_t> tmp;
#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
      acc.reset(cptr[i + 1] - cptr[i] + 8);
      for (int64_t j = aptr[i]; j < aptr[i + 1]; ++j) {
        const int32_t a = acol[j];
        const double av = static_cast<double>(aval[j]);
        for (int64_t t = bptr[a]; t < bptr[a + 1]; ++t)
          acc.add(bcol[t], av * static_cast<double>(bval[t]));
      }
      tmp.clear();
      for (int64_t h = 0; h <= acc.mask; ++h)
        if (acc.keys[h] != -1) tmp.push_back(h);
      std::sort(tmp.begin(), tmp.end(),
                [&](int64_t x, int64_t y) { return acc.keys[x] < acc.keys[y]; });
      int64_t o = cptr[i];
      for (int64_t h : tmp) {
        ccol[o] = acc.keys[h];
        cval[o] = static_cast<T>(acc.vals[h]);
        ++o;
      }
    }
  }
}

}  // namespace

extern "C" {

// Pass 1: per-row nnz of C = A (n x k) * B (k x m).
void spgemm_symbolic(int64_t n, const int64_t* aptr, const int32_t* acol,
                     const int64_t* bptr, const int32_t* bcol,
                     int64_t* c_row_nnz) {
#pragma omp parallel
  {
    HashAcc acc;
#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
      int64_t hint = 8;
      for (int64_t j = aptr[i]; j < aptr[i + 1]; ++j)
        hint += bptr[acol[j] + 1] - bptr[acol[j]];
      acc.reset_keys(hint);
      int64_t cnt = 0;
      for (int64_t j = aptr[i]; j < aptr[i + 1]; ++j) {
        const int32_t a = acol[j];
        for (int64_t t = bptr[a]; t < bptr[a + 1]; ++t)
          if (acc.insert_key(bcol[t])) ++cnt;
      }
      c_row_nnz[i] = cnt;
    }
  }
}

// Pass 2: fill col/val given precomputed cptr (exclusive scan of row nnz).
// Column indices are emitted sorted per row.
void spgemm_numeric(int64_t n, const int64_t* aptr, const int32_t* acol,
                    const double* aval, const int64_t* bptr,
                    const int32_t* bcol, const double* bval,
                    const int64_t* cptr, int32_t* ccol, double* cval) {
  spgemm_numeric_t<double>(n, aptr, acol, aval, bptr, bcol, bval, cptr,
                           ccol, cval);
}

void spgemm_numeric_f32(int64_t n, const int64_t* aptr, const int32_t* acol,
                        const float* aval, const int64_t* bptr,
                        const int32_t* bcol, const float* bval,
                        const int64_t* cptr, int32_t* ccol, float* cval) {
  spgemm_numeric_t<float>(n, aptr, acol, aval, bptr, bcol, bval, cptr,
                          ccol, cval);
}

// Block-valued numeric pass: aval blocks are (br x bk) row-major, bval
// (bk x bc), accumulating (br x bc) product blocks. Same symbolic pass as
// the scalar kernel (the pattern is value-type-free).
void spgemm_numeric_block(int64_t n, const int64_t* aptr,
                          const int32_t* acol, const double* aval,
                          const int64_t* bptr, const int32_t* bcol,
                          const double* bval, const int64_t* cptr,
                          int32_t* ccol, double* cval, int64_t br,
                          int64_t bk, int64_t bc) {
  const int64_t as = br * bk, bs = bk * bc, cs = br * bc;
#pragma omp parallel
  {
    BlockHashAcc acc;
    std::vector<int64_t> tmp;
#pragma omp for schedule(dynamic, 128)
    for (int64_t i = 0; i < n; ++i) {
      acc.reset(cptr[i + 1] - cptr[i] + 8, cs);
      for (int64_t j = aptr[i]; j < aptr[i + 1]; ++j) {
        const int32_t a = acol[j];
        const double* Ab = aval + j * as;
        for (int64_t t = bptr[a]; t < bptr[a + 1]; ++t) {
          const double* Bb = bval + t * bs;
          double* Cb = acc.slot(bcol[t]);
          for (int64_t r = 0; r < br; ++r)
            for (int64_t k = 0; k < bk; ++k) {
              const double av = Ab[r * bk + k];
              if (av == 0.0) continue;
              const double* Brow = Bb + k * bc;
              double* Crow = Cb + r * bc;
              for (int64_t c = 0; c < bc; ++c) Crow[c] += av * Brow[c];
            }
        }
      }
      tmp = acc.used;
      std::sort(tmp.begin(), tmp.end(), [&](int64_t x, int64_t y) {
        return acc.keys[x] < acc.keys[y];
      });
      int64_t o = cptr[i];
      for (int64_t h : tmp) {
        ccol[o] = acc.keys[h];
        std::memcpy(cval + o * cs, &acc.vals[h * cs], cs * sizeof(double));
        ++o;
      }
    }
  }
}

// ELL packing: scatter CSR rows into dense (n, K) column/value planes
// (the host->device format conversion — the hot part of to_device).
// The value cast (f64 input -> f32/f64 output) is fused into the pack;
// both output planes must arrive zeroed. bs = elements per value (1 for
// scalar, br*bc for block values).
void ell_pack(int64_t n, const int64_t* ptr, const int32_t* col,
              const double* val, int64_t K, int64_t bs, int32_t* ocols,
              double* ovals) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t o = i * K;
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j, ++o) {
      ocols[o] = col[j];
      std::memcpy(ovals + o * bs, val + j * bs, bs * sizeof(double));
    }
  }
}

void ell_pack_f32(int64_t n, const int64_t* ptr, const int32_t* col,
                  const double* val, int64_t K, int64_t bs, int32_t* ocols,
                  float* ovals) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t o = i * K;
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j, ++o) {
      ocols[o] = col[j];
      const double* src = val + j * bs;
      float* dst = ovals + o * bs;
      for (int64_t b = 0; b < bs; ++b) dst[b] = static_cast<float>(src[b]);
    }
  }
}

// SPAI-0 diagonal: m_i = a_ii / sum_j a_ij^2 (one fused pass; the
// reference's spai0.hpp row loop, here the hot part of the default
// smoother's host build).
void spai0_diag(int64_t n, const int64_t* ptr, const int32_t* col,
                const double* val, double* m) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double dia = 0.0, ss = 0.0;
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j) {
      const double v = val[j];
      ss += v * v;
      if (col[j] == i) dia = v;
    }
    m[i] = ss != 0.0 ? dia / ss : 0.0;
  }
}

// Pattern-restricted product: tval[q] = sum_k A[i,k] B[k, tcol[q]] for each
// target entry q of row i — one pass, no symbolic phase, no allocation of
// the full product. This is the Chow-Patel sweep kernel: (L+I)U evaluated
// on the factor pattern (reference role: the per-entry inner products of
// amgcl/relaxation/ilu0_chow_patel.hpp's sweeps).
void spgemm_masked(int64_t n, const int64_t* aptr, const int32_t* acol,
                   const double* aval, const int64_t* bptr,
                   const int32_t* bcol, const double* bval,
                   const int64_t* tptr, const int32_t* tcol, double* tval) {
#pragma omp parallel
  {
    HashAcc acc;
#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
      const int64_t t0 = tptr[i], t1 = tptr[i + 1];
      if (t0 == t1) continue;
      acc.reset(t1 - t0 + 8);
      for (int64_t q = t0; q < t1; ++q) acc.add(tcol[q], 0.0);
      for (int64_t j = aptr[i]; j < aptr[i + 1]; ++j) {
        const int32_t a = acol[j];
        const double av = aval[j];
        if (av == 0.0) continue;
        for (int64_t t = bptr[a]; t < bptr[a + 1]; ++t)
          acc.add_if_present(bcol[t], av * bval[t]);
      }
      for (int64_t q = t0; q < t1; ++q) tval[q] = acc.get(tcol[q]);
    }
  }
}

// Strength-filtered matrix with weak-entry lumping (the SA "filtered"
// operator): strong entries (|a_ij|^2 > eps^2 |a_ii a_jj|) and diagonals
// are kept, weak off-diagonals removed and added to the diagonal.
// Pass 1 counts kept entries per row; pass 2 fills. f64 and f32 value
// variants share the templates below (templates cannot carry C linkage,
// so the block is closed around them).
}  // extern "C"

template <typename V>
static void filter_count_impl(int64_t n, const int64_t* ptr,
                              const int32_t* col, const V* val, double eps,
                              int64_t* row_nnz) {
  std::vector<double> dia(n, 0.0);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j)
      if (col[j] == i) dia[i] = val[j] < 0 ? -double(val[j]) : val[j];
  const double e2 = eps * eps;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t cnt = 0;
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j) {
      const int32_t c = col[j];
      if (c == i || double(val[j]) * val[j] > e2 * dia[i] * dia[c]) ++cnt;
    }
    row_nnz[i] = cnt;
  }
}

template <typename V>
static void filter_fill_impl(int64_t n, const int64_t* ptr,
                             const int32_t* col, const V* val, double eps,
                             const int64_t* optr, int32_t* ocol, V* oval,
                             V* dinv) {
  std::vector<double> dia(n, 0.0);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j)
      if (col[j] == i) dia[i] = val[j] < 0 ? -double(val[j]) : val[j];
  const double e2 = eps * eps;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t o = optr[i];
    int64_t dpos = -1;
    V lump = 0;
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j) {
      const int32_t c = col[j];
      if (c == i) {
        dpos = o;
        ocol[o] = c;
        oval[o] = val[j];
        ++o;
      } else if (double(val[j]) * val[j] > e2 * dia[i] * dia[c]) {
        ocol[o] = c;
        oval[o] = val[j];
        ++o;
      } else {
        lump += val[j];
      }
    }
    V d = 0;
    if (dpos >= 0) {
      oval[dpos] += lump;
      d = oval[dpos];
    }
    dinv[i] = d != 0 ? V(1) / d : V(1);
  }
}

extern "C" {

void filter_count(int64_t n, const int64_t* ptr, const int32_t* col,
                  const double* val, double eps, int64_t* row_nnz) {
  filter_count_impl(n, ptr, col, val, eps, row_nnz);
}

void filter_count_f32(int64_t n, const int64_t* ptr, const int32_t* col,
                      const float* val, double eps, int64_t* row_nnz) {
  filter_count_impl(n, ptr, col, val, eps, row_nnz);
}

void filter_fill(int64_t n, const int64_t* ptr, const int32_t* col,
                 const double* val, double eps, const int64_t* optr,
                 int32_t* ocol, double* oval, double* dinv) {
  filter_fill_impl(n, ptr, col, val, eps, optr, ocol, oval, dinv);
}

void filter_fill_f32(int64_t n, const int64_t* ptr, const int32_t* col,
                     const float* val, double eps, const int64_t* optr,
                     int32_t* ocol, float* oval, float* dinv) {
  filter_fill_impl(n, ptr, col, val, eps, optr, ocol, oval, dinv);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// ILU(k) symbolic factorization: classic row-merge fill-level computation
// (IKJ ordering). For each row i, start from A's pattern at level 0; for
// each candidate column j < i (in ascending order), merge row j of the
// symbolic factor with propagated level lev(i,j) + lev(j,t) + 1; keep
// entries with level <= k. Sequential over rows (the dependency is real),
// linear-ish work for small k.

extern "C" {

// Pass 1+2 in one call with caller-provided output budget. Returns the
// total output nnz, or -1 if the budget was too small (caller doubles and
// retries). Output rows are sorted.
int64_t iluk_symbolic(int64_t n, const int64_t* ptr, const int32_t* col,
                      int64_t k, int64_t budget, int64_t* optr,
                      int32_t* ocol) {
  std::vector<int32_t> levels(budget, 0);
  // per-row workspace: linked-list row merge (Saad's style, re-derived)
  std::vector<int32_t> lev_w(n, -1);   // working levels per column
  std::vector<int32_t> next(n, -1);    // sorted linked list of columns
  optr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    // init working row from A's pattern
    int32_t head = -2;
    {
      int32_t prev = -1;
      for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j) {
        const int32_t c = col[j];
        lev_w[c] = 0;
        if (prev < 0) head = c; else next[prev] = c;
        prev = c;
      }
      if (prev >= 0) next[prev] = -2;  // terminator
      else head = -2;
    }
    // eliminate: walk columns j < i in ascending order
    for (int32_t j = head; j != -2 && j < (int32_t)i; j = next[j]) {
      const int32_t lev_ij = lev_w[j];
      if (lev_ij > k) continue;
      // merge factor row j (strictly upper part), propagated level
      int32_t p = j;  // insertion cursor in the linked list
      for (int64_t t = optr[j]; t < optr[j + 1]; ++t) {
        const int32_t c = ocol[t];
        if (c <= j) continue;
        const int32_t lv = lev_ij + levels[t] + 1;
        if (lv > k) continue;
        if (lev_w[c] >= 0) {
          if (lv < lev_w[c]) lev_w[c] = lv;
        } else {
          // insert c into the sorted list after cursor p
          while (next[p] != -2 && next[p] < c) p = next[p];
          next[c] = next[p];
          next[p] = c;
          lev_w[c] = lv;
        }
      }
    }
    // emit row i
    int64_t o = optr[i];
    for (int32_t c = head; c != -2; c = next[c]) {
      if (lev_w[c] <= k) {
        if (o >= budget) {  // out of space: clean up and signal retry
          for (int32_t cc = head; cc != -2; cc = next[cc]) lev_w[cc] = -1;
          return -1;
        }
        ocol[o] = c;
        levels[o] = lev_w[c];
        ++o;
      }
    }
    optr[i + 1] = o;
    // reset workspace
    for (int32_t c = head; c != -2; ) {
      const int32_t nx = next[c];
      lev_w[c] = -1;
      next[c] = -1;
      c = nx;
    }
  }
  return optr[n];
}

}  // extern "C"

// -- DIA packing -----------------------------------------------------------
// Device DIA conversion is setup's hottest host pass at large N (the numpy
// path spends seconds in int64 diagonal arithmetic at 14.6M nnz). These
// kernels mark the distinct diagonals and scatter values into the (ndiag, n)
// diagonal-major array with the dtype cast fused, OpenMP-parallel over rows.

extern "C" {

// hits: (nrows + ncols - 1) bytes, pre-zeroed; diagonal d = col - row marked
// at hits[d + nrows - 1].
void dia_mark(int64_t n, const int64_t* ptr, const int32_t* col,
              uint8_t* hits) {
  const int64_t base = n - 1;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j) {
      // rows sharing a diagonal write the same flag byte concurrently;
      // an atomic relaxed store keeps it defined under the memory model
#pragma omp atomic write
      hits[col[j] - i + base] = 1;
    }
}

// slot: (nrows + ncols - 1) int32 diagonal->row lookup; out: (ndiag * n),
// pre-zeroed, diagonal-major. Cast variants cover the f64-valued host CSR
// going to an f32 or f64 device hierarchy.
void dia_pack_f64_f32(int64_t n, const int64_t* ptr, const int32_t* col,
                      const double* val, const int32_t* slot, float* out) {
  const int64_t base = n - 1;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j)
      out[(int64_t)slot[col[j] - i + base] * n + i] =
          static_cast<float>(val[j]);
}

void dia_pack_f64_f64(int64_t n, const int64_t* ptr, const int32_t* col,
                      const double* val, const int32_t* slot, double* out) {
  const int64_t base = n - 1;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j)
      out[(int64_t)slot[col[j] - i + base] * n + i] = val[j];
}

void dia_pack_f32_f32(int64_t n, const int64_t* ptr, const int32_t* col,
                      const float* val, const int32_t* slot, float* out) {
  const int64_t base = n - 1;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j)
      out[(int64_t)slot[col[j] - i + base] * n + i] = val[j];
}

// -- stencil Galerkin inner kernel ------------------------------------------
// All pair products of one diagonal-space Galerkin stage in a single
// call: out[i] -= a[i] * b[i + s] over the valid index range, fused into
// one memory pass (ops/stencil.py StencilGalerkinPlan).
// Batched variant: all pair products of one Galerkin stage in a single
// call (no per-pair ctypes overhead), parallel over output diagonals so
// no two threads touch the same output row. a_idx/b_idx/out_idx select
// rows of the (ndiag, n) diagonal-major arrays; pairs sharing out_idx
// must be contiguous and the out rows pre-initialized.

void dia_fnma_batch_f64(int64_t n, int64_t npairs, const double* abase,
                        const int64_t* a_idx, const double* bbase,
                        const int64_t* b_idx, const int64_t* shifts,
                        double* obase, const int64_t* out_idx) {
#pragma omp parallel
  {
#pragma omp for schedule(dynamic, 1)
    for (int64_t p0 = 0; p0 < npairs; ++p0) {
      if (p0 > 0 && out_idx[p0 - 1] == out_idx[p0]) continue;
      for (int64_t p = p0; p < npairs && out_idx[p] == out_idx[p0]; ++p) {
        const double* a = abase + a_idx[p] * n;
        const double* b = bbase + b_idx[p] * n;
        double* out = obase + out_idx[p] * n;
        const int64_t s = shifts[p];
        const int64_t lo = s < 0 ? -s : 0;
        const int64_t hi = s > 0 ? n - s : n;
        for (int64_t i = lo; i < hi; ++i) out[i] -= a[i] * b[i + s];
      }
    }
  }
}

void dia_fnma_batch_f32(int64_t n, int64_t npairs, const float* abase,
                        const int64_t* a_idx, const float* bbase,
                        const int64_t* b_idx, const int64_t* shifts,
                        float* obase, const int64_t* out_idx) {
#pragma omp parallel
  {
#pragma omp for schedule(dynamic, 1)
    for (int64_t p0 = 0; p0 < npairs; ++p0) {
      if (p0 > 0 && out_idx[p0 - 1] == out_idx[p0]) continue;
      for (int64_t p = p0; p < npairs && out_idx[p] == out_idx[p0]; ++p) {
        const float* a = abase + a_idx[p] * n;
        const float* b = bbase + b_idx[p] * n;
        float* out = obase + out_idx[p] * n;
        const int64_t s = shifts[p];
        const int64_t lo = s < 0 ? -s : 0;
        const int64_t hi = s > 0 ? n - s : n;
        for (int64_t i = lo; i < hi; ++i) out[i] -= a[i] * b[i + s];
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Classic Ruge-Stuben C/F splitting (sequential dynamic measures).
//
// Reference role: amgcl/coarsening/ruge_stuben.hpp cfsplit. Independent
// implementation: a lazy max-heap (stale entries skipped by comparing the
// stored lambda against the current one) instead of the reference's bucket
// arrays; tie-break on the smaller index so the result matches the Python
// pass in coarsening/ruge_stuben.py exactly.
//
// cf: in/out, one byte per point — 0 undecided, 1 coarse, 2 fine (rows
// without strong connections arrive pre-marked 2).
// ---------------------------------------------------------------------------

#include <queue>
#include <utility>

extern "C" {

void rs_cfsplit(int64_t n, const int64_t* ptr, const int32_t* col,
                const uint8_t* strong, const int64_t* stp,
                const int32_t* stc, int8_t* cf) {
  std::vector<int64_t> lam(n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t t = 0;
    for (int64_t j = stp[i]; j < stp[i + 1]; ++j)
      t += (cf[stc[j]] == 0) ? 1 : 2;
    lam[i] = t;
  }
  // (lambda, -index): max lambda first, smaller index on ties
  std::priority_queue<std::pair<int64_t, int64_t>> pq;
  for (int64_t i = 0; i < n; ++i)
    if (cf[i] == 0) pq.push({lam[i], -i});
  while (!pq.empty()) {
    const int64_t l = pq.top().first;
    const int64_t i = -pq.top().second;
    pq.pop();
    if (cf[i] != 0 || l != lam[i]) continue;  // decided or stale
    if (l == 0) {
      for (int64_t k = 0; k < n; ++k)
        if (cf[k] == 0) cf[k] = 1;
      break;
    }
    cf[i] = 1;
    for (int64_t j = stp[i]; j < stp[i + 1]; ++j) {
      const int64_t c = stc[j];
      if (cf[c] != 0) continue;
      cf[c] = 2;
      // the new F point raises its strong neighbours' lambdas
      for (int64_t aj = ptr[c]; aj < ptr[c + 1]; ++aj) {
        if (!strong[aj]) continue;
        const int64_t ac = col[aj];
        if (cf[ac] == 0 && lam[ac] + 1 < n) pq.push({++lam[ac], -ac});
      }
    }
    // the new C point lowers its strong neighbours' lambdas
    for (int64_t j = ptr[i]; j < ptr[i + 1]; ++j) {
      if (!strong[j]) continue;
      const int64_t c = col[j];
      if (cf[c] == 0 && lam[c] > 0) pq.push({--lam[c], -c});
    }
  }
}

}  // extern "C"
