// Fused V-cycle legs for Hopper (sm_90a): the whole down leg and the
// whole up leg of a grid-aligned stencil level, each in one kernel.
//
// Replaces the Pallas TPU kernels of amgcl_tpu/ops/pallas_vcycle.py:
//   down_kernel  <- fused_down_sweep (base, zero_guess and framed modes):
//                   rc = Tᵀ (r − Mᵀ r) with r = f − A u; in zero_guess mode
//                   u = w ∘ f is formed first and written out as well.
//   up_kernel    <- fused_up_sweep (base and framed modes):
//                   out = u' + w ∘ (f − A u') with u' = u + T uc − M (T uc).
//
// T is the piecewise-constant tentative prolongation over 2×2×2 grid
// aggregates: fine point (z, y, x) belongs to coarse cell
// (z/2, y/2, x/2); fine points past the grid's end contribute nothing.
// A, M and Mᵀ are DIA operators: data[k * n + i] = Op[i, i + off[k]].
//
// What bounds them on the H100: memory traffic. Each leg reads the level's
// diagonals and a few vectors once at the least (down: nA + nM + 2 rows of
// n floats in, n/8 out; up: nA + nM + 3 rows in plus n/8, one row out) and
// does a few multiply-adds per byte, far below the card's float32 balance
// point, so the least time is bytes / 3.35 TB/s.
//
// Design. The TPU kernel DMAs a window of 2s + 2H floats per operand
// into VMEM for each coarse plane (s = one fine plane); at the 128³ fine
// level that is 384 KB per operand, more than a block's 227 KB of shared
// memory for all of them together.
//   down: one thread per fine row of a block of 32 consecutive coarse
//         cells × their 8 children. Each thread computes t = r − Mᵀ r at
//         its row, recomputing r = f − A u at the row and at each of its
//         Mᵀ neighbours from A, u and f read through L1/L2 ((1 + nM)
//         residuals a row). The 8 values of a cell meet in shared memory
//         and one thread per cell sums them in a fixed order: no float
//         atomics, so the same inputs give bit-identical results on every
//         run.
//   up:   a block takes a tile of tz fine planes × ty rows × all f0
//         (UpTile, chosen by vcycle_kernels.up_tile) and stages two boxes
//         of grid rows in shared memory (dynamic, above 48 KB by the
//         attribute). T holds T uc at every row that the M neighbours of
//         U's rows reach; U holds u' = u + T uc − M (T uc), formed once
//         for every row that the tile's A neighbours reach; then each
//         thread forms out = u' + w ∘ (f − A u') for its tile rows. A box
//         is its inner region plus a halo of planes and rows wide enough
//         for each offset's nearest (dz, dy, dx) split and the carry an x
//         step past the grid row adds; its rows run on past a plane's end
//         into the next, so a neighbour whose row wraps is in the box,
//         and every neighbour lies at a fixed distance per offset. The
//         first design recomputed u' at a row and at each of its nA
//         neighbours, (1 + nA)·nM reads of M a row, and located each
//         T uc term by carries and a coarse index; now M is read
//         (U rows / tile rows)·nM times a row and each term is a shared
//         load. A warp walks a grid row, a lane a point; each thread
//         issues kBatch loads of M (or A) before it adds them, since a
//         1,024-thread block keeps too few loads in flight otherwise, and
//         a row whose every neighbour lies in the frame skips the
//         per-point frame test. The arithmetic is the first design's:
//         T uc copied, M's sum and A's sum in offset order, each skipping
//         a neighbour outside the frame (the first design's plane test
//         after carries, which is the flat row falling outside [0, frame
//         rows)), so results are bit-identical to it. The C entry refuses
//         boxes that do not hold the offsets' reach.
// Every index is guarded: r, u and T uc are 0 outside the frame below
// ([0, n) in the base mode), as the TPU kernel's zero-padded frames make
// them, and a flat offset that runs off one grid row into the next reads
// that row (its DIA entry is 0 on a stencil).
//
// Framed mode (a z-slab of a grid sharded over a mesh, framed by real rows
// of its neighbour slabs; pallas_vcycle.py:187-194 and :477-483). Down:
// A, Mᵀ, f and u (or w) are frames of L rows in which tile row i is frame
// row H + i. Up: M, u and T uc live on a frame of fz fine planes in which
// tile plane z is frame plane z + zoff (zoff even, uc carrying zoff / 2
// coarse planes on each side); A, f, w and the output are the tile's own.
// Every index guard below is "inside the frame", so r, u' and T uc read 0
// only outside it; the up leg's box lies in frame planes. The base mode is the framed mode on a zero frame
// (H = 0, L = n; zoff = 0, fz = f2): the same operations in the same
// order, so its results are those of the kernels before the framed mode.
// It runs its own instantiation (FRAMED false), whose frame is known at
// compile time: with the frame as runtime arguments the base up leg
// took 16% longer at the 128³ main path's L0 on an H100 (0.2942 against
// 0.2541 ms; NVIDIA H100 80GB HBM3 at 700 W).
#include <cuda_runtime.h>

namespace amgcl_port {
namespace {

constexpr int kBlock = 256;       // threads per block
constexpr int kCells = 32;        // coarse cells per down block (× 8 = kBlock)
constexpr int kMaxDiag = 512;
// threads per up block: of 256, 512 and 1,024, 1,024 was the fastest at
// every level measured on an H100 (PERF.md §6)
constexpr int kUpThreads = 1024;
// up-leg loads a thread issues together: 16 was the fastest of 8, 16 and
// 32 at S1's L1 slab, within 5% of 8 at the main path's L0 and L1 on an
// H100 (PERF.md §6)
constexpr int kBatch = 16;
// the dynamic shared memory an up block may take beside its static arrays
constexpr int kUpMaxBox = 232448 - 4 * kMaxDiag * 4;
constexpr int kMaxDevices = 16;

struct Grid {
  int f2, f1, f0;                 // fine dims (z, y, x), C order
  int c1, c0;                     // coarse y and x extents
  int n;                          // f2 * f1 * f0
};

// r = f[j] − Σ_l A[l, j] u[j + off_l] at one frame row j of a frame of L
// rows; in zero-guess mode u is the smoother scale and the iterate w ∘ f.
template <bool ZERO>
__device__ __forceinline__ float residual_at(
    int j, int L, int na, const int* s_a, const float* __restrict__ a,
    const float* __restrict__ f, const float* __restrict__ u) {
  float r = f[j];
  for (int l = 0; l < na; ++l) {
    const int q = j + s_a[l];
    if (q >= 0 && q < L) {
      const float uq = ZERO ? u[q] * f[q] : u[q];
      r -= a[static_cast<size_t>(l) * L + j] * uq;
    }
  }
  return r;
}

// h, len: the frame (tile row i is frame row H + i of L); a, mt, f and u
// are frames, u_out and rc the tile's own. Without FRAMED the frame is the
// tile (H = 0, L = n), known at compile time.
template <bool ZERO, bool FRAMED>
__global__ void __launch_bounds__(kBlock)
down_kernel(Grid g, int h, int len, int nc, int na, int nm,
            const int* __restrict__ a_off, const float* __restrict__ a,
            const int* __restrict__ m_off, const float* __restrict__ mt,
            const float* __restrict__ f, const float* __restrict__ u,
            float* __restrict__ u_out, float* __restrict__ rc) {
  __shared__ int s_a[kMaxDiag];
  __shared__ int s_m[kMaxDiag];
  __shared__ float s_t[kBlock];
  const int H = FRAMED ? h : 0;
  const int L = FRAMED ? len : g.n;
  for (int k = threadIdx.x; k < na; k += kBlock) s_a[k] = a_off[k];
  for (int k = threadIdx.x; k < nm; k += kBlock) s_m[k] = m_off[k];
  __syncthreads();

  // thread t = ((pz * 2 + py) * kCells + cell) * 2 + px: a warp covers 32
  // consecutive fine x of one (z, y) parity, so its loads coalesce
  const int t = threadIdx.x;
  const int px = t & 1;
  const int cell = (t >> 1) & (kCells - 1);
  const int py = (t >> 6) & 1;
  const int pz = t >> 7;
  const int c = blockIdx.x * kCells + cell;
  float ti = 0.f;
  if (c < nc) {
    const int cx = c % g.c0;
    const int cyz = c / g.c0;
    const int cy = cyz % g.c1;
    const int cz = cyz / g.c1;
    const int x = 2 * cx + px, y = 2 * cy + py, z = 2 * cz + pz;
    if (x < g.f0 && y < g.f1 && z < g.f2) {
      const int i = (z * g.f1 + y) * g.f0 + x;
      const int p = H + i;
      if (ZERO) u_out[i] = u[p] * f[p];
      ti = residual_at<ZERO>(p, L, na, s_a, a, f, u);
      for (int k = 0; k < nm; ++k) {
        const int j = p + s_m[k];
        if (j >= 0 && j < L)
          ti -= mt[static_cast<size_t>(k) * L + p] *
                residual_at<ZERO>(j, L, na, s_a, a, f, u);
      }
    }
  }
  s_t[t] = ti;
  __syncthreads();
  if (t < kCells) {
    const int cc = blockIdx.x * kCells + t;
    if (cc < nc) {
      float sum = 0.f;
      for (int p = 0; p < 4; ++p)           // (pz, py) in order, then px
        sum += s_t[(p * kCells + t) * 2] + s_t[(p * kCells + t) * 2 + 1];
      rc[cc] = sum;
    }
  }
}

// Flat offset o as dz·s + dy·f0 + dx with each part rounded to the
// nearest (dx in [−f0/2, f0/2), then dy likewise within a plane): the
// decomposition by which the up leg's box is sized and indexed.
// A truncating split would write a step of (−1, 0, +1) as
// (0, 1 − f1, 1 − f0), asking for a halo of nearly a plane.
__host__ __device__ inline int floor_div(int a, int b) {       // b > 0
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}
__host__ __device__ inline void split_nearest(int o, int s, int f0, int* dz,
                                              int* dy, int* dx) {
  *dz = floor_div(o + s / 2, s);
  const int rem = o - *dz * s;
  *dy = floor_div(rem + f0 / 2, f0);
  *dx = rem - *dy * f0;
}

// The up leg's tile: tz fine planes × ty fine rows × all f0 of the grid.
// Its block stages two boxes of whole grid rows in shared memory: U, the
// rows whose u' the tile's A neighbours read (the tile with A's halo),
// and T, the rows whose T uc the U rows' M neighbours read (U with M's
// halo). A halo is (planes below, planes above, rows before, rows after).
// Box rows are counted in extended coordinates: box row (bz, by) holds
// the grid row at plane bz0 + bz and row by0 + by, where a row index past
// [0, f1) is the row that many rows on in the next (or previous) plane,
// as a flat offset's carry gives it; so a neighbour at flat offset o
// lies at a fixed distance in the box for every row, wrapped rows
// included.
struct Halo {
  int z_lo, z_hi, y_lo, y_hi;
};
struct UpTile {
  int tz, ty;
  Halo a, m;
  int a_min, a_max, m_min, m_max;   // the least and greatest offsets
};

// Whether a halo holds every row that offset `o` reaches from a box: the
// offset's plane step within the plane halo, and its row step, with the
// carry that x + dx past the grid row adds, within the row halo.
__host__ __device__ inline bool halo_holds(const Halo& h, int o, int s,
                                           int f0) {
  int dz, dy, dx;
  split_nearest(o, s, f0, &dz, &dy, &dx);
  return dz >= -h.z_lo && dz <= h.z_hi && dy - (dx < 0) >= -h.y_lo &&
         dy + (dx > 0) <= h.y_hi;
}

// The distance in a box of `rows` rows a plane to the row at offset o.
__device__ __forceinline__ int box_step(int o, int s, int f0, int rows) {
  int dz, dy, dx;
  split_nearest(o, s, f0, &dz, &dy, &dx);
  return (dz * rows + dy) * f0 + dx;
}

// Whether diagonal k < n exists and its neighbour of frame row q lies
// inside the frame of L rows, as the first design's plane test after
// carries found it.
__device__ __forceinline__ bool in_frame(int k, int n, int q,
                                         const int* off, size_t L) {
  if (k >= n) return false;
  const int r = q + off[k];
  return r >= 0 && static_cast<size_t>(r) < L;
}

// One DIA row sum at point x of a grid row (frame row q0 + x): acc −=
// data[k][i0 + x] · box[x + dist[k]] over the n diagonals in order,
// skipping a neighbour outside the frame of L rows; a diagonal holds ld
// rows of data. Each batch issues its kBatch loads of data together,
// then adds them in order. CHECK false: the caller found every neighbour
// of the row inside the frame, so no point is tested.
template <bool CHECK>
__device__ __forceinline__ float row_sum(
    float acc, int x, int q0, int i0, size_t ld, int n, const int* off,
    const int* dist, size_t L, const float* __restrict__ data,
    const float* box) {
  for (int k0 = 0; k0 < n; k0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      v[b] = (CHECK ? in_frame(k0 + b, n, q0 + x, off, L) : k0 + b < n)
                 ? data[(k0 + b) * ld + i0 + x] : 0.f;
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (CHECK ? in_frame(k0 + b, n, q0 + x, off, L) : k0 + b < n)
        acc -= v[b] * box[x + dist[k0 + b]];
  }
  return acc;
}

// z_off, f_z: the frame (tile plane z is frame plane z + zoff of fz); m, u
// and uc are frames, a, w, f and out the tile's own. Without FRAMED the
// frame is the tile (zoff = 0, fz = f2), known at compile time. Block b
// takes tile (b / nty, b % nty) of ceil(f1 / ty) tiles a plane band; each
// phase walks whole grid rows, a warp a row and a lane an x.
template <bool FRAMED>
__global__ void __launch_bounds__(kUpThreads, 1)
up_kernel(Grid g, int z_off, int f_z, UpTile t, int na, int nm,
          const int* __restrict__ a_off, const float* __restrict__ a,
          const int* __restrict__ m_off, const float* __restrict__ m,
          const float* __restrict__ w, const float* __restrict__ f,
          const float* __restrict__ u, const float* __restrict__ uc,
          float* __restrict__ out) {
  extern __shared__ float s_box[];
  __shared__ int s_a[kMaxDiag], s_ad[kMaxDiag];   // A: offset, U distance
  __shared__ int s_m[kMaxDiag], s_md[kMaxDiag];   // M: offset, T distance
  const int s = g.f1 * g.f0;
  const int BY = t.ty + t.a.y_lo + t.a.y_hi;      // U: BZ planes × BY rows
  const int BZ = t.tz + t.a.z_lo + t.a.z_hi;
  const int TY = BY + t.m.y_lo + t.m.y_hi;        // T: TZ planes × TY rows
  const int TZ = BZ + t.m.z_lo + t.m.z_hi;
  float* s_u = s_box;
  float* s_t = s_box + BZ * BY * g.f0;
  for (int k = threadIdx.x; k < na; k += kUpThreads) {
    s_a[k] = a_off[k];
    s_ad[k] = box_step(s_a[k], s, g.f0, BY);
  }
  for (int k = threadIdx.x; k < nm; k += kUpThreads) {
    s_m[k] = m_off[k];
    s_md[k] = box_step(s_m[k], s, g.f0, TY);
  }

  const int zoff = FRAMED ? z_off : 0;
  const int fz = FRAMED ? f_z : g.f2;
  const size_t Lm = FRAMED ? static_cast<size_t>(fz) * s
                           : static_cast<size_t>(g.n);
  const int nty = (g.f1 + t.ty - 1) / t.ty;
  const int z0 = (blockIdx.x / nty) * t.tz;    // the tile's first plane
  const int y0 = (blockIdx.x % nty) * t.ty;    // ... and row
  const int bz0 = z0 + zoff - t.a.z_lo;        // frame plane of U's plane 0
  const int by0 = y0 - t.a.y_lo;               // extended row of U's row 0
  const int frame_rows = fz * g.f1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int nwarps = kUpThreads / 32;

  // 0. T uc at every T row inside the frame (the rest is never read):
  // fine row (z, y, x) takes the coarse cell (z/2, y/2, x/2)
  for (int r = warp; r < TZ * TY; r += nwarps) {
    const int R = (bz0 - t.m.z_lo + r / TY) * g.f1 + by0 - t.m.y_lo + r % TY;
    float* row = s_t + r * g.f0;
    if (R >= 0 && R < frame_rows) {
      const int qz = R / g.f1;
      const float* cu = uc + ((qz >> 1) * g.c1 + ((R - qz * g.f1) >> 1)) *
                                 g.c0;
#pragma unroll 4
      for (int x = lane; x < g.f0; x += 32) row[x] = cu[x >> 1];
    } else {
      for (int x = lane; x < g.f0; x += 32) row[x] = 0.f;
    }
  }
  __syncthreads();

  // 1. u' = u + T uc − M (T uc) at every U row inside the frame, M's sum
  // in offset order, skipping neighbours outside the frame
  for (int r = warp; r < BZ * BY; r += nwarps) {
    const int bz = r / BY, by = r % BY;
    const int R = (bz0 + bz) * g.f1 + by0 + by;
    float* row = s_u + r * g.f0;
    if (R < 0 || R >= frame_rows) {
      for (int x = lane; x < g.f0; x += 32) row[x] = 0.f;
      continue;
    }
    const float* trow = s_t + ((bz + t.m.z_lo) * TY + by + t.m.y_lo) * g.f0;
    const int q0 = R * g.f0;
    const bool inside = q0 + t.m_min >= 0 &&
                        static_cast<size_t>(q0 + g.f0 - 1 + t.m_max) < Lm;
    for (int x = lane; x < g.f0; x += 32) {
      const float uq = u[q0 + x];
      const float p =
          inside ? row_sum<false>(trow[x], x, q0, q0, Lm, nm, s_m, s_md,
                                      Lm, m, trow)
                 : row_sum<true>(trow[x], x, q0, q0, Lm, nm, s_m, s_md,
                                     Lm, m, trow);
      row[x] = uq + p;
    }
  }
  __syncthreads();

  // 2. out = u' + w ∘ (f − A u') at each tile row, A's sum in offset
  // order, skipping neighbours outside the frame
  for (int r = warp; r < t.tz * t.ty; r += nwarps) {
    const int lz = r / t.ty, ly = r % t.ty;
    const int z = z0 + lz, y = y0 + ly;
    if (z >= g.f2 || y >= g.f1) continue;
    const float* urow = s_u + ((lz + t.a.z_lo) * BY + ly + t.a.y_lo) * g.f0;
    const int i0 = (z * g.f1 + y) * g.f0;
    const int q0 = i0 + zoff * s;              // the frame row of x = 0
    const bool inside = q0 + t.a_min >= 0 &&
                        static_cast<size_t>(q0 + g.f0 - 1 + t.a_max) < Lm;
    for (int x = lane; x < g.f0; x += 32) {
      const float wi = w[i0 + x];
      const float acc =
          inside ? row_sum<false>(f[i0 + x], x, q0, i0, g.n, na, s_a,
                                      s_ad, Lm, a, urow)
                 : row_sum<true>(f[i0 + x], x, q0, i0, g.n, na, s_a,
                                     s_ad, Lm, a, urow);
      out[i0 + x] = urow[x] + wi * acc;
    }
  }
}

Grid make_grid(int f2, int f1, int f0) {
  Grid g;
  g.f2 = f2; g.f1 = f1; g.f0 = f0;
  g.c1 = (f1 + 1) / 2; g.c0 = (f0 + 1) / 2;
  g.n = f2 * f1 * f0;
  return g;
}

}  // namespace
}  // namespace amgcl_port

// Down leg on the tile of fine dims (f2, f1, f0), n rows, inside a frame of
// L rows at offset H (base mode: H = 0, L = n). a/mt: (na, L) and (nm, L)
// float32 DIA data with int32 offsets; f, u: (L,); with zero_guess != 0, u
// is the smoother scale w and u_out (n,) receives w ∘ f. rc: (nc,) with
// nc = ceil(f2/2)·ceil(f1/2)·ceil(f0/2). The caller guarantees L < 2^30,
// na, nm ≤ 512 and, in a frame, an even f2 and H at least the reach of A
// plus that of Mᵀ. Returns the launch's cudaError_t.
extern "C" int amgcl_fused_down(int zero_guess, int f2, int f1, int f0,
                                int H, int L, int na, int nm,
                                const void* a_off, const void* a,
                                const void* m_off, const void* mt,
                                const void* f, const void* u, void* u_out,
                                void* rc, void* stream) {
  using namespace amgcl_port;
  if (na > kMaxDiag || nm > kMaxDiag) return cudaErrorInvalidValue;
  const Grid g = make_grid(f2, f1, f0);
  const int nc = ((f2 + 1) / 2) * g.c1 * g.c0;
  const int blocks = (nc + kCells - 1) / kCells;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ao = static_cast<const int*>(a_off);
  const int* mo = static_cast<const int*>(m_off);
  const float* ad = static_cast<const float*>(a);
  const float* md = static_cast<const float*>(mt);
  const float* fv = static_cast<const float*>(f);
  const float* uv = static_cast<const float*>(u);
  float* uo = static_cast<float*>(u_out);
  float* out = static_cast<float*>(rc);
  const bool framed = H != 0 || L != g.n;
  if (zero_guess && framed)
    down_kernel<true, true><<<blocks, kBlock, 0, s>>>(
        g, H, L, nc, na, nm, ao, ad, mo, md, fv, uv, uo, out);
  else if (zero_guess)
    down_kernel<true, false><<<blocks, kBlock, 0, s>>>(
        g, H, L, nc, na, nm, ao, ad, mo, md, fv, uv, uo, out);
  else if (framed)
    down_kernel<false, true><<<blocks, kBlock, 0, s>>>(
        g, H, L, nc, na, nm, ao, ad, mo, md, fv, uv, uo, out);
  else
    down_kernel<false, false><<<blocks, kBlock, 0, s>>>(
        g, H, L, nc, na, nm, ao, ad, mo, md, fv, uv, uo, out);
  return cudaGetLastError();
}

// Up leg on the tile of fine dims (f2, f1, f0), n rows, inside a frame of
// fz fine planes at plane offset zoff (base mode: zoff = 0, fz = f2).
// a: (na, n) and m: (nm, fz·f1·f0) float32 DIA data with int32 offsets
// a_off and m_off on the device, and a_host and m_host the same offsets
// on the host; w, f, out: (n,); u: (fz·f1·f0,); uc: the coarse vector of
// the frame, ceil(fz/2) coarse planes. Blocks of kUpThreads threads take
// tiles of tz planes × ty rows; `halos` holds A's halo
// and then M's (planes below, above, rows before, after: UpTile). The
// call is refused if an A offset reaches outside U, an M offset outside
// T, or the two boxes pass kUpMaxBox bytes. The caller guarantees
// fz·f1·f0 < 2^30, na, nm ≤ 512 and, in a frame, an even zoff and f2 and
// zoff · f1 · f0 at least the reach of A plus that of M.
extern "C" int amgcl_fused_up(int f2, int f1, int f0, int zoff, int fz,
                              int na, int nm, const int* a_host,
                              const int* m_host, int tz, int ty,
                              const int* halos,
                              const void* a_off, const void* a,
                              const void* m_off, const void* m,
                              const void* w, const void* f, const void* u,
                              const void* uc, void* out, void* stream) {
  using namespace amgcl_port;
  if (na < 1 || na > kMaxDiag || nm < 1 || nm > kMaxDiag || tz < 1 ||
      ty < 1)
    return cudaErrorInvalidValue;

  for (int k = 0; k < 8; ++k)
    if (halos[k] < 0) return cudaErrorInvalidValue;
  const Grid g = make_grid(f2, f1, f0);
  UpTile t{tz, ty, {halos[0], halos[1], halos[2], halos[3]},
           {halos[4], halos[5], halos[6], halos[7]},
           a_host[0], a_host[0], m_host[0], m_host[0]};
  for (int k = 0; k < na; ++k) {
    if (!halo_holds(t.a, a_host[k], f1 * f0, f0)) return cudaErrorInvalidValue;
    if (a_host[k] < t.a_min) t.a_min = a_host[k];
    if (a_host[k] > t.a_max) t.a_max = a_host[k];
  }
  for (int k = 0; k < nm; ++k) {
    if (!halo_holds(t.m, m_host[k], f1 * f0, f0)) return cudaErrorInvalidValue;
    if (m_host[k] < t.m_min) t.m_min = m_host[k];
    if (m_host[k] > t.m_max) t.m_max = m_host[k];
  }
  const long long bz = tz + t.a.z_lo + t.a.z_hi, by = ty + t.a.y_lo + t.a.y_hi;
  const long long box =
      (bz * by + (bz + t.m.z_lo + t.m.z_hi) * (by + t.m.y_lo + t.m.y_hi)) *
      f0 * static_cast<long long>(sizeof(float));
  if (box > kUpMaxBox) return cudaErrorInvalidValue;
  const bool framed = zoff != 0 || fz != f2;
  auto kernel = framed ? up_kernel<true> : up_kernel<false>;
  // static and dynamic shared memory above 48 KB only by the attribute,
  // set once per instantiation and device
  static bool raised[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev >= kMaxDevices || !raised[framed][dev]) {
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kUpMaxBox);
    if (rc != cudaSuccess) return rc;
    if (dev < kMaxDevices) raised[framed][dev] = true;
  }
  const int blocks = ((f2 + tz - 1) / tz) * ((f1 + ty - 1) / ty);
  kernel<<<blocks, kUpThreads, static_cast<size_t>(box),
           static_cast<cudaStream_t>(stream)>>>(
      g, zoff, fz, t, na, nm, static_cast<const int*>(a_off),
      static_cast<const float*>(a), static_cast<const int*>(m_off),
      static_cast<const float*>(m), static_cast<const float*>(w),
      static_cast<const float*>(f), static_cast<const float*>(u),
      static_cast<const float*>(uc), static_cast<float*>(out));
  return cudaGetLastError();
}
