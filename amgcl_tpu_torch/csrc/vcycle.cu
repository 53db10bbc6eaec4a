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
// Design (simple and right first). The TPU kernel DMAs a window of
// 2s + 2H floats per operand into VMEM for each coarse plane (s = one
// fine plane); at the 128³ fine level that is 384 KB per operand, more
// than a block's 227 KB of shared memory for all of them together. Here
// nothing is staged:
//   down: one thread per fine row of a block of 32 consecutive coarse
//         cells × their 8 children. Each thread computes t = r − Mᵀ r at
//         its row, recomputing r = f − A u at the row and at each of its
//         Mᵀ neighbours from A, u and f read through L1/L2. The 8 values
//         of a cell meet in shared memory and one thread per cell sums
//         them in a fixed order: no float atomics, so the same inputs give
//         bit-identical results on every run.
//   up:   one thread per fine row. It recomputes u' at the row and at
//         each of its A neighbours from u, M and uc; a neighbour's grid
//         coordinates come from the row's own by adding the offset's
//         (dz, dy, dx) decomposition with carries, so the coarse cell of
//         each T uc term needs no division.
// Every index is guarded: r, u and T uc are 0 outside the frame below
// ([0, n) in the base mode), as the TPU kernel's zero-padded frames make
// them, and a flat offset that runs off one grid row into the next reads
// that row (its DIA entry is 0 on a stencil). The redundant neighbour
// recomputation — (1 + nM) residuals per fine row down, (1 + nA)
// corrections up — is what a later PR removes, by staging a (z-pair ×
// y-strip) tile of r or u' in shared memory with cp.async/TMA.
//
// Framed mode (a z-slab of a grid sharded over a mesh, framed by real rows
// of its neighbour slabs; pallas_vcycle.py:187-194 and :477-483). Down:
// A, Mᵀ, f and u (or w) are frames of L rows in which tile row i is frame
// row H + i. Up: M, u and T uc live on a frame of fz fine planes in which
// tile plane z is frame plane z + zoff (zoff even, uc carrying zoff / 2
// coarse planes on each side); A, f, w and the output are the tile's own.
// Every index guard below is "inside the frame", so r, u' and T uc read 0
// only outside it. The base mode is the framed mode on a zero frame
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

// Flat offset o split as o = dz·s + dy·f0 + dx with |dx| < f0, |dy| < f1
// (truncating division), so one carry per axis normalises a neighbour.
__device__ __forceinline__ void split_offset(int o, int s, int f0, int* dz,
                                             int* dy, int* dx) {
  *dz = o / s;
  const int rem = o - *dz * s;
  *dy = rem / f0;
  *dx = rem - *dy * f0;
}

// Frame coordinates of the row `o` away from frame point (z, y, x); false
// when that row lies outside the frame's fz planes.
__device__ __forceinline__ bool step(const Grid& g, int fz, int z, int y,
                                     int x, int dz, int dy, int dx, int* qz,
                                     int* qy, int* qx) {
  int xx = x + dx, yy = y + dy, zz = z + dz;
  if (xx < 0) { xx += g.f0; --yy; } else if (xx >= g.f0) { xx -= g.f0; ++yy; }
  if (yy < 0) { yy += g.f1; --zz; } else if (yy >= g.f1) { yy -= g.f1; ++zz; }
  *qz = zz; *qy = yy; *qx = xx;
  return zz >= 0 && zz < fz;
}

__device__ __forceinline__ float tuc_at(const Grid& g, int z, int y, int x,
                                        const float* __restrict__ uc) {
  return uc[((z >> 1) * g.c1 + (y >> 1)) * g.c0 + (x >> 1)];
}

// u' = u[j] + (T uc)[j] − Σ_k M[k, j] (T uc)[j + off_k] at frame row j,
// frame point (z, y, x), of a frame of fz planes (Lm = fz · f1 · f0 rows).
__device__ __forceinline__ float corrected_at(
    const Grid& g, int fz, size_t Lm, int j, int z, int y, int x, int nm,
    const int* s_mz, const int* s_my, const int* s_mx,
    const float* __restrict__ m, const float* __restrict__ u,
    const float* __restrict__ uc) {
  float p = tuc_at(g, z, y, x, uc);
  for (int k = 0; k < nm; ++k) {
    int qz, qy, qx;
    if (step(g, fz, z, y, x, s_mz[k], s_my[k], s_mx[k], &qz, &qy, &qx))
      p -= m[k * Lm + j] * tuc_at(g, qz, qy, qx, uc);
  }
  return u[j] + p;
}

// z_off, f_z: the frame (tile plane z is frame plane z + zoff of fz); m, u
// and uc are frames, a, w, f and out the tile's own. Without FRAMED the
// frame is the tile (zoff = 0, fz = f2), known at compile time.
template <bool FRAMED>
__global__ void __launch_bounds__(kBlock)
up_kernel(Grid g, int z_off, int f_z, int na, int nm,
          const int* __restrict__ a_off, const float* __restrict__ a,
          const int* __restrict__ m_off, const float* __restrict__ m,
          const float* __restrict__ w, const float* __restrict__ f,
          const float* __restrict__ u, const float* __restrict__ uc,
          float* __restrict__ out) {
  __shared__ int s_a[kMaxDiag], s_az[kMaxDiag], s_ay[kMaxDiag],
      s_ax[kMaxDiag];
  __shared__ int s_mz[kMaxDiag], s_my[kMaxDiag], s_mx[kMaxDiag];
  const int s = g.f1 * g.f0;
  for (int k = threadIdx.x; k < na; k += kBlock) {
    s_a[k] = a_off[k];
    split_offset(s_a[k], s, g.f0, &s_az[k], &s_ay[k], &s_ax[k]);
  }
  for (int k = threadIdx.x; k < nm; k += kBlock)
    split_offset(m_off[k], s, g.f0, &s_mz[k], &s_my[k], &s_mx[k]);
  __syncthreads();

  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.n) return;
  const int z = i / s;
  const int y = (i - z * s) / g.f0;
  const int x = i - z * s - y * g.f0;
  const int zoff = FRAMED ? z_off : 0;
  const int fz = FRAMED ? f_z : g.f2;
  const size_t Lm = FRAMED ? static_cast<size_t>(fz) * s
                           : static_cast<size_t>(g.n);
  const int zf = z + zoff;                     // the frame plane
  const int j = i + zoff * s;                  // the frame row
  const float ui = corrected_at(g, fz, Lm, j, zf, y, x, nm, s_mz, s_my, s_mx,
                                m, u, uc);
  float acc = f[i];
  for (int l = 0; l < na; ++l) {
    int qz, qy, qx;
    if (!step(g, fz, zf, y, x, s_az[l], s_ay[l], s_ax[l], &qz, &qy, &qx))
      continue;
    const int q = j + s_a[l];
    const float uq = q == j ? ui
        : corrected_at(g, fz, Lm, q, qz, qy, qx, nm, s_mz, s_my, s_mx, m, u,
                       uc);
    acc -= a[static_cast<size_t>(l) * g.n + i] * uq;
  }
  out[i] = ui + w[i] * acc;
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
// a: (na, n) and m: (nm, fz·f1·f0) float32 DIA data with int32 offsets;
// w, f, out: (n,); u: (fz·f1·f0,); uc: the coarse vector of the frame,
// ceil(fz/2) coarse planes. The caller guarantees fz·f1·f0 < 2^30, na,
// nm ≤ 512 and, in a frame, an even zoff and f2 and zoff · f1 · f0 at
// least the reach of A plus that of M.
extern "C" int amgcl_fused_up(int f2, int f1, int f0, int zoff, int fz,
                              int na, int nm, const void* a_off,
                              const void* a, const void* m_off, const void* m,
                              const void* w, const void* f, const void* u,
                              const void* uc, void* out, void* stream) {
  using namespace amgcl_port;
  if (na > kMaxDiag || nm > kMaxDiag) return cudaErrorInvalidValue;
  const Grid g = make_grid(f2, f1, f0);
  const int blocks = (g.n + kBlock - 1) / kBlock;
  auto kernel = zoff != 0 || fz != f2 ? up_kernel<true> : up_kernel<false>;
  kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      g, zoff, fz, na, nm, static_cast<const int*>(a_off),
      static_cast<const float*>(a), static_cast<const int*>(m_off),
      static_cast<const float*>(m), static_cast<const float*>(w),
      static_cast<const float*>(f), static_cast<const float*>(u),
      static_cast<const float*>(uc), static_cast<float*>(out));
  return cudaGetLastError();
}
