// X-pencil cutoff forces (the paper's §5.2 schedule) in float32: the dense
// kernel B, the occupancy-compacted kernel C and the packed-row kernel D.
//
// Replaces, in src/repro/kernels/xpencil.py:
//   B  xpencil_forces         (Pallas grid (nz, ny, 9): one program per
//                              target pencil, 9 neighbour rows through VMEM)
//   C  xpencil_sparse_forces  (grid (max_active, 9) over a scalar-prefetched
//                              list of active pencils)
//   D  xpencil_packed_forces  (grid (n_rows, 9) over packed CSR rows; each
//                              target's 3-cell window from the row offsets)
//
// What bounds them on the card: operations. B and C evaluate every dense
// slot pair of each target's 3*m_c window (9 * 3 * m_c candidates per
// target slot), of which only the pairs of real particles within the cutoff
// do work; at 4 particles per cell and m_c = 24 that is about 3% of the
// evaluated pairs. D visits only the real sources of each window, about
// 9 * 12 per particle at 4 per cell, so its work follows the particles. The
// bytes (rows read once, outputs written once) would take far less time
// than the pair arithmetic. Staging with TMA, double buffering and load
// balancing are later work.
//
// B and C (one kernel, xpencil_kernel): one block per (pencil row, x-chunk
// of CX cells). The row is blockIdx.x itself (B) or act[blockIdx.x] (C: the
// block loads its own id; Hopper has no scalar prefetch), mapped to the
// padded pencil (z + 1, y + 1); C's output row is the list position, so
// padding entries (pencil 0) recompute pencil 0 as on the TPU. For each of
// the 9 neighbour rows in the order k = 0..8 (dz = k/3 - 1, dy = k%3 - 1,
// the TPU index map (z + k//3, y + k%3)) the block stages the row's
// (CX+2)*m_c slots of x, y, z, id in shared memory; each thread owns one
// target slot, keeps it in registers and scans its contiguous 3*m_c window.
//
// D (xpencil_packed_kernel): one thread per packed target slot, one block
// per (row, tile of <= 256 slots), so row_cap is not limited to one block.
// Per neighbour row the block stages the row's real particles (at most
// row_cap of x, y, z, id) in shared memory; each thread reads its cell's
// window [off[c-1], off[c+2]) from the row's offsets (c = its slot cell
// clamped to [1, nx]) and visits only those sources, in ascending order.
//
// One accumulation step (pair_step, in pair.cuh, shared with kernel E)
// serves all three, so the compiler rounds and fuses each pair term the same
// way in each kernel. Each neighbour row is summed into its own partial,
// then added to the accumulator. A dense window's empty slots add exactly
// +-0 to a partial that starts at +0, so D's per-particle result equals B's
// and C's value for value without visiting them. Outputs are written once at
// the end: no atomics, nothing carried between blocks.

#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

using namespace pair_kernels;

constexpr int kMaxThreads = 1024;
constexpr int kTargetThreads = 256;
constexpr int kPackedThreads = 256;

// Kernels B (act == nullptr: row r is pencil r) and C (row r is pencil
// act[r]). Grid (n_rows, x-chunks).
template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
xpencil_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ z, const int* __restrict__ sid,
               const int* __restrict__ act, float* __restrict__ fx,
               float* __restrict__ fy, float* __restrict__ fz,
               float* __restrict__ pot, int nx, int ny, int m_c, int cx_cells,
               float cutoff2, PairParams prm) {
  extern __shared__ float stage[];
  const int stage_len = (cx_cells + 2) * m_c;
  float* sx = stage;
  float* sy = sx + stage_len;
  float* sz = sy + stage_len;
  int* ss = reinterpret_cast<int*>(sz + stage_len);

  const int row_out = blockIdx.x;
  const int zy = act ? act[row_out] : row_out;
  const int zz = zy / ny, yy = zy - (zy / ny) * ny;
  const int x0 = blockIdx.y * cx_cells;
  const int cx = min(cx_cells, nx - x0);
  const long long row_len = (long long)(nx + 2) * m_c;
  const int t = threadIdx.x;
  const int cell = t / m_c;
  const int slot = t - cell * m_c;
  const bool active = t < cx * m_c;

  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  int tid = -1;
  if (active) {
    const long long ti = ((long long)(zz + 1) * (ny + 2) + (yy + 1)) * row_len
                         + (long long)(x0 + 1 + cell) * m_c + slot;
    tx = x[ti];
    ty = y[ti];
    tz = z[ti];
    tid = sid[ti];
  }
  const bool work = active && tid >= 0;

  float ax = 0.0f, ay = 0.0f, az = 0.0f, ap = 0.0f;
  const int n_stage = (cx + 2) * m_c;
  const int w0 = cell * m_c;  // window of target cell x0+cell: stage cells
                              // cell, cell+1, cell+2
  for (int k = 0; k < 9; ++k) {
    const int dz = k / 3 - 1, dy = k % 3 - 1;
    const long long row =
        ((long long)(zz + 1 + dz) * (ny + 2) + (yy + 1 + dy)) * row_len
        + (long long)x0 * m_c;
    __syncthreads();  // the previous row is no longer read
    for (int i = t; i < n_stage; i += blockDim.x) {
      sx[i] = x[row + i];
      sy[i] = y[row + i];
      sz[i] = z[row + i];
      ss[i] = sid[row + i];
    }
    __syncthreads();
    if (work) {
      float px = 0.0f, py = 0.0f, pz = 0.0f, pp = 0.0f;
      for (int j = w0; j < w0 + 3 * m_c; ++j)
        pair_step<KIND>(tx, ty, tz, tid, sx[j], sy[j], sz[j], ss[j], cutoff2,
                        prm, px, py, pz, pp);
      ax += px;
      ay += py;
      az += pz;
      ap += pp;
    }
  }
  if (active) {
    const long long o = (long long)row_out * nx * m_c
                        + (long long)(x0 + cell) * m_c + slot;
    fx[o] = ax;
    fy[o] = ay;
    fz[o] = az;
    pot[o] = ap;
  }
}

// Kernel D over packed rows of row_cap slots (act == nullptr: row r is
// pencil r; else row r is pencil act[r]). Grid (n_rows, slot tiles).
template <int KIND>
__global__ void __launch_bounds__(kPackedThreads)
xpencil_packed_kernel(const float* __restrict__ x,
                      const float* __restrict__ y,
                      const float* __restrict__ z,
                      const int* __restrict__ sid,
                      const int* __restrict__ scell,
                      const int* __restrict__ off,
                      const int* __restrict__ act, float* __restrict__ fx,
                      float* __restrict__ fy, float* __restrict__ fz,
                      float* __restrict__ pot, int nx, int ny, int row_cap,
                      float cutoff2, PairParams prm) {
  extern __shared__ float stage[];
  float* sx = stage;
  float* sy = sx + row_cap;
  float* sz = sy + row_cap;
  int* ss = reinterpret_cast<int*>(sz + row_cap);

  const int a = blockIdx.x;
  const int zy = act ? act[a] : a;
  const int zz = zy / ny, yy = zy - (zy / ny) * ny;
  const int nyp = ny + 2, n_off = nx + 3;
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = t < row_cap;

  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  int tid = -1, tcell = 1;
  if (active) {
    const long long ti = ((long long)(zz + 1) * nyp + (yy + 1)) * row_cap + t;
    tx = x[ti];
    ty = y[ti];
    tz = z[ti];
    tid = sid[ti];
    tcell = min(max(scell[ti], 1), nx);
  }
  const bool work = active && tid >= 0;

  float ax = 0.0f, ay = 0.0f, az = 0.0f, ap = 0.0f;
  for (int k = 0; k < 9; ++k) {
    const int dz = k / 3 - 1, dy = k % 3 - 1;
    const long long srow = (long long)(zz + 1 + dz) * nyp + (yy + 1 + dy);
    const int* so = off + srow * n_off;
    const long long base = srow * row_cap;
    // the row's real particles: offsets of an overflowed row run past
    // row_cap, whose slots hold only the first row_cap of them
    const int n_real = min(so[nx + 2], row_cap);
    __syncthreads();  // the previous row is no longer read
    for (int i = threadIdx.x; i < n_real; i += blockDim.x) {
      sx[i] = x[base + i];
      sy[i] = y[base + i];
      sz[i] = z[base + i];
      ss[i] = sid[base + i];
    }
    __syncthreads();
    if (work) {
      const int lo = min(so[tcell - 1], n_real);
      const int hi = min(so[tcell + 2], n_real);
      float px = 0.0f, py = 0.0f, pz = 0.0f, pp = 0.0f;
      for (int j = lo; j < hi; ++j)
        pair_step<KIND>(tx, ty, tz, tid, sx[j], sy[j], sz[j], ss[j], cutoff2,
                        prm, px, py, pz, pp);
      ax += px;
      ay += py;
      az += pz;
      ap += pp;
    }
  }
  if (active) {
    const long long o = (long long)a * row_cap + t;
    fx[o] = ax;
    fy[o] = ay;
    fz[o] = az;
    pot[o] = ap;
  }
}

cudaError_t launch_pencils(const void* x, const void* y, const void* z,
                           const void* slot_id, const int* act, void* fx,
                           void* fy, void* fz, void* pot, int n_rows, int nx,
                           int ny, int m_c, float cutoff2, int kind,
                           PairParams prm, void* stream) {
  if (n_rows == 0) return cudaSuccess;
  int cx_cells = kTargetThreads / m_c;
  if (cx_cells < 1) cx_cells = 1;
  if (cx_cells > nx) cx_cells = nx;
  const int threads = (cx_cells * m_c + 31) / 32 * 32;
  const size_t smem = (size_t)16 * (cx_cells + 2) * m_c;
  const dim3 grid(n_rows, (nx + cx_cells - 1) / cx_cells);
  return by_kind(kind, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const cudaError_t err = allow_smem(xpencil_kernel<K>, smem);
    if (err != cudaSuccess) return err;
    xpencil_kernel<K><<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(z), static_cast<const int*>(slot_id), act,
        static_cast<float*>(fx), static_cast<float*>(fy),
        static_cast<float*>(fz), static_cast<float*>(pot), nx, ny, m_c,
        cx_cells, cutoff2, prm);
    return cudaGetLastError();
  });
}

}  // namespace

// Kernel B. Planes x, y, z (float32) and slot_id (int32) of shape
// (nz+2, ny+2, (nx+2)*m_c), contiguous; outputs fx, fy, fz, pot (float32)
// of shape (nz, ny, nx*m_c). m_c <= 1024 (one thread per target slot).
// Allocates nothing and does not synchronise; returns the launch's
// cudaError_t.
extern "C" int xpencil_forces_f32(const void* x, const void* y, const void* z,
                                  const void* slot_id, void* fx, void* fy,
                                  void* fz, void* pot, int nx, int ny, int nz,
                                  int m_c, float cutoff2, int kind, float p0,
                                  float p1, float p2, float p3, int n_extra,
                                  void* stream) {
  if (m_c < 1 || m_c > kMaxThreads || nx < 1 || ny < 1 || nz < 1)
    return cudaErrorInvalidValue;
  return launch_pencils(x, y, z, slot_id, nullptr, fx, fy, fz, pot, ny * nz,
                        nx, ny, m_c, cutoff2, kind,
                        PairParams{p0, p1, p2, p3, n_extra}, stream);
}

// Kernel C. Planes as for kernel B; active (int32, n_rows) holds interior
// pencil ids z*ny + y in [0, nz*ny); outputs of shape (n_rows, nx*m_c), row a
// for pencil active[a].
extern "C" int xpencil_sparse_f32(const void* x, const void* y, const void* z,
                                  const void* slot_id, const void* active,
                                  void* fx, void* fy, void* fz, void* pot,
                                  int n_rows, int nx, int ny, int nz, int m_c,
                                  float cutoff2, int kind, float p0, float p1,
                                  float p2, float p3, int n_extra,
                                  void* stream) {
  if (m_c < 1 || m_c > kMaxThreads || nx < 1 || ny < 1 || nz < 1 ||
      n_rows < 0)
    return cudaErrorInvalidValue;
  return launch_pencils(x, y, z, slot_id, static_cast<const int*>(active), fx,
                        fy, fz, pot, n_rows, nx, ny, m_c, cutoff2, kind,
                        PairParams{p0, p1, p2, p3, n_extra}, stream);
}

// Kernel D. Packed planes x, y, z (float32), slot_id and slot_cell (int32)
// of shape (nz+2, ny+2, row_cap), cell_offsets (int32) of shape
// (nz+2, ny+2, nx+3), active (int32, n_rows) interior pencil ids or NULL for
// every pencil in id order (n_rows = nz*ny); outputs of shape (n_rows,
// row_cap). Needs 16*row_cap bytes of shared memory, at most 227 KB.
extern "C" int xpencil_packed_f32(const void* x, const void* y, const void* z,
                                  const void* slot_id, const void* slot_cell,
                                  const void* cell_offsets, const void* active,
                                  void* fx, void* fy, void* fz, void* pot,
                                  int n_rows, int nx, int ny, int nz,
                                  int row_cap, float cutoff2, int kind,
                                  float p0, float p1, float p2, float p3,
                                  int n_extra, void* stream) {
  if (row_cap < 1 || nx < 1 || ny < 1 || nz < 1 || n_rows < 0 ||
      (active == nullptr && n_rows != nz * ny))
    return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  const PairParams prm{p0, p1, p2, p3, n_extra};
  const int threads =
      row_cap < kPackedThreads ? (row_cap + 31) / 32 * 32 : kPackedThreads;
  const size_t smem = (size_t)16 * row_cap;
  const dim3 grid(n_rows, (row_cap + threads - 1) / threads);
  return by_kind(kind, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const cudaError_t err = allow_smem(xpencil_packed_kernel<K>, smem);
    if (err != cudaSuccess) return err;
    xpencil_packed_kernel<K><<<grid, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(z), static_cast<const int*>(slot_id),
        static_cast<const int*>(slot_cell),
        static_cast<const int*>(cell_offsets),
        static_cast<const int*>(active), static_cast<float*>(fx),
        static_cast<float*>(fy), static_cast<float*>(fz),
        static_cast<float*>(pot), nx, ny, row_cap, cutoff2, prm);
    return cudaGetLastError();
  });
}
