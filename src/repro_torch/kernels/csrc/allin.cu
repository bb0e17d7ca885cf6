// All-in-SM cutoff forces (the paper's §5.1 schedule) in float32: kernel E.
//
// Replaces src/repro/kernels/allin.py::allin_forces (Pallas grid
// (gz, gy, gx): one program per sub-box, the overlapping halo block copied
// from HBM into VMEM scratch by explicit DMA, then 9 windowed row
// reductions over every slot of the block, empty slots included).
//
// Design: one block per sub-box of (bx, by, bz) cells, on a flat grid of
// gx*gy*gz blocks (sub-box b = iz*(gy*gx) + iy*gx + ix), of the threads the
// caller gives (kernels/allin.py::allin_threads: 512 where the halo leaves
// room for two blocks an SM, 1024 where it leaves one).
//   1. The block stages the overlapping halo block, (bz+2)*(by+2) rows of
//      bx+2 cells from the padded planes at origin (iz*bz, iy*by,
//      ix*bx*m_c), the slice of JAX's dynamic_slice, into dynamic shared
//      memory: each warp takes an equal share of the halo's cells and
//      compacts each cell while it loads it (stage in cells.cuh: read
//      slot_id, 4 slots a lane where m_c % 4 == 0, rank the real ones by a
//      warp ballot or scan, write only their x, y, z, id, in slot order,
//      then a terminator). A cell keeps its m_c slots, so the block needs
//      halo_bytes, no more; one block barrier follows.
//   2. Each warp takes a contiguous range of the interior's target slots,
//      reads their slot_id from the planes (coalesced; the 0s of the empty
//      ones are written in the same pass) and packs the real targets into
//      its lanes, one each (__ballot_sync, nth_set_bit), computing a batch
//      whenever all 32 lanes hold one, and once more at the end.
//   3. A target visits the 9 neighbour rows in kernel B's order, k = 0..8
//      with dz = k/3 - 1 and dy = k%3 - 1; in each, the real sources of its
//      three cells, ascending, into the row's partial (visit_cell), which is
//      added to its sum. Outputs go straight to (nz, ny, nx*m_c).
// With this order and the one pair_step (pair.cuh), kernel E gives kernel
// B's bits per target, whatever the box and the thread count.
//
// Stacked systems (InteractionPlan.execute_batch): n_sys systems whose
// planes and outputs follow one another, launched once for all, the grid's
// y index the system; a block offsets its pointers to its system first, so
// its halo reads only that system's ghost ring.
//
// What bounds it on the card: the staging and the few blocks the halo
// leaves an SM. E reads each halo slot once per sub-box (216 cells for 64
// targets at box (4, 4, 4)); its pair work is B's, the real sources of
// each target's 27 cells. The halo is 16 * (bz+2)(by+2)(bx+2) * m_c bytes
// (82,944 B at m_c = 24; 138,240 B at m_c = 40), so an SM holds two blocks,
// or one, and a block's staging and arithmetic do not overlap within it:
// the paper's verdict on All-in-SM. The thread count follows the blocks an
// SM holds: with two, 1024 threads would need all 64K registers of the SM
// for one block. chip_smoke.py times E at 256, 512 and 1024 threads on
// each of its scenes (PERF.md, PR 18).

#include <cuda_runtime.h>

#include <cstdint>

#include "cells.cuh"

namespace {

using namespace pair_kernels;

constexpr int kAllinMaxThreads = 1024;

template <int KIND>
__global__ void __launch_bounds__(kAllinMaxThreads)
allin_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ z, const int* __restrict__ sid,
             float* __restrict__ fx, float* __restrict__ fy,
             float* __restrict__ fz, float* __restrict__ pot,
             unsigned long long* __restrict__ visits, int nx, int ny,
             int nz, int m_c, int bx, int by, int bz, bool vec,
             float cutoff2, PairParams prm) {
  extern __shared__ float4 halo[];      // (bz+2)(by+2)(bx+2) cells of m_c
  {  // the block's system: its planes and outputs
    const long long sys = blockIdx.y;
    const long long planes =
        sys * (nz + 2) * (ny + 2) * (long long)(nx + 2) * m_c;
    const long long outs = sys * nz * ny * (long long)nx * m_c;
    x += planes;
    y += planes;
    z += planes;
    sid += planes;
    fx += outs;
    fy += outs;
    fz += outs;
    pot += outs;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int hc = bx + 2;                // halo cells a row
  const int gx = nx / bx, gy = ny / by;
  const int b = blockIdx.x;
  const int ix = b % gx, iy = (b / gx) % gy, iz = b / (gx * gy);
  const int z0 = iz * bz, y0 = iy * by;
  const long long row_len = (long long)(nx + 2) * m_c;
  const long long col0 = (long long)ix * bx * m_c;

  // 1. the halo block, each cell compacted while it loads: warp w takes
  // an equal, contiguous share of the halo's cells (in row order)
  const int n_cells = (bz + 2) * (by + 2) * hc;
  const int share = (n_cells + n_warps - 1) / n_warps;
  const int h0 = min(warp * share, n_cells);
  stage(
      vec, min(share, n_cells - h0), m_c,
      [&](int c) {
        const int row = (h0 + c) / hc, col = h0 + c - row * hc;
        const int hzr = row / (by + 2), hyr = row - hzr * (by + 2);
        return ((long long)(z0 + hzr) * (ny + 2) + (y0 + hyr)) * row_len +
               col0 + (long long)col * m_c;
      },
      x, y, z, sid, halo + (size_t)h0 * m_c);
  __syncthreads();

  // 2. this warp's range of interior target slots, packed into lanes
  const int tw = bx * m_c;              // target slots of an interior row
  const int n_t = bz * by * tw;
  const int per = (n_t + 32 * n_warps - 1) / (32 * n_warps) * 32;
  const int lo = min(warp * per, n_t), hi = min(lo + per, n_t);
  const long long out_row = (long long)nx * m_c;
  auto slot = [&](int t, long long& g, long long& o) {  // -> target cell
    const int rr = t / tw, c = t - rr * tw;
    const int tz = rr / by, ty = rr - tz * by;
    g = ((long long)(z0 + tz + 1) * (ny + 2) + (y0 + ty + 1)) * row_len +
        col0 + m_c + c;
    o = ((long long)(z0 + tz) * ny + (y0 + ty)) * out_row + col0 + c;
    return (tz * (by + 2) + ty) * hc + c / m_c;  // cell to its lower left
  };
  unsigned long long n_visits = 0;
  // 3. the lane's target (mine >= 0) against its 9 rows of three cells
  auto compute = [&](int mine) {
    if (mine < 0) return;
    long long g, o;
    const int w = slot(mine, g, o);
    const float tx = x[g], ty = y[g], tz = z[g];
    const int tid = sid[g];
    float ax = 0.0f, ay = 0.0f, az = 0.0f, ap = 0.0f;
    for (int k = 0; k < 9; ++k) {
      const float4* row = halo + (size_t)(w + (k / 3) * (by + 2) * hc +
                                          (k % 3) * hc) * m_c;
      float px = 0.0f, py = 0.0f, pz = 0.0f, pp = 0.0f;
      for (int cc = 0; cc < 3; ++cc)
        n_visits += visit_cell<KIND>(row + cc * m_c, m_c, tx, ty, tz, tid,
                                     cutoff2, prm, px, py, pz, pp);
      ax += px;
      ay += py;
      az += pz;
      ap += pp;
    }
    fx[o] = ax;
    fy[o] = ay;
    fz[o] = az;
    pot[o] = ap;
  };
  int fill = 0, mine = -1;
  for (int t0 = lo; t0 < hi; t0 += 32) {
    const int t = t0 + lane;
    bool kept = false;
    if (t < hi) {
      long long g, o;
      slot(t, g, o);
      kept = sid[g] >= 0;
      if (!kept) {
        fx[o] = 0.0f;
        fy[o] = 0.0f;
        fz[o] = 0.0f;
        pot[o] = 0.0f;
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, kept);
    const int n_kept = __popc(mask);
    for (int taken = 0; taken < n_kept;) {
      const int take = min(n_kept - taken, 32 - fill);
      if (lane >= fill && lane < fill + take)
        mine = t0 + nth_set_bit(mask, taken + lane - fill);
      fill += take;
      taken += take;
      if (fill == 32) {
        compute(mine);
        fill = 0;
        mine = -1;
      }
    }
  }
  if (fill > 0) compute(mine);
  add_visits(visits, n_visits);
}

}  // namespace

// Kernel E. Planes x, y, z (float32) and slot_id (int32) of shape
// (n_sys, nz+2, ny+2, (nx+2)*m_c), contiguous, 1 <= n_sys <= 65535; the
// sub-box (bx, by, bz) divides (nx, ny, nz); outputs fx, fy, fz, pot
// (float32) of shape (n_sys, nz, ny, nx*m_c).
// threads: a block's, a multiple of 32 up to 1024 (fewer if the sub-box has
// fewer target slots). Needs 16*(bz+2)*(by+2)*(bx+2)*m_c bytes of shared
// memory, at most 227 KB. visits (uint64, or NULL): adds the number of pair
// steps taken. Allocates nothing and does not synchronise; returns the
// launch's cudaError_t.
extern "C" int allin_forces_f32(const void* x, const void* y, const void* z,
                                const void* slot_id, void* fx, void* fy,
                                void* fz, void* pot, void* visits, int n_sys,
                                int nx, int ny, int nz, int m_c, int bx,
                                int by, int bz, int threads, float cutoff2,
                                int kind, float p0, float p1, float p2,
                                float p3, int n_extra, void* stream) {
  if (n_sys < 1 || n_sys > kMaxSystems || m_c < 1 || nx < 1 || ny < 1 ||
      nz < 1 || bx < 1 || by < 1 || bz < 1 ||
      nx % bx || ny % by || nz % bz || threads < 32 || threads % 32 ||
      threads > kAllinMaxThreads)
    return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)16 * (bz + 2) * (by + 2) * (bx + 2) * (size_t)m_c;
  const long long n_blocks = (long long)(nx / bx) * (ny / by) * (nz / bz);
  if (smem > kMaxSmem || n_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int n_targets = bz * by * bx * m_c;
  const int block =
      n_targets < threads ? (n_targets + 31) / 32 * 32 : threads;
  const PairParams prm{p0, p1, p2, p3, n_extra};
  const bool vec = m_c % 4 == 0 && ((uintptr_t)x | (uintptr_t)y |
                                     (uintptr_t)z | (uintptr_t)slot_id) %
                                            16 == 0;
  return by_kind(kind, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const cudaError_t err = allow_smem(allin_kernel<K>, smem);
    if (err != cudaSuccess) return err;
    allin_kernel<K><<<dim3((unsigned)n_blocks, n_sys), block, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(z), static_cast<const int*>(slot_id),
        static_cast<float*>(fx), static_cast<float*>(fy),
        static_cast<float*>(fz), static_cast<float*>(pot),
        static_cast<unsigned long long*>(visits), nx, ny, nz, m_c, bx, by,
        bz, vec, cutoff2, prm);
    return cudaGetLastError();
  });
}
