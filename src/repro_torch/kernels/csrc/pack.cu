// The packed-row layout (core/binning.py::pack_rows) on the card: all of
// it, from the dense bins alone. Replaces src/repro/core/binning.py::
// pack_rows (plain JAX, no Pallas kernel): per-cell counts of the occupied
// slots, the paper's §6 scan of each padded row's counts, and the scatters
// of every field, id and cell through a destination per dense slot.
//
// Two grids, launched by one call on one stream:
//   * rows: a block packs kRows = rows_per_block() padded (z, y) rows,
//     kPackThreads / kRows threads each (small rows share a block: a
//     block's latency, not its bytes, sets the time of a row of few
//     slots). A row's threads
//     read its slot ids once (16-byte loads where m_c % 4 == 0 and the ids
//     are 16-byte aligned) and count each cell's ids >= 0 in shared
//     memory, as JAX does; scan the row's nx + 2 counts (each thread a run
//     of cells, warp shuffles over the runs; exact in int32) and write the
//     row's cell_offsets (the exclusive scan, then the row's total) and
//     row_count. Then one thread per packed position d in [0, row_cap):
//     below min(row_count, row_cap) it finds its cell c, the last one whose
//     offset is <= d, by a binary search of the offsets in shared memory,
//     and copies dense slot c * m_c + (d - offsets[c]) (each field, its id,
//     and c); past it, it writes the fills (EMPTY_POS or 0 for the fields,
//     -1 for the id, 1 for the cell). Every packed write is coalesced and
//     no lane idles while a row's few occupied slots move.
//   * particles: one thread per kParticles particles maps each one's dense
//     slot to its packed slot, (z * ny + y) * (row_cap + 1) + position,
//     with the plain version's clamps (a particle the dense binning dropped
//     reads the first offset of the last padded plane; a position past
//     row_cap lands on the row's pad slot). It reads offsets that other row
//     blocks wrote, hence the second grid; the map cannot be inverted from
//     the slot ids (halo shards offset them, dropped particles are in no
//     slot).
// Stacked systems (InteractionPlan.execute_batch): n_sys systems whose
// arrays follow one another, each of one system's size. The rows of all of
// them are one list; dense_slot and pslot stay per system (the particle
// grid's y index).
//
// The gather inverts JAX's scatter dest = offsets[c] + rank exactly when
// every cell holds its particles in its first slots, as every producer of
// dense bins leaves them (bin_particles, refresh_bins, the periodic ghost
// fill, the halo's shards; tests/test_torch_packed_kernels.py checks each).
//
// What bounds it: bytes. At division 64, m_c 32 and row_cap 392 it reads
// 37 MB of slot ids once and the 1 M particles' fields and dense slots, and
// writes 34 MB of packed planes, 1.2 MB of offsets and the particle map. A
// cell's few particles share a 32-byte sector of each field plane, so the
// fields cost the card about twice their bytes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxFields = 16;
constexpr int kPackThreads = 256;   // a row block's and a particle block's
constexpr int kWarps = kPackThreads / 32;
constexpr int kMaxSystems = 65535;  // a grid's y extent
// a row's nx + 3 offsets, with the scan's warp sums and row totals,
// within the 48 KB a block gets without opting in
constexpr int kMaxRowCells = 12272;
constexpr int kMaxRowsPerBlock = 8;  // a row's threads: at least a warp
constexpr int kRowWork = 4;  // packed positions and id loads a thread
constexpr int kLoadUnroll = 4;       // 16-byte id loads in flight a thread
constexpr int kParticles = 4;        // particles a thread maps

// Rows a block packs: the most, a power of two up to kMaxRowsPerBlock, that
// leave each row enough threads to take at most kRowWork of its packed
// positions and of its 16-byte id loads a thread. (Their offsets then fit:
// rows > 1 means nx + 2 <= 4 * kPackThreads.)
int rows_per_block(int nx, int m_c, int row_cap) {
  const int loads = ((nx + 2) * m_c + 3) / 4;
  const int work = row_cap > loads ? row_cap : loads;
  int rows = kMaxRowsPerBlock;
  while (rows > 1 && kPackThreads / rows * kRowWork < work) rows /= 2;
  return rows;
}

// Fields of 4-byte elements (float32 or int32), moved as bits.
struct Fields {
  const uint32_t* src[kMaxFields];
  uint32_t* dst[kMaxFields];
  uint32_t fill[kMaxFields];
  int n;
};

// The exclusive scan of one value a thread within each run of `seg` warps
// (a row's threads); every thread calls it. -> the thread's exclusive
// prefix in its run; totals[q] gets run q's sum.
__device__ int segmented_exclusive_scan(int v, int seg, int* warp_sums,
                                        int* totals) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < kWarps ? warp_sums[lane] : 0;
    int sinc = s;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, sinc, o);
      if (lane >= o) sinc += n;
    }
    const int start = lane / seg * seg;  // the run's first warp
    const int before =
        __shfl_sync(0xffffffffu, sinc, start > 0 ? start - 1 : 0);
    const int in_run = sinc - (start > 0 ? before : 0);
    if (lane < kWarps) warp_sums[lane] = in_run - s;
    if (lane < kWarps && lane % seg == seg - 1) totals[lane / seg] = in_run;
  }
  __syncthreads();
  return inc - v + warp_sums[warp];
}

template <bool kVec, int kRows>
__global__ void __launch_bounds__(kPackThreads)
pack_rows_kernel(Fields f, const int* __restrict__ sid,
                 int* __restrict__ psid, int* __restrict__ pcell,
                 int* __restrict__ cell_offsets, int* __restrict__ row_counts,
                 long long n_rows, int nx, int m_c, int row_cap) {
  extern __shared__ int smem[];  // kRows x (nx + 3): counts, then offsets
  __shared__ int warp_sums[kWarps];
  __shared__ int totals[kRows];
  constexpr int row_threads = kPackThreads / kRows;
  const int q = threadIdx.x / row_threads, t = threadIdx.x % row_threads;
  const int n_cells = nx + 2;
  const int w = n_cells * m_c;  // dense slots of a padded row
  // systems follow one another: the row's index over the batch
  const long long row = (long long)blockIdx.x * kRows + q;
  const bool live = row < n_rows;  // the last block's spare rows idle
  const int* rsid = sid + row * w;
  int* off = smem + q * (n_cells + 1);

  for (int c = t; c < n_cells; c += row_threads) off[c] = 0;
  __syncthreads();
  if (live && kVec) {
    // m_c % 4 == 0: each 16-byte load lies in one cell
    const int4* v = reinterpret_cast<const int4*>(rsid);
    const int nv = w / 4, per_cell = m_c / 4;
    for (int j0 = t; j0 < nv; j0 += kLoadUnroll * row_threads) {
      int4 a[kLoadUnroll];
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) {
        const int j = j0 + u * row_threads;
        a[u] = j < nv ? __ldg(v + j) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) {
        const int n = (a[u].x >= 0) + (a[u].y >= 0) + (a[u].z >= 0) +
                      (a[u].w >= 0);
        if (n) atomicAdd(&off[(j0 + u * row_threads) / per_cell], n);
      }
    }
  } else if (live) {
    for (int i = t; i < w; i += row_threads)
      if (__ldg(rsid + i) >= 0) atomicAdd(&off[i / m_c], 1);
  }
  __syncthreads();

  // the row's exclusive scan: thread t sums its run of k cells, the row's
  // threads scan the runs' sums, each thread writes its run's offsets
  const int k = (n_cells + row_threads - 1) / row_threads;
  const int c0 = min(t * k, n_cells), c1 = min(c0 + k, n_cells);
  int sum = 0;
  for (int c = c0; c < c1; ++c) sum += off[c];
  int run = segmented_exclusive_scan(sum, row_threads / 32, warp_sums,
                                     totals);
  for (int c = c0; c < c1; ++c) {
    const int n = off[c];
    off[c] = run;
    run += n;
  }
  if (t == 0) off[n_cells] = totals[q];
  __syncthreads();
  if (!live) return;
  const int count = off[n_cells];
  int* co = cell_offsets + row * (n_cells + 1);
  for (int c = t; c <= n_cells; c += row_threads) co[c] = off[c];
  if (t == 0) row_counts[row] = count;

  // move and fill, one thread per packed position
  const int n_move = min(count, row_cap);
  const long long pbase = row * row_cap;
  for (int d = t; d < row_cap; d += row_threads) {
    if (d < n_move) {
      int lo = 0, hi = n_cells - 1;  // off[0] == 0 <= d
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (off[mid] <= d) lo = mid;
        else hi = mid - 1;
      }
      const long long s = row * w + lo * m_c + (d - off[lo]);
      // every load of the position issued before its first store
      uint32_t v[kMaxFields];
#pragma unroll
      for (int a = 0; a < kMaxFields; ++a)
        if (a < f.n) v[a] = __ldg(f.src[a] + s);
      const int id = __ldg(sid + s);
#pragma unroll
      for (int a = 0; a < kMaxFields; ++a)
        if (a < f.n) f.dst[a][pbase + d] = v[a];
      psid[pbase + d] = id;
      pcell[pbase + d] = lo;
    } else {
      for (int a = 0; a < f.n; ++a) f.dst[a][pbase + d] = f.fill[a];
      psid[pbase + d] = -1;
      pcell[pbase + d] = 1;
    }
  }
}

using RowsKernel = void (*)(Fields, const int*, int*, int*, int*, int*,
                           long long, int, int, int);

template <bool kVec>
RowsKernel rows_kernel(int rows) {
  switch (rows) {
    case 8: return &pack_rows_kernel<kVec, 8>;
    case 4: return &pack_rows_kernel<kVec, 4>;
    case 2: return &pack_rows_kernel<kVec, 2>;
    default: return &pack_rows_kernel<kVec, 1>;
  }
}

// kParticles particles a thread, every load of them in flight at once.
__global__ void __launch_bounds__(kPackThreads)
pack_particles_kernel(const int* __restrict__ cell_offsets,
                      const int* __restrict__ dense_slot,
                      int* __restrict__ pslot, int n_prow, int nx, int ny,
                      int m_c, int row_cap, int n_particles) {
  const long long sys = blockIdx.y;
  cell_offsets += sys * n_prow * (nx + 3);
  dense_slot += sys * n_particles;
  pslot += sys * n_particles;
  // 32-bit arithmetic: one system's slots are below 2^31 (bin_particles)
  const int nzp = n_prow / (ny + 2);
  const int w = (nx + 2) * m_c, plane = (ny + 2) * w;
  const int i0 = blockIdx.x * kPackThreads * kParticles + threadIdx.x;
  int ds[kParticles], at[kParticles], head[kParticles], r[kParticles];
#pragma unroll
  for (int u = 0; u < kParticles; ++u) {
    const int i = i0 + u * kPackThreads;
    ds[u] = i < n_particles ? __ldg(dense_slot + i) : 0;
  }
#pragma unroll
  for (int u = 0; u < kParticles; ++u) {
    const int zp = ds[u] / plane, rem = ds[u] - zp * plane;
    const int yp = rem / w, col = rem - yp * w;
    const int c = col / m_c;
    r[u] = col - c * m_c;
    at[u] = (min(zp, nzp - 1) * (ny + 2) + yp) * (nx + 3) + c;
    head[u] = (int)(((long long)(zp - 1) * ny + (yp - 1)) * (row_cap + 1));
  }
#pragma unroll
  for (int u = 0; u < kParticles; ++u) {
    const int i = i0 + u * kPackThreads;
    if (i < n_particles)
      pslot[i] = head[u] + min(__ldg(cell_offsets + at[u]) + r[u], row_cap);
  }
}

}  // namespace

// pack_rows for n_sys stacked systems (1 <= n_sys <= 65535; every shape
// below has a leading n_sys). sid (int32) and the n_fields planes (4-byte
// elements) of shape (nz+2, ny+2, (nx+2)*m_c), every cell holding its
// particles in its first slots; dense_slot (int32, n_particles),
// CellBins.particle_slot. Writes the packed planes (fill bits fill[a]),
// psid, pcell of shape (nz+2, ny+2, row_cap), cell_offsets (int32,
// (nz+2, ny+2, nx+3)), row_counts (int32, (nz+2, ny+2)) and pslot (int32,
// n_particles). At most 16 fields, nx + 3 <= 12272. Two grids on
// `stream`; allocates nothing and does not synchronise; returns the
// launches' cudaError_t.
extern "C" int pack_rows_f32(const void* const* src, void* const* dst,
                             const unsigned* fill, int n_fields,
                             const void* sid, const void* dense_slot,
                             void* psid, void* pcell, void* cell_offsets,
                             void* row_counts, void* pslot, int n_sys, int nx,
                             int ny, int nz, int m_c, int row_cap,
                             int n_particles, void* stream) {
  if (n_fields < 0 || n_fields > kMaxFields || n_sys < 1 ||
      n_sys > kMaxSystems || nx < 1 || nx + 3 > kMaxRowCells || ny < 1 ||
      nz < 1 || m_c < 1 || row_cap < 1 || n_particles < 0)
    return cudaErrorInvalidValue;
  Fields f;
  f.n = n_fields;
  for (int a = 0; a < n_fields; ++a) {
    f.src[a] = static_cast<const uint32_t*>(src[a]);
    f.dst[a] = static_cast<uint32_t*>(dst[a]);
    f.fill[a] = fill[a];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_prow = (nz + 2) * (ny + 2);
  const long long n_rows = (long long)n_sys * n_prow;
  const int rows = rows_per_block(nx, m_c, row_cap);
  const size_t smem = sizeof(int) * rows * (nx + 3);
  const bool vec = m_c % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(sid) % 16 == 0;
  const RowsKernel kernel = vec ? rows_kernel<true>(rows)
                                : rows_kernel<false>(rows);
  kernel<<<(unsigned)((n_rows + rows - 1) / rows), kPackThreads, smem, s>>>(
      f, static_cast<const int*>(sid), static_cast<int*>(psid),
      static_cast<int*>(pcell), static_cast<int*>(cell_offsets),
      static_cast<int*>(row_counts), n_rows, nx, m_c, row_cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_particles == 0) return err;
  const int per_block = kPackThreads * kParticles;
  const dim3 parts((n_particles + per_block - 1) / per_block, n_sys);
  pack_particles_kernel<<<parts, kPackThreads, 0, s>>>(
      static_cast<const int*>(cell_offsets),
      static_cast<const int*>(dense_slot), static_cast<int*>(pslot), n_prow,
      nx, ny, m_c, row_cap, n_particles);
  return cudaGetLastError();
}
