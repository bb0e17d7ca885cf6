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
// The TPU kernel evaluates every dense slot pair of each target's 3*m_c
// window, empty slots included (pair_step has no branch: an empty slot
// costs as much as a real one); at 4 particles per cell and m_c = 24 that
// is 37x the candidate pairs. Here B, C and D launch work per real particle
// and visit only the real sources of each window, in ascending slot order,
// so the pair arithmetic follows the particles.
//
// What bounds B and C on the card: the per-row work around the arithmetic.
// On an H100 (chip_smoke.py), B at division 64 (1,048,576 particles,
// m_c = 24) takes 0.82-0.90 ms against a 0.042 ms bound set by bytes, and
// 0.64 ms with the low_flop pair kernel: LJ's arithmetic is about a quarter
// of it; the staging (each neighbour row read by every block of the 9 rows
// around it, from L2 for the most part), the two compaction passes and the
// three block barriers a row, which leave the warps of short windows idle,
// are the rest.
//
// B and C (one kernel, xpencil_kernel): one block of 128 threads per
// (pencil row, x-chunk of CX cells). The row is blockIdx.x itself (B) or
// act[blockIdx.x] (C: the block loads its own id; Hopper has no scalar
// prefetch), mapped to the padded pencil (z + 1, y + 1); C's output row is
// the list position, so padding entries (pencil 0) recompute pencil 0 as
// on the TPU. The block
//   1. compacts the chunk's target slots (id >= 0) into a list in shared
//      memory, in slot order, and writes the 0s of the empty target slots
//      in the same coalesced pass;
//   2. gives each thread up to 4 targets of the list (a batch of 512; a
//      chunk with more targets takes further batches, each over the 9 rows
//      again) and keeps them and their sums in registers;
//   3. for each of the 9 neighbour rows, k = 0..8 (dz = k/3 - 1,
//      dy = k%3 - 1, the TPU index map (z + k//3, y + k%3)), compacts the
//      row's (CX+2)*m_c staged slots of x, y, z, id into a dense list of
//      its real sources, in slot order, with the offsets of its CX+2 cells;
//      each target then visits the span of its three cells, exactly as
//      kernel D does, and adds the row's partial to its sum;
//   4. writes each target's sums once, at the end of its batch.
// Both compactions are stable: each warp takes a contiguous range of the
// slots, counts its kept slots with __ballot_sync and __popc, and the prefix
// of the warp counts gives each warp's base (compact() below).
//
// The rows are double-buffered: while row k is compacted and computed, rows
// k+1 and then k+2 load into the two staging buffers. A row segment is
// contiguous in each of the four planes, so where its start and length are
// multiples of 16 bytes (m_c % 4 == 0 and 16-byte aligned planes) one thread
// issues four 1-D TMA bulk copies (cp.async.bulk) completed on the buffer's
// mbarrier; otherwise every thread issues 4-byte cp.async copies, one
// commit group per row. The chunk width CX is the widest up to 64 cells
// whose block fits kChunkSmem of shared memory (pencil_smem), evened out
// over the row's chunks: 48 KB, at which B at division 64 takes 32 cells,
// whose 128 particles fill the block's 128 threads, and an SM holds five
// blocks (64 cells: 82 KB, two blocks, 1.5-1.6x slower). An all-empty
// chunk loads no row at all.
//
// D (xpencil_packed_kernel): a tile of R consecutive entries of the row
// list (R = packed_tile_rows), its targets the real slots [0,
// min(off[nx+2], row_cap)) of each row, split evenly into blocks of at most
// 768 (packed_split); 384 threads a block, each with up to two targets.
// The first block of a tile writes the 0s of its padding slots in one
// coalesced pass. Every warp loads the tile's list itself (Hopper has no
// scalar prefetch) and splits it into groups, runs of consecutive pencils
// (z, y .. y+L-1) of one z: the whole tile of an every-pencil sweep that
// does not cross a z boundary, and common in an occupancy list. The packed
// rows (z', y-1 .. y+L) of one z' plane are one contiguous segment of every
// field, so a block stages, for each dz, the L+2 rows around the rows of
// its targets with one TMA bulk copy a field (3(L+2) rows for L pencils,
// not 9L), and each target computes its three dy partials from the
// segment, their sums carried between the three planes in shared memory.
// The planes are double-buffered: while plane k is computed, plane k+1
// loads into the other buffer, completed on that buffer's mbarrier (or,
// for row_cap % 4 != 0 or unaligned planes, by 4-byte cp.async copies, one
// commit group a plane). Staging only each row's real prefix, one copy a
// row and field, measured no faster (PERF.md, PR 19).
// Where a tile of one pencil does not fit 227 KB (row_cap > 2293), R is
// 0: one pencil a tile, its 9 rows staged one at a time in one buffer by
// cp.async, 16*row_cap bytes, one target a thread, so row_cap <= 14528 as
// before. A target reads its window [off[c-1], off[c+2]) of each source row
// from the row's offsets (c its slot cell clamped to [1, nx]; ends clamped
// to the row's min(off[nx+2], row_cap) real slots for an overflowed row).
// A window is visited 32 sources at a time: first the mask of the pairs
// within the cutoff (pair_counts), then pair_step on those alone, in
// ascending order, so LJ's pair terms (two IEEE divisions) run for the
// ~16 % of candidates within the cutoff, not for every one. What bounds D
// then: the loop over the candidates (loads, r2, compare) and the
// divergence of window lengths within a warp; with the low_flop pair
// kernel D takes about 80 % of its LJ time (PERF.md, PR 19).
//
// Stacked systems (InteractionPlan.execute_batch): every entry point takes
// n_sys systems whose planes, offsets, lists and outputs follow one another
// in memory, each of the single system's size, and launches once for all of
// them: the grid gains the system as its last axis (blockIdx.z), and a
// block offsets its pointers to its system first. A single system is
// n_sys = 1 of the same kernel. A kernel D tile is a run of one system's
// list: it never spans two systems; its size is chosen on the batch's rows
// (n_sys * n_rows), since kMinTiles counts the tiles of the whole launch.
//
// One accumulation step (pair_step, in pair.cuh, shared with kernel E)
// serves all three, so the compiler rounds and fuses each pair term the
// same way in each kernel. Each neighbour row is summed into
// its own partial, then added to the accumulator. An empty slot of a dense
// window would add exactly +-0 to a partial that starts at +0, so visiting
// only the real sources, in the same ascending order, gives B, C and D the
// TPU schedule's values per particle, and B the same bits at every chunk
// width. Outputs are written once: no atomics, nothing carried between
// blocks.

#include <cuda_runtime.h>

#include <cstdint>

#include "cells.cuh"
#include "pair.cuh"

namespace {

using namespace pair_kernels;

constexpr int kPencilThreads = 128;
constexpr int kPencilWarps = kPencilThreads / 32;
constexpr int kTargetsPerThread = 4;
constexpr int kBatch = kPencilThreads * kTargetsPerThread;
constexpr int kMaxChunkCells = 64;
constexpr size_t kChunkSmem = 48 * 1024;
constexpr int kPackedThreads = 384;
constexpr int kPackedTargets = 2 * kPackedThreads;  // a D block's targets
constexpr int kMaxTileRows = 32;   // a warp's lanes hold a D tile's list
constexpr size_t kPackedSmem = 88 * 1024;   // two D blocks an SM
constexpr int kMinTiles = 2 * 132;          // two D tiles an H100 SM

// Shared memory of one B/C block at chunk width cx: two mbarriers (16 B),
// the compacted sources (16 B each) and two staging buffers of x, y, z, id
// (32 B a slot) over the (cx+2)*m_c slots of a neighbour row, then 4 B each
// for the cx+3 cell offsets, the cx*m_c target list and the warp counts.
__host__ __device__ constexpr size_t pencil_smem(int cx, int m_c) {
  return 16 + (size_t)48 * (cx + 2) * m_c +
         (size_t)4 * ((size_t)cx * m_c + cx + 3 + kPencilWarps);
}

// Shared memory of one D block: tile_rows >= 1 pencils a tile, two
// mbarriers (16 B), two staging buffers of x, y, z, id (32 B a slot) over
// the tile_rows + 2 rows of a dz plane and the sums of the block's targets
// (16 B each); tile_rows = 0, one pencil a tile, one buffer of one row and
// no mbarrier.
__host__ __device__ constexpr size_t packed_smem(int tile_rows, int row_cap) {
  return tile_rows > 0 ? 16 + (size_t)32 * (tile_rows + 2) * row_cap +
                             (size_t)16 * kPackedTargets
                       : (size_t)16 * row_cap;
}

// The targets a D block takes: a tile's slots, tile_rows (or 1) times
// row_cap, split evenly into the fewest parts of at most kPackedTargets
// (tile_rows >= 1) or kPackedThreads (0).
int packed_split(int tile_rows, int row_cap) {
  const long long slots = (long long)(tile_rows > 0 ? tile_rows : 1) * row_cap;
  const int cap = tile_rows > 0 ? kPackedTargets : kPackedThreads;
  const long long parts = (slots + cap - 1) / cap;
  return (int)((slots + parts - 1) / parts);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 1-D TMA: `bytes` (a multiple of 16) from 16-byte aligned global memory
// into shared memory, completion counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stable compaction, by the whole block, of the i in [0, n) with keep(i).
// Each warp takes a contiguous range of whole 32-slot rounds and counts its
// kept slots with __ballot_sync and __popc; the prefix of the warp counts
// gives each warp's base. Then visit(i, kept, rank) runs for every i, rank
// being the number of kept j < i, and, where stride > 0, mark[c] = that rank
// for every i = c * stride. Returns the number kept. The caller
// synchronises before it reads what visit wrote or calls this again.
template <typename Keep, typename Visit>
__device__ __forceinline__ int compact(int n, int stride, int* mark,
                                       int* wcnt, Keep keep, Visit visit) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int per = (n + 32 * kPencilWarps - 1) / (32 * kPencilWarps) * 32;
  const int lo = min(w * per, n), hi = min(lo + per, n);
  int count = 0;
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    count += __popc(__ballot_sync(0xffffffffu, i < hi && keep(i)));
  }
  if (lane == 0) wcnt[w] = count;
  __syncthreads();
  int rank = 0, total = 0;
#pragma unroll
  for (int v = 0; v < kPencilWarps; ++v) {
    const int c = wcnt[v];
    rank += v < w ? c : 0;
    total += c;
  }
  const unsigned below = (1u << lane) - 1u;
  int cell = stride > 0 ? (lo + stride - 1) / stride : 0;
  int edge = cell * stride;  // the next multiple of stride in the range
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const bool kept = i < hi && keep(i);
    const unsigned bal = __ballot_sync(0xffffffffu, kept);
    const int r = rank + __popc(bal & below);
    if (i < hi) visit(i, kept, r);
    if (stride > 0)
      for (; edge < min(b + 32, hi); edge += stride, ++cell)
        if (lane == edge - b) mark[cell] = r;
    rank += __popc(bal);
  }
  return total;
}

// Kernels B (act == nullptr: row r is pencil r) and C (row r is pencil
// act[r]). Grid (n_rows, x-chunks of cx_cells, systems); 128 threads;
// dynamic shared memory pencil_smem(cx_cells, m_c). bulk: load rows with
// TMA bulk copies (m_c % 4 == 0, planes 16-byte aligned), else with 4-byte
// cp.async.
template <int KIND>
__global__ void __launch_bounds__(kPencilThreads)
xpencil_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ z, const int* __restrict__ sid,
               const int* __restrict__ act, float* __restrict__ fx,
               float* __restrict__ fy, float* __restrict__ fz,
               float* __restrict__ pot, int nx, int ny, int nz, int m_c,
               int cx_cells, bool bulk, float cutoff2, PairParams prm) {
  constexpr int kT = kTargetsPerThread;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long row_len = (long long)(nx + 2) * m_c;
  {  // the block's system: its planes, list and output rows
    const long long sys = blockIdx.z, n_rows = gridDim.x;
    const long long planes = sys * (nz + 2) * (ny + 2) * row_len;
    const long long outs = sys * n_rows * nx * m_c;
    x += planes;
    y += planes;
    z += planes;
    sid += planes;
    if (act) act += sys * n_rows;
    fx += outs;
    fy += outs;
    fz += outs;
    pot += outs;
  }
  const int row_out = blockIdx.x;
  const int zy = act ? act[row_out] : row_out;
  const int zz = zy / ny, yy = zy - zz * ny;
  const int x0 = blockIdx.y * cx_cells;
  const int cx = min(cx_cells, nx - x0);
  const int len = (cx + 2) * m_c;  // staged slots of a neighbour row
  const int t = threadIdx.x;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float4* comp = reinterpret_cast<float4*>(smem + 16);
  float* stage = reinterpret_cast<float*>(comp + len);  // [2][x,y,z,id][len]
  int* off = reinterpret_cast<int*>(stage + 8 * len);   // cx + 3
  int* tslot = off + cx + 3;                            // cx * m_c
  int* wcnt = tslot + cx * m_c;                         // kPencilWarps

  if (bulk && t == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // 1. the chunk's targets, in slot order; the empty slots' 0s
  const long long tbase =
      ((long long)(zz + 1) * (ny + 2) + (yy + 1)) * row_len +
      (long long)(x0 + 1) * m_c;
  const long long obase = (long long)row_out * nx * m_c + (long long)x0 * m_c;
  const int n_tgt = compact(
      cx * m_c, 0, nullptr, wcnt, [&](int i) { return sid[tbase + i] >= 0; },
      [&](int i, bool kept, int r) {
        if (kept) {
          tslot[r] = i;
        } else {
          fx[obase + i] = 0.0f;
          fy[obase + i] = 0.0f;
          fz[obase + i] = 0.0f;
          pot[obase + i] = 0.0f;
        }
      });
  __syncthreads();  // the target list and the barriers are ready

  // step s stages neighbour row s % 9 for target batch s / 9 in buffer s & 1
  const int n_steps = 9 * ((n_tgt + kBatch - 1) / kBatch);
  auto issue = [&](int s) {
    const int k = s % 9;
    const long long row =
        ((long long)(zz + k / 3) * (ny + 2) + (yy + k % 3)) * row_len +
        (long long)x0 * m_c;
    float* dst = stage + 4 * (s & 1) * len;
    const void* src[4] = {x + row, y + row, z + row, sid + row};
    if (bulk) {
      if (t == 0) {
        // the generic-proxy reads of this buffer (ordered by the block
        // barrier before the call) come before the async-proxy writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t bar = smem_u32(&bars[s & 1]);
        mbar_expect_tx(bar, 16u * len);
#pragma unroll
        for (int a = 0; a < 4; ++a)
          bulk_load(smem_u32(dst + a * len), src[a], 4u * len, bar);
      }
    } else {
      for (int i = t; i < len; i += kPencilThreads) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
          cp_async4(smem_u32(dst + a * len + i),
                    static_cast<const float*>(src[a]) + i);
      }
      cp_async_commit();  // one group per step, empty or not
    }
  };
  if (n_steps > 0) issue(0);
  if (n_steps > 1) issue(1);

  float tx[kT], ty[kT], tz[kT], ax[kT], ay[kT], az[kT], ap[kT];
  int tid[kT], tcell[kT], ts[kT];
  for (int s = 0; s < n_steps; ++s) {
    const int k = s % 9;
    if (k == 0) {  // 2. the next batch of targets
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        const int q = (s / 9) * kBatch + j * kPencilThreads + t;
        ts[j] = q < n_tgt ? tslot[q] : -1;
        tx[j] = ty[j] = tz[j] = 0.0f;
        tid[j] = -1;
        tcell[j] = 0;
        if (ts[j] >= 0) {
          const long long g = tbase + ts[j];
          tx[j] = x[g];
          ty[j] = y[g];
          tz[j] = z[g];
          tid[j] = sid[g];
          tcell[j] = ts[j] / m_c;
        }
        ax[j] = ay[j] = az[j] = ap[j] = 0.0f;
      }
    }

    // 3. row s has landed: compact its real sources
    if (bulk) {
      mbar_wait(smem_u32(&bars[s & 1]), (s >> 1) & 1);
    } else {
      if (s + 1 < n_steps)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }
    const float* sx = stage + 4 * (s & 1) * len;
    const float* sy = sx + len;
    const float* sz = sy + len;
    const int* ss = reinterpret_cast<const int*>(sz + len);
    const int n_src = compact(
        len, m_c, off, wcnt, [&](int i) { return ss[i] >= 0; },
        [&](int i, bool kept, int r) {
          if (kept)
            comp[r] = make_float4(sx[i], sy[i], sz[i], __int_as_float(ss[i]));
        });
    if (t == 0) off[cx + 2] = n_src;
    __syncthreads();  // sources and offsets ready; the buffer is free
    if (s + 2 < n_steps) issue(s + 2);

#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (ts[j] < 0) continue;
      const int lo = off[tcell[j]], hi = off[tcell[j] + 3];
      float px = 0.0f, py = 0.0f, pz = 0.0f, pp = 0.0f;
      for (int i = lo; i < hi; ++i) {
        const float4 q = comp[i];
        pair_step<KIND>(tx[j], ty[j], tz[j], tid[j], q.x, q.y, q.z,
                        __float_as_int(q.w), cutoff2, prm, px, py, pz, pp);
      }
      ax[j] += px;
      ay[j] += py;
      az[j] += pz;
      ap[j] += pp;
    }
    if (k == 8) {  // 4. the batch's sums
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        if (ts[j] < 0) continue;
        fx[obase + ts[j]] = ax[j];
        fy[obase + ts[j]] = ay[j];
        fz[obase + ts[j]] = az[j];
        pot[obase + ts[j]] = ap[j];
      }
    }
    __syncthreads();  // the sources, offsets and warp counts are free
  }
}

// Kernel D over packed rows of row_cap slots (act == nullptr: entry a is
// pencil a; else entry a is pencil act[a]). Grid (tiles of tile_rows
// consecutive entries of a system's n_rows, or one at tile_rows 0; parts of
// split targets; systems); kPackedThreads threads; dynamic shared memory packed_smem(tile_rows,
// row_cap). bulk (tile_rows > 0, row_cap % 4 == 0, planes 16-byte aligned):
// TMA bulk copies, else 4-byte cp.async.
template <int KIND>
__global__ void __launch_bounds__(kPackedThreads, 2)
xpencil_packed_kernel(const float* __restrict__ x,
                      const float* __restrict__ y,
                      const float* __restrict__ z,
                      const int* __restrict__ sid,
                      const int* __restrict__ scell,
                      const int* __restrict__ off,
                      const int* __restrict__ act, float* __restrict__ fx,
                      float* __restrict__ fy, float* __restrict__ fz,
                      float* __restrict__ pot, int n_rows, int nx, int ny,
                      int nz, int row_cap, int tile_rows, int split, bool bulk,
                      float cutoff2, PairParams prm) {
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  {  // the block's system: its packed planes, offsets, list and outputs
    const long long sys = blockIdx.z;
    const long long rows = (long long)(nz + 2) * (ny + 2);
    const long long planes = sys * rows * row_cap;
    x += planes;
    y += planes;
    z += planes;
    sid += planes;
    scell += planes;
    off += sys * rows * (nx + 3);
    if (act) act += sys * n_rows;
    const long long outs = sys * n_rows * row_cap;
    fx += outs;
    fy += outs;
    fz += outs;
    pot += outs;
  }
  const bool planes = tile_rows > 0;
  const int n_buf = planes ? 2 : 1;
  const int n_dy = planes ? 3 : 1;     // dy partials a step computes
  const int per_group = 9 / n_dy;      // steps a group takes
  const long long seg_len = (long long)(planes ? tile_rows + 2 : 1) * row_cap;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* stage = reinterpret_cast<float*>(smem + (planes ? 16 : 0));
  float4* sums = reinterpret_cast<float4*>(stage + 2 * 4 * seg_len);
  const int t = threadIdx.x, lane = t & 31;
  const int nyp = ny + 2, n_off = nx + 3;
  const int a0 = blockIdx.x * (planes ? tile_rows : 1);
  const int n_ent = min(planes ? tile_rows : 1, n_rows - a0);

  // 1. the tile's list, in every warp: lane i holds entry a0 + i, its
  // pencil zy, its real targets nt (the row's real slots) and their
  // exclusive prefix excl over the tile
  int zy = 0, nt = 0;
  if (lane < n_ent) {
    zy = act ? act[a0 + lane] : a0 + lane;
    const int zz = zy / ny;
    nt = min(off[((long long)(zz + 1) * nyp + (zy - zz * ny) + 1) * n_off +
                 nx + 2],
             row_cap);
  }
  int incl = nt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += v;
  }
  const int excl = incl - nt;
  // the entry of tile target k: the last entry whose targets start at or
  // before it (an entry with none starts where the next one does)
  auto entry_of = [&](int k) {
    int e = 0;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
      const int m = e + w;
      const int v = __shfl_sync(kAll, excl, min(m, 31));  // every lane
      if (m < n_ent && v <= k) e = m;
    }
    return e;
  };

  // 2. the 0s of the padding slots [nt, row_cap), by the tile's first part
  if (blockIdx.y == 0) {
    for (int i = 0; i < n_ent; ++i) {
      const int n = __shfl_sync(kAll, nt, i);
      const long long o = (long long)(a0 + i) * row_cap;
      for (int s = n + t; s < row_cap; s += kPackedThreads) {
        fx[o + s] = 0.0f;
        fy[o + s] = 0.0f;
        fz[o + s] = 0.0f;
        pot[o + s] = 0.0f;
      }
    }
  }

  // 3. this block's targets [k_beg, k_end) of the tile, and the groups
  // they fall in: a group is a run of consecutive pencils of one z. Lane g
  // holds group g's part [g_lo, g_hi) of them and its entries e_lo..e_hi.
  const int k_beg = blockIdx.y * split;
  const int k_end = min(k_beg + split, __shfl_sync(kAll, incl, n_ent - 1));
  if (k_beg >= k_end) return;
  const int prev = __shfl_up_sync(kAll, zy, 1);
  const unsigned starts = __ballot_sync(
      kAll, lane < n_ent &&
                (lane == 0 || zy != prev + 1 || zy / ny != prev / ny));
  const int n_groups = __popc(starts);
  const int g_first = lane < n_groups ? nth_set_bit(starts, lane) : 0;
  const int g_end =
      lane + 1 < n_groups ? nth_set_bit(starts, lane + 1) : n_ent;
  const int g_lo = max(k_beg, __shfl_sync(kAll, excl, g_first));
  const int g_hi = min(k_end, __shfl_sync(kAll, incl, max(g_end - 1, 0)));
  const unsigned parts = __ballot_sync(kAll, lane < n_groups && g_lo < g_hi);
  const int e_lo = entry_of(g_lo);
  const int e_hi = entry_of(g_hi - 1);
  const int n_steps = __popc(parts) * per_group;

  if (bulk && t == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are ready

  // Step s stages, for the (s / per_group)-th group with targets here and
  // its step j = s % per_group, the rows its targets read at dz (and, one
  // row a step, dy): padded rows (z + 1 + dz, y_lo + dy_lo .. y_hi +
  // dy_hi), one contiguous segment of every plane.
  struct Geometry {
    int e_lo, len, k_lo, k_hi, j;
    long long trow;  // the padded row of entry e_lo
    long long row0;  // the first padded row the step stages
  };
  auto geometry = [&](int s) {
    Geometry q;
    const int g = nth_set_bit(parts, s / per_group);
    q.j = s % per_group;
    q.e_lo = __shfl_sync(kAll, e_lo, g);
    q.len = __shfl_sync(kAll, e_hi, g) - q.e_lo + 1;
    q.k_lo = __shfl_sync(kAll, g_lo, g);
    q.k_hi = __shfl_sync(kAll, g_hi, g);
    const int zy0 = __shfl_sync(kAll, zy, q.e_lo);
    const int zz = zy0 / ny, yy = zy0 - zz * ny;
    const int dz = planes ? q.j - 1 : q.j / 3 - 1;
    const int dy_lo = planes ? -1 : q.j % 3 - 1;
    q.trow = (long long)(zz + 1) * nyp + yy + 1;
    q.row0 = q.trow + (long long)dz * nyp + dy_lo;
    return q;
  };

  auto issue = [&](int s) {
    const Geometry q = geometry(s);
    const int buf = s % n_buf;
    const int rows = q.len + n_dy - 1;
    float* dst = stage + buf * 4 * seg_len;
    const float* src[4] = {x, y, z, reinterpret_cast<const float*>(sid)};
    if (bulk) {
      if (t == 0) {
        // the generic-proxy reads of this buffer (ordered by the block
        // barrier before the call) come before the async-proxy writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t bar = smem_u32(&bars[buf]);
        const uint32_t bytes = 4u * rows * row_cap;
        mbar_expect_tx(bar, 4 * bytes);
#pragma unroll
        for (int a = 0; a < 4; ++a)
          bulk_load(smem_u32(dst + a * seg_len), src[a] + q.row0 * row_cap,
                    bytes, bar);
      }
    } else {
      for (int i = t; i < rows * row_cap; i += kPackedThreads) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
          cp_async4(smem_u32(dst + a * seg_len + i),
                    src[a] + q.row0 * row_cap + i);
      }
      cp_async_commit();  // one group per step, empty or not
    }
  };

  // A step takes its group's targets k in [k_lo, k_hi), target k on thread
  // (k - k_lo) % kPackedThreads for all of the group's steps: tile_rows
  // >= 1, their sums carried between the group's three planes in shared
  // memory; tile_rows 0, one target a thread, its sums in registers.
  struct Target {
    int k, e, slot, tid, cell;  // e: its entry less the group's e_lo
    float x, y, z;
  };
  auto target = [&](const Geometry& q, int k) {
    Target g;
    g.k = k;
    const int e = entry_of(k);
    g.e = e - q.e_lo;
    g.slot = k - __shfl_sync(kAll, excl, e);
    g.tid = -1;
    g.cell = 1;
    g.x = g.y = g.z = 0.0f;
    if (k < q.k_hi) {
      const long long ti = (q.trow + g.e) * row_cap + g.slot;
      g.tid = sid[ti];
      g.x = x[ti];
      g.y = y[ti];
      g.z = z[ti];
      g.cell = min(max(scell[ti], 1), nx);
    }
    return g;
  };

  // 4. the steps: while step s is computed, step s + 1 loads (two buffers)
  float4 rsum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n_buf == 2 && n_steps > 0) issue(0);
  for (int s = 0; s < n_steps; ++s) {
    const int buf = s % n_buf;
    if (s + n_buf - 1 < n_steps) issue(s + n_buf - 1);
    const Geometry q = geometry(s);
    Target g = target(q, q.k_lo + t);  // loads while the rows land
    if (bulk) {
      mbar_wait(smem_u32(&bars[buf]), (s >> 1) & 1);
    } else {
      if (n_buf == 2 && s + 1 < n_steps)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }
    const float* sx = stage + buf * 4 * seg_len;
    const float* sy = sx + seg_len;
    const float* sz = sy + seg_len;
    const int* ss = reinterpret_cast<const int*>(sz + seg_len);
    for (int k0 = q.k_lo; k0 < q.k_hi; k0 += kPackedThreads) {
      if (k0 != q.k_lo) g = target(q, k0 + t);
      if (g.k >= q.k_hi) continue;
      float4 a = q.j == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                          : (planes ? sums[g.k - k_beg] : rsum);
      // one partial a dy, each from +0 over the window [off[c-1],
      // off[c+2]) of the source row in ascending order, added in k order
      for (int d = 0; d < n_dy && g.tid >= 0; ++d) {
        // the source row's real particles: offsets of an overflowed row run
        // past row_cap, whose slots hold only the first row_cap of them
        const int* so = off + (q.row0 + g.e + d) * n_off;
        const int n_real = min(so[nx + 2], row_cap);
        const int r0 = (g.e + d) * row_cap;
        const int lo = r0 + min(so[g.cell - 1], n_real);
        const int hi = r0 + min(so[g.cell + 2], n_real);
        float px = 0.0f, py = 0.0f, pz = 0.0f, pp = 0.0f;
        // 32 sources at a time: first the mask of the pairs pair_step
        // counts, then pair_step on those alone, in ascending order
        // (pair_counts: the others add exactly +-0), so a warp runs the pair
        // terms about as often as its lanes' largest count within the
        // cutoff, not their largest window
        for (int c0 = lo; c0 < hi; c0 += 32) {
          const int n = min(32, hi - c0);
          unsigned kept = 0;
          for (int i = 0; i < n; ++i)
            if (pair_counts(g.x, g.y, g.z, g.tid, sx[c0 + i], sy[c0 + i],
                            sz[c0 + i], ss[c0 + i], cutoff2))
              kept |= 1u << i;
          for (; kept; kept &= kept - 1) {
            const int i = c0 + __ffs(kept) - 1;
            pair_step<KIND>(g.x, g.y, g.z, g.tid, sx[i], sy[i], sz[i], ss[i],
                            cutoff2, prm, px, py, pz, pp);
          }
        }
        a.x += px;
        a.y += py;
        a.z += pz;
        a.w += pp;
      }
      if (q.j < per_group - 1) {
        if (planes)
          sums[g.k - k_beg] = a;
        else
          rsum = a;
      } else {  // 5. the target's sums
        const long long o =
            (long long)(a0 + q.e_lo + g.e) * row_cap + g.slot;
        fx[o] = a.x;
        fy[o] = a.y;
        fz[o] = a.z;
        pot[o] = a.w;
      }
    }
    __syncthreads();  // the buffer is free
  }
}

// The chunk width of kernels B and C: the widest up to kMaxChunkCells whose
// block needs at most kChunkSmem of shared memory (at least 1), then evened
// out over the row's chunks.
int chunk_cells(int nx, int m_c) {
  int cx = nx < kMaxChunkCells ? nx : kMaxChunkCells;
  while (cx > 1 && pencil_smem(cx, m_c) > kChunkSmem) --cx;
  const int n_chunks = (nx + cx - 1) / cx;
  return (nx + n_chunks - 1) / n_chunks;
}

cudaError_t launch_pencils(const void* x, const void* y, const void* z,
                           const void* slot_id, const int* act, void* fx,
                           void* fy, void* fz, void* pot, int n_sys,
                           int n_rows, int nx, int ny, int nz, int m_c,
                           int cx_cells, float cutoff2, int kind,
                           PairParams prm, void* stream) {
  if (cx_cells < 1 || cx_cells > nx) return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  const size_t smem = pencil_smem(cx_cells, m_c);
  // a system's planes hold (nz+2)(ny+2)(nx+2)*m_c slots, a multiple of 4
  // where m_c is: each system's rows keep the alignment of the first's
  const bool bulk =
      m_c % 4 == 0 && ((uintptr_t)x | (uintptr_t)y | (uintptr_t)z |
                       (uintptr_t)slot_id) % 16 == 0;
  const dim3 grid(n_rows, (nx + cx_cells - 1) / cx_cells, n_sys);
  return by_kind(kind, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const cudaError_t err = allow_smem(xpencil_kernel<K>, smem);
    if (err != cudaSuccess) return err;
    xpencil_kernel<K><<<grid, kPencilThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(z), static_cast<const int*>(slot_id), act,
        static_cast<float*>(fx), static_cast<float*>(fy),
        static_cast<float*>(fz), static_cast<float*>(pot), nx, ny, nz, m_c,
        cx_cells, bulk, cutoff2, prm);
    return cudaGetLastError();
  });
}

// Kernel D's tile: the most pencils, up to kMaxTileRows, whose block needs
// at most kPackedSmem of shared memory and that leave at least kMinTiles
// tiles of the n_rows entries (at least 1); 0 (one row a step, one buffer)
// where a block of one pencil exceeds kMaxSmem.
int packed_tile_rows(int row_cap, int n_rows) {
  if (packed_smem(1, row_cap) > kMaxSmem) return 0;
  int r = kMaxTileRows;
  while (r > 1 && (packed_smem(r, row_cap) > kPackedSmem ||
                   (long long)r * kMinTiles > n_rows))
    --r;
  return r;
}

cudaError_t launch_packed(const void* x, const void* y, const void* z,
                          const void* slot_id, const void* slot_cell,
                          const void* cell_offsets, const void* active,
                          void* fx, void* fy, void* fz, void* pot, int n_sys,
                          int n_rows, int nx, int ny, int nz, int row_cap,
                          int tile_rows, float cutoff2, int kind,
                          PairParams prm, void* stream) {
  if (n_rows == 0) return cudaSuccess;
  const size_t smem = packed_smem(tile_rows, row_cap);
  const bool bulk =
      tile_rows > 0 && row_cap % 4 == 0 &&
      ((uintptr_t)x | (uintptr_t)y | (uintptr_t)z | (uintptr_t)slot_id) % 16 ==
          0;
  const int per_block = tile_rows > 0 ? tile_rows : 1;
  const int split = packed_split(tile_rows, row_cap);
  const dim3 grid((n_rows + per_block - 1) / per_block,
                  (per_block * row_cap + split - 1) / split, n_sys);
  return by_kind(kind, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const cudaError_t err = allow_smem(xpencil_packed_kernel<K>, smem);
    if (err != cudaSuccess) return err;
    xpencil_packed_kernel<K><<<grid, kPackedThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(z), static_cast<const int*>(slot_id),
        static_cast<const int*>(slot_cell),
        static_cast<const int*>(cell_offsets),
        static_cast<const int*>(active), static_cast<float*>(fx),
        static_cast<float*>(fy), static_cast<float*>(fz),
        static_cast<float*>(pot), n_rows, nx, ny, nz, row_cap, tile_rows,
        split, bulk, cutoff2, prm);
    return cudaGetLastError();
  });
}

bool pencil_args_ok(int n_sys, int nx, int ny, int nz, int m_c) {
  return n_sys >= 1 && n_sys <= kMaxSystems && m_c >= 1 && nx >= 1 &&
         ny >= 1 && nz >= 1 && pencil_smem(1, m_c) <= kMaxSmem;
}

}  // namespace

// Kernel B. Planes x, y, z (float32) and slot_id (int32) of shape
// (n_sys, nz+2, ny+2, (nx+2)*m_c), contiguous; outputs fx, fy, fz, pot
// (float32) of shape (n_sys, nz, ny, nx*m_c); 1 <= n_sys <= 65535. A block
// needs pencil_smem(1, m_c) bytes of shared memory at the least, at most
// 227 KB: m_c <= 1570. Allocates nothing and does not synchronise; returns
// the launch's cudaError_t.
extern "C" int xpencil_forces_f32(const void* x, const void* y, const void* z,
                                  const void* slot_id, void* fx, void* fy,
                                  void* fz, void* pot, int n_sys, int nx,
                                  int ny, int nz, int m_c, float cutoff2,
                                  int kind, float p0, float p1, float p2,
                                  float p3, int n_extra, void* stream) {
  if (!pencil_args_ok(n_sys, nx, ny, nz, m_c)) return cudaErrorInvalidValue;
  return launch_pencils(x, y, z, slot_id, nullptr, fx, fy, fz, pot, n_sys,
                        ny * nz, nx, ny, nz, m_c, chunk_cells(nx, m_c),
                        cutoff2, kind, PairParams{p0, p1, p2, p3, n_extra},
                        stream);
}

// Kernel C. Planes as for kernel B; active (int32, (n_sys, n_rows)) holds
// each system's interior pencil ids z*ny + y in [0, nz*ny); outputs of
// shape (n_sys, n_rows, nx*m_c), row a of system s for pencil active[s, a].
extern "C" int xpencil_sparse_f32(const void* x, const void* y, const void* z,
                                  const void* slot_id, const void* active,
                                  void* fx, void* fy, void* fz, void* pot,
                                  int n_sys, int n_rows, int nx, int ny,
                                  int nz, int m_c, float cutoff2, int kind,
                                  float p0, float p1, float p2, float p3,
                                  int n_extra, void* stream) {
  if (!pencil_args_ok(n_sys, nx, ny, nz, m_c) || n_rows < 0)
    return cudaErrorInvalidValue;
  return launch_pencils(x, y, z, slot_id, static_cast<const int*>(active), fx,
                        fy, fz, pot, n_sys, n_rows, nx, ny, nz, m_c,
                        chunk_cells(nx, m_c), cutoff2, kind,
                        PairParams{p0, p1, p2, p3, n_extra}, stream);
}

// Kernel B (active NULL, n_rows = nz*ny) or C at a given chunk width of
// 1 <= cx_cells <= nx cells, which needs pencil_smem(cx_cells, m_c) bytes
// of shared memory; the same outputs, bit for bit, as at the width the
// entries above choose.
extern "C" int xpencil_chunked_f32(const void* x, const void* y,
                                   const void* z, const void* slot_id,
                                   const void* active, void* fx, void* fy,
                                   void* fz, void* pot, int n_sys, int n_rows,
                                   int nx, int ny, int nz, int m_c,
                                   int cx_cells, float cutoff2, int kind,
                                   float p0, float p1, float p2, float p3,
                                   int n_extra, void* stream) {
  if (!pencil_args_ok(n_sys, nx, ny, nz, m_c) || n_rows < 0 ||
      (active == nullptr && n_rows != nz * ny))
    return cudaErrorInvalidValue;
  return launch_pencils(x, y, z, slot_id, static_cast<const int*>(active), fx,
                        fy, fz, pot, n_sys, n_rows, nx, ny, nz, m_c, cx_cells,
                        cutoff2, kind, PairParams{p0, p1, p2, p3, n_extra},
                        stream);
}

// Kernel D. Packed planes x, y, z (float32), slot_id and slot_cell (int32)
// of shape (n_sys, nz+2, ny+2, row_cap), cell_offsets (int32) of shape
// (n_sys, nz+2, ny+2, nx+3), active (int32, (n_sys, n_rows)) each system's
// interior pencil ids or NULL for every pencil in id order (n_rows =
// nz*ny); outputs of shape (n_sys, n_rows, row_cap). tile_rows: pencils a
// block, 0 <= tile_rows <= kMaxTileRows with packed_smem(tile_rows,
// row_cap) <= kMaxSmem, or -1 for packed_tile_rows(row_cap, n_sys *
// n_rows), the batch's rows; the bits do not depend on it. At tile_rows 0
// a block needs 16*row_cap bytes: row_cap <= 14528.
extern "C" int xpencil_packed_f32(const void* x, const void* y, const void* z,
                                  const void* slot_id, const void* slot_cell,
                                  const void* cell_offsets, const void* active,
                                  void* fx, void* fy, void* fz, void* pot,
                                  int n_sys, int n_rows, int nx, int ny,
                                  int nz, int row_cap, int tile_rows,
                                  float cutoff2, int kind, float p0, float p1,
                                  float p2, float p3, int n_extra,
                                  void* stream) {
  if (n_sys < 1 || n_sys > kMaxSystems || row_cap < 1 || nx < 1 || ny < 1 ||
      nz < 1 || n_rows < 0 || (long long)n_sys * n_rows > 0x7fffffffLL ||
      (active == nullptr && n_rows != nz * ny))
    return cudaErrorInvalidValue;
  if (tile_rows < 0) tile_rows = packed_tile_rows(row_cap, n_sys * n_rows);
  if (tile_rows > kMaxTileRows || packed_smem(tile_rows, row_cap) > kMaxSmem)
    return cudaErrorInvalidValue;
  return launch_packed(x, y, z, slot_id, slot_cell, cell_offsets, active, fx,
                       fy, fz, pot, n_sys, n_rows, nx, ny, nz, row_cap,
                       tile_rows, cutoff2, kind,
                       PairParams{p0, p1, p2, p3, n_extra}, stream);
}
