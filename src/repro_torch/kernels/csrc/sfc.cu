// SFC cluster-pair cutoff forces (layout="sfc") in float32: kernel F.
//
// Replaces src/repro/kernels/sfc.py::cell_sfc_forces (Pallas grid
// (pair_cap,): one program per sorted pair code cluster*32 + k, the
// cluster's output tile resident across its consecutive codes and zeroed
// at its first code; source slabs read from the whole staged planes through
// a scalar-prefetched slot-offset table; every slot of a slab visited,
// empty slots included).
//
// Design: one block of one warp per cluster a, on a flat grid of
// n_clusters blocks (Hopper blocks run in no order and carry nothing
// between them, so the TPU's resident tile becomes a warp that owns its
// cluster; a warp needs no block barrier, and its shared memory is its
// own). The warp
//   1. finds the cluster's segment [a*32, (a+1)*32) of the sorted codes,
//      32 probes a step (sentinel codes n_clusters*32 sort past every
//      segment);
//   2. compacts the csize*m_c tile's real target slots into a list in its
//      shared memory, in slot order, and writes the 0s of the empty ones in
//      the same coalesced pass; a cluster with no real target is done;
//   3. takes the segment's kept codes (k < 27, a repeated code once), up to
//      32 at a time, with the csize source bases of each (src_base);
//   4. for G codes at a time stages their G*csize source slabs compacted
//      (stage in cells.cuh: real slots in slot order, a terminator;
//      a base equal to the planes' size, `total`, is the empty sentinel
//      cell) and lets each real target visit only its own slab's real
//      sources (visit_cell) into a partial per code, added to its sum in
//      ascending k.
// Targets go to lanes: with more than 16, lane l takes targets l and l+32
// (more re-stage the codes for the next 64), G = 1; with
// n <= 16, TW lanes a code (TW the power of two >= n) and G = 32/TW codes
// a step (at most sfc_group(csize*m_c)): lane (t, g) computes target t's
// partial over code g of the step, and lane (t, 0) adds the G partials in
// ascending order (__shfl_sync). Outputs are written once, the whole tile:
// no atomics, no first-code flags and no ghost row.
//
// Per target, the sum runs over the kept slabs in ascending k; a slab that
// is not kept is empty and adds exactly nothing, and so does an empty slot
// (a partial that starts at +0 and adds +-0 stays +0). So per particle
// kernel F gives the same bits whatever the curve, the cluster size, the
// grouping G or pair_cap (as long as nothing was truncated), and the bits
// of its schedule that visited every slot. It is not kernel B's bits: B
// sums one 3*m_c window per (dz, dy) row, F one m_c slab per k.
//
// Stacked systems (InteractionPlan.execute_batch): n_sys systems whose
// planes (total slots each), codes (n_codes each) and tiles follow one
// another, launched once for all, the grid's y index the system. The slot
// base tables are one system's, shared by all: a block offsets its pointers
// to its system first, and the sentinel base stays `total`.
//
// What bounds it on the card: the staging. A target's 27 slabs are staged
// apart (each kept code stages the slabs of its cluster's cells shifted by
// k, 27*csize*m_c slot ids a cluster), about 2.8x the slot ids B reads per
// cell, from L2 for the most part; its pair work is B's, the real sources
// of each target's 27 cells. On an H100 (chip_smoke.py) F takes 1.35 ms at
// division 64 against B's 0.82 in turns, 1.01 ms of it with the low_flop
// pair kernel. On a clustered scene the pair list drops the empty
// neighbourhoods, so F's staging follows the occupied clusters. The tile
// is not limited by threads: a warp's shared memory (sfc_warp_smem) is the
// limit, csize*m_c up to about 11,600 slots.

#include <cuda_runtime.h>

#include <cstdint>

#include "cells.cuh"

namespace {

using namespace pair_kernels;

constexpr int kSfcStageBytes = 6144;  // staging a warp aims at
constexpr int kSfcTargets = 2;        // targets a lane holds

// Codes a warp stages at a time for a tile of csize*m_c slots: 4, 2 or 1,
// the most whose slabs (16 B a slot) fit kSfcStageBytes.
__host__ __device__ constexpr int sfc_group(int tile) {
  return 64 * tile <= kSfcStageBytes ? 4 : 32 * tile <= kSfcStageBytes ? 2 : 1;
}

// Shared memory of one warp: the staged slabs of sfc_group codes (16 B a
// slot), the target list (4 B a tile slot), the source bases of 32 codes
// and their stencil slots, rounded up to 16 B.
__host__ __device__ constexpr size_t sfc_warp_smem(int csize, int m_c) {
  return ((size_t)16 * sfc_group(csize * m_c) * csize * m_c +
          (size_t)4 * csize * m_c + (size_t)128 * csize + 128 + 15) / 16 * 16;
}

// First index of the sorted codes[0, n) that is >= key, by the whole warp:
// 32 probes a step, so about five dependent loads at 1.75M codes.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ codes,
                                                int n, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer is in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const int below = __popc(
        __ballot_sync(0xffffffffu, p < hi && codes[p] < key));
    if (below == 0) {
      hi = lo;
    } else {
      const int next = lo + (below - 1) * step + 1;
      hi = min(lo + below * step, hi);
      lo = next;
    }
  }
  return lo;
}

template <int KIND>
__global__ void __launch_bounds__(32)
sfc_kernel(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ z, const int* __restrict__ sid,
           const int* __restrict__ codes, int n_codes,
           const int* __restrict__ tgt_base, const int* __restrict__ src_base,
           float* __restrict__ fx, float* __restrict__ fy,
           float* __restrict__ fz, float* __restrict__ pot,
           unsigned long long* __restrict__ visits, int total, int m_c,
           int csize, bool vec, float cutoff2, PairParams prm) {
  constexpr int kT = kSfcTargets;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int a = blockIdx.x;
  {  // the block's system: its planes, codes and tiles
    const long long sys = blockIdx.y;
    const long long planes = sys * total;
    const long long outs = sys * gridDim.x * (long long)csize * m_c;
    x += planes;
    y += planes;
    z += planes;
    sid += planes;
    codes += sys * n_codes;
    fx += outs;
    fy += outs;
    fz += outs;
    pot += outs;
  }
  const unsigned below = (1u << lane) - 1u;
  const int tile = csize * m_c;
  const int gmax = sfc_group(tile);
  float4* slabs = reinterpret_cast<float4*>(smem);
  int* tslot = reinterpret_cast<int*>(slabs + (size_t)gmax * tile);
  int* sbase = tslot + tile;          // 32 * csize
  int* kslot = sbase + 32 * csize;    // 32
  const int* tb = tgt_base + (long long)a * csize;
  const long long o0 = (long long)a * tile;

  // 1. the segment: its start by a warp search, its end 32 codes a step
  const int lo = warp_lower_bound(codes, n_codes, a * 32);
  int hi = lo;
  for (int more = 32; more == 32; hi += more) {
    const int p = hi + lane;
    more = __popc(__ballot_sync(0xffffffffu,
                                p < n_codes && codes[p] < (a + 1) * 32));
  }

  // 2. the tile's real targets, in slot order; the empty slots' 0s
  int n_tgt = 0;
  for (int b = 0; b < tile; b += 32) {
    const int i = b + lane;
    bool kept = false;
    if (i < tile) {
      const int j = i / m_c;
      const int base = tb[j];
      kept = base < total && sid[base + i - j * m_c] >= 0;
      if (!kept) {
        fx[o0 + i] = 0.0f;
        fy[o0 + i] = 0.0f;
        fz[o0 + i] = 0.0f;
        pot[o0 + i] = 0.0f;
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, kept);
    if (kept) tslot[n_tgt + __popc(mask & below)] = i;
    n_tgt += __popc(mask);
  }
  if (n_tgt == 0) return;
  __syncwarp();

  // targets to lanes: lane (t, g) takes target t of the batch and code g
  // of each step
  int tw = 32, group = 1;
  if (n_tgt <= 16) {
    tw = 1;
    while (tw < n_tgt) tw <<= 1;
    group = min(gmax, 32 / tw);
  }
  const int tt = lane & (tw - 1), gl = lane / tw;
  unsigned long long n_visits = 0;
  for (int t0 = 0; t0 < n_tgt; t0 += tw * kT) {
    float tx[kT], ty[kT], tz[kT], ax[kT], ay[kT], az[kT], ap[kT];
    int tid[kT], tcell[kT], ts[kT];
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int t = t0 + tt + tw * j;
      ts[j] = gl < group && t < n_tgt ? tslot[t] : -1;
      tx[j] = ty[j] = tz[j] = 0.0f;
      tid[j] = -1;
      tcell[j] = 0;
      if (ts[j] >= 0) {
        tcell[j] = ts[j] / m_c;
        const int g = tb[tcell[j]] + ts[j] - tcell[j] * m_c;
        tx[j] = x[g];
        ty[j] = y[g];
        tz[j] = z[g];
        tid[j] = sid[g];
      }
      ax[j] = ay[j] = az[j] = ap[j] = 0.0f;
    }

    // 3. the kept codes, 32 at a time, and their source bases
    for (int p0 = lo; p0 < hi; p0 += 32) {
      const int p = p0 + lane;
      int code = 0;
      bool keep = false;
      if (p < hi) {
        code = codes[p];
        keep = (code & 31) < 27 && (p == lo || codes[p - 1] != code);
      }
      const unsigned km = __ballot_sync(0xffffffffu, keep);
      const int n_kept = __popc(km);
      __syncwarp();                   // the last chunk's bases are read
      if (keep) kslot[__popc(km & below)] = code & 31;
      __syncwarp();
      for (int q = lane; q < n_kept * csize; q += 32) {
        const int c = q / csize;
        sbase[q] = src_base[((long long)a * 27 + kslot[c]) * csize + q -
                            c * csize];
      }
      __syncwarp();

      // 4. G codes a step: their slabs staged, each target's own visited
      for (int c0 = 0; c0 < n_kept; c0 += group) {
        const int gs = min(group, n_kept - c0);
        stage(
            vec, gs * csize, m_c,
            [&](int s) {
              const int v = sbase[c0 * csize + s];
              return v < total ? (long long)v : -1LL;
            },
            x, y, z, sid, slabs);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          if (group > 1 && j > 0) break;     // one target a lane
          float px = 0.0f, py = 0.0f, pz = 0.0f, pp = 0.0f;
          if (ts[j] >= 0 && gl < gs)
            n_visits += visit_cell<KIND>(
                slabs + (size_t)(gl * csize + tcell[j]) * m_c, m_c, tx[j],
                ty[j], tz[j], tid[j], cutoff2, prm, px, py, pz, pp);
          if (group == 1) {
            ax[j] += px;
            ay[j] += py;
            az[j] += pz;
            ap[j] += pp;
          } else {
            for (int g = 0; g < group; ++g) {  // lane (t, 0) adds, in order
              const int from = tt + g * tw;
              const float qx = __shfl_sync(0xffffffffu, px, from);
              const float qy = __shfl_sync(0xffffffffu, py, from);
              const float qz = __shfl_sync(0xffffffffu, pz, from);
              const float qp = __shfl_sync(0xffffffffu, pp, from);
              if (g < gs) {
                ax[j] += qx;
                ay[j] += qy;
                az[j] += qz;
                ap[j] += qp;
              }
            }
          }
        }
        __syncwarp();                 // the slabs are refilled by the next
      }
    }
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (ts[j] < 0 || gl != 0) continue;
      fx[o0 + ts[j]] = ax[j];
      fy[o0 + ts[j]] = ay[j];
      fz[o0 + ts[j]] = az[j];
      pot[o0 + ts[j]] = ap[j];
    }
  }
  add_visits(visits, n_visits);
}

}  // namespace

// Kernel F. Planes x, y, z (float32) and slot_id (int32), flat, `total`
// slots a system, n_sys systems (1 <= n_sys <= 65535); codes (int32, n_sys x
// n_codes) each system's sorted, padded with n_clusters*32;
// tgt_base (int32, n_clusters x csize) and src_base (int32, n_clusters x 27
// x csize) the flat slot bases of each cluster's cells, unshifted and
// shifted by stencil slot k, `total` for the sentinel cell, one system's;
// outputs fx, fy, fz, pot (float32, n_sys x n_clusters x csize*m_c); visits (uint64, or NULL):
// adds the number of pair steps taken. A warp needs sfc_warp_smem(csize,
// m_c) bytes of shared memory, at most 227 KB. Allocates nothing and does
// not synchronise; returns the launch's cudaError_t.
extern "C" int cell_sfc_forces_f32(const void* x, const void* y,
                                   const void* z, const void* slot_id,
                                   const void* codes, const void* tgt_base,
                                   const void* src_base, void* fx, void* fy,
                                   void* fz, void* pot, void* visits,
                                   int n_sys, int n_codes, int n_clusters,
                                   int csize, int m_c, int total,
                                   float cutoff2, int kind, float p0, float p1,
                                   float p2, float p3, int n_extra,
                                   void* stream) {
  if (n_sys < 1 || n_sys > kMaxSystems || m_c < 1 || csize < 1 ||
      (long long)csize * m_c > (1 << 20) ||
      n_codes < 1 || n_clusters < 1 || total < 1)
    return cudaErrorInvalidValue;
  const size_t smem = sfc_warp_smem(csize, m_c);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const PairParams prm{p0, p1, p2, p3, n_extra};
  const bool vec = m_c % 4 == 0 && ((uintptr_t)x | (uintptr_t)y |
                                     (uintptr_t)z | (uintptr_t)slot_id) %
                                            16 == 0;
  return by_kind(kind, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const cudaError_t err = allow_smem(sfc_kernel<K>, smem);
    if (err != cudaSuccess) return err;
    sfc_kernel<K><<<dim3((unsigned)n_clusters, n_sys), 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(z), static_cast<const int*>(slot_id),
        static_cast<const int*>(codes), n_codes,
        static_cast<const int*>(tgt_base), static_cast<const int*>(src_base),
        static_cast<float*>(fx), static_cast<float*>(fy),
        static_cast<float*>(fz), static_cast<float*>(pot),
        static_cast<unsigned long long*>(visits), total, m_c, csize, vec,
        cutoff2, prm);
    return cudaGetLastError();
  });
}
