// Warp-level helpers of kernels E (allin.cu) and F (sfc.cu): cells staged
// in shared memory compacted to their real particles, and the visit of one
// staged cell.
//
// A staged cell keeps its m_c slots of shared memory (a full cell needs
// them all), as float4 (x, y, z, id bits): its real slots first, in slot
// order, then, when it holds fewer than m_c, a terminator whose id is -1.
// No counts or offsets are kept, so a cell needs no memory beyond its
// slots, and a visit reads the real sources and one terminator. An empty
// slot would add exactly +-0 to a partial sum that starts at +0, so
// visiting only the real sources, in the same ascending order, keeps every
// bit of a visit of all m_c slots.

#pragma once

#include <cuda_runtime.h>

#include "pair.cuh"

namespace pair_kernels {

// Position of the n-th (from 0) set bit of m; n < __popc(m).
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (n >= c) {
      n -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// One warp stages cells 0..n_cells-1 into dst (n_cells * m_c float4),
// each compacted as above. base(c) is the flat slot index of cell c in the
// planes x, y, z, sid, or < 0 for a cell with no slots (the sentinel cell).
// Lane l takes slot b + l of each round of 32, (c, r) its cell and rank in
// the cell, advanced by 32 slots a round without a division. A kept slot's
// place in its cell is its rank among the kept slots of the whole range
// less the rank of its cell's first slot (__ballot_sync, __popc). The
// caller synchronises the warp before it reads dst.
template <typename Base>
__device__ __forceinline__ void stage_cells(int n_cells, int m_c, Base base,
                                            const float* __restrict__ x,
                                            const float* __restrict__ y,
                                            const float* __restrict__ z,
                                            const int* __restrict__ sid,
                                            float4* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int n = n_cells * m_c;
  const int step_c = 32 / m_c, step_r = 32 - step_c * m_c;
  int c = lane / m_c, r = lane - c * m_c;
  int run = 0;     // kept slots of the rounds before this one
  int first = 0;   // rank of the first slot of the cell that holds the
                   // round's first slot, if it began in an earlier round
  for (int b = 0; b < n; b += 32) {
    long long g = -1;
    int s = -1;
    if (c < n_cells) {
      g = base(c);
      if (g >= 0) {
        g += r;
        s = sid[g];
      }
    }
    const bool kept = s >= 0;
    const unsigned mask = __ballot_sync(0xffffffffu, kept);
    const int rank = run + __popc(mask & below);
    const int st = lane - r;   // this round's lane of the cell's first slot
    const int start =
        st >= 0 ? run + __popc(mask & ((1u << st) - 1u)) : first;
    float4* cell = dst + (size_t)c * m_c;
    if (kept)
      cell[rank - start] = make_float4(x[g], y[g], z[g], __int_as_float(s));
    if (c < n_cells && r == m_c - 1) {
      const int count = rank - start + (kept ? 1 : 0);
      if (count < m_c)
        cell[count] = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(-1));
    }
    c += step_c;
    r += step_r;
    if (r >= m_c) {
      r -= m_c;
      ++c;
    }
    // the cell of the next round's first slot began at this round's lane
    // 32 - r0 (0 < r0 <= 32), in an earlier round (r0 > 32), or begins
    // with the next round (r0 == 0)
    const int r0 = __shfl_sync(0xffffffffu, r, 0);
    if (r0 > 0 && r0 <= 32)
      first = run + __popc(mask & ((1u << (32 - r0)) - 1u));
    run += __popc(mask);
  }
}

// stage_cells for m_c % 4 == 0 and 16-byte aligned planes: lane l takes the
// four slots of group b + l, their ids and positions in four 16-byte loads
// issued together (no load waits on another; the positions of empty slots
// are read too), so a round covers 128 slots; a lane's kept slots take
// their ranks from a warp scan of the lanes' counts (__shfl_up_sync).
template <typename Base>
__device__ __forceinline__ void stage_cells4(int n_cells, int m_c, Base base,
                                             const float* __restrict__ x,
                                             const float* __restrict__ y,
                                             const float* __restrict__ z,
                                             const int* __restrict__ sid,
                                             float4* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  const int m4 = m_c >> 2;                 // groups of 4 slots a cell
  const int n = n_cells * m4;
  const int step_c = 32 / m4, step_r = 32 - step_c * m4;
  int c = lane / m4, r = lane - c * m4;
  int run = 0, first = 0;
  for (int b = 0; b < n; b += 32) {
    long long g = -1;
    int4 s = make_int4(-1, -1, -1, -1);
    float4 px = make_float4(0.0f, 0.0f, 0.0f, 0.0f), py = px, pz = px;
    if (c < n_cells) {
      g = base(c);
      if (g >= 0) {
        g += 4 * r;
        s = *reinterpret_cast<const int4*>(sid + g);
        px = *reinterpret_cast<const float4*>(x + g);
        py = *reinterpret_cast<const float4*>(y + g);
        pz = *reinterpret_cast<const float4*>(z + g);
      }
    }
    const float cx[4] = {px.x, px.y, px.z, px.w};
    const float cy[4] = {py.x, py.y, py.z, py.w};
    const float cz[4] = {pz.x, pz.y, pz.z, pz.w};
    const int id[4] = {s.x, s.y, s.z, s.w};
    const int count =
        (id[0] >= 0) + (id[1] >= 0) + (id[2] >= 0) + (id[3] >= 0);
    int incl = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    const int excl = incl - count;
    const int st = lane - r;   // this round's lane of the cell's first group
    const int at_st = __shfl_sync(0xffffffffu, excl, st < 0 ? 0 : st);
    const int start = st >= 0 ? run + at_st : first;
    float4* cell = dst + (size_t)c * m_c;
    int pos = run + excl - start;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (id[q] >= 0)
        cell[pos++] = make_float4(cx[q], cy[q], cz[q], __int_as_float(id[q]));
    if (c < n_cells && r == m4 - 1 && pos < m_c)
      cell[pos] = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(-1));
    c += step_c;
    r += step_r;
    if (r >= m4) {
      r -= m4;
      ++c;
    }
    // as in stage_cells, by groups: the next round's first cell began at
    // lane 32 - r0, earlier, or with the next round
    const int r0 = __shfl_sync(0xffffffffu, r, 0);
    const int at_next = __shfl_sync(0xffffffffu, excl, (32 - r0) & 31);
    if (r0 > 0 && r0 <= 32) first = run + at_next;
    run += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// stage_cells, or stage_cells4 where vec (m_c % 4 == 0 and the four planes
// 16-byte aligned); both give the same staged cells.
template <typename Base>
__device__ __forceinline__ void stage(bool vec, int n_cells, int m_c,
                                      Base base, const float* __restrict__ x,
                                      const float* __restrict__ y,
                                      const float* __restrict__ z,
                                      const int* __restrict__ sid,
                                      float4* __restrict__ dst) {
  if (vec)
    stage_cells4(n_cells, m_c, base, x, y, z, sid, dst);
  else
    stage_cells(n_cells, m_c, base, x, y, z, sid, dst);
}

// Adds the real sources of one staged cell to the partial sums, in slot
// order; returns how many it visited.
template <int KIND>
__device__ __forceinline__ int visit_cell(const float4* cell, int m_c,
                                          float tx, float ty, float tz,
                                          int tid, float cutoff2,
                                          const PairParams& prm, float& px,
                                          float& py, float& pz, float& pp) {
  int i = 0;
  for (; i < m_c; ++i) {
    const float4 q = cell[i];
    const int s = __float_as_int(q.w);
    if (s < 0) break;
    pair_step<KIND>(tx, ty, tz, tid, q.x, q.y, q.z, s, cutoff2, prm, px, py,
                    pz, pp);
  }
  return i;
}

// Adds the warp's visit counts to *visits (when the caller gave a counter).
__device__ __forceinline__ void add_visits(unsigned long long* visits,
                                           unsigned long long n) {
  if (visits == nullptr) return;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) n += __shfl_down_sync(0xffffffffu, n, d);
  if ((threadIdx.x & 31) == 0 && n > 0) atomicAdd(visits, n);
}

}  // namespace pair_kernels
