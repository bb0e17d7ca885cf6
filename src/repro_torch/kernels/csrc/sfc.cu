// SFC cluster-pair cutoff forces (layout="sfc") in float32: kernel F.
//
// Replaces src/repro/kernels/sfc.py::cell_sfc_forces (Pallas grid
// (pair_cap,): one program per sorted pair code cluster*32 + k, the
// cluster's output tile resident across its consecutive codes and zeroed
// at its first code; source slabs read from the whole staged planes through
// a scalar-prefetched slot-offset table).
//
// Design: one block per cluster a, on a flat grid of n_clusters blocks, one
// thread per target slot of the csize*m_c tile (thread t: cell j = t / m_c
// of the cluster, rank r = t % m_c). Hopper blocks run in no order and
// carry nothing between them, so the TPU's resident tile becomes a block
// that owns its cluster: two threads binary-search the sorted codes for the
// cluster's segment [a*32, (a+1)*32) (sentinel codes n_clusters*32 sort
// past every segment), and the block walks the segment in ascending order.
// For each kept code (stencil slot k) the block stages the csize source
// slabs of m_c slots (x, y, z, id: 16 B a slot) of its cells shifted by k
// into shared memory and synchronises; each thread then reduces its own
// slab j in ascending source order with the shared pair_step (pair.cuh)
// into a partial, and adds the partial to its accumulator. A slot base
// past the planes (total) is the always-empty sentinel cell: its slots
// stage as empty, so no sentinel block is appended to the planes. A
// cluster with no kept code, and an empty target slot, write zeros. No
// atomics, no first-code flags and no ghost row: the TPU wrapper's mask of
// unvisited rows has no twin here.
//
// Per target, the sum runs over the kept slabs in ascending k; a slab that
// is not kept is empty and adds exactly nothing (a partial that starts at
// +0 and adds +-0 stays +0). So per particle kernel F gives the same bits
// whatever the curve, the cluster size or pair_cap (as long as nothing was
// truncated). It is not kernel B's bits: B sums one 3*m_c window per
// (dz, dy) row, F one m_c slab per k.
//
// What bounds it on the card: operations. On the uniform scene every code
// is kept, and F evaluates 27*m_c candidate slots per occupied target, the
// 9*3*m_c of kernel B; the bytes (planes, the 27*csize slot bases of each
// kept code, the tiles written once) take far less time. On a clustered
// scene the pair list drops the empty neighbourhoods, so F's work follows
// the occupied clusters. Skipping the empty tail of each slab, and staging
// the next slab while this one is reduced, are later work.

#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

using namespace pair_kernels;

constexpr int kMaxThreads = 1024;

// First index of the sorted codes[0, n) that is >= key.
__device__ __forceinline__ int lower_bound(const int* __restrict__ codes,
                                           int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (codes[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
sfc_kernel(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ z, const int* __restrict__ sid,
           const int* __restrict__ codes, int n_codes,
           const int* __restrict__ tgt_base, const int* __restrict__ src_base,
           float* __restrict__ fx, float* __restrict__ fy,
           float* __restrict__ fz, float* __restrict__ pot, int total,
           int m_c, int csize, float cutoff2, PairParams prm) {
  extern __shared__ float stage[];
  const int tile = csize * m_c;
  float* sx = stage;
  float* sy = sx + tile;
  float* sz = sy + tile;
  int* ss = reinterpret_cast<int*>(sz + tile);
  __shared__ int seg[2];

  const int a = blockIdx.x;
  const int t = threadIdx.x;
  const int j = t / m_c;
  const int r = t - j * m_c;
  if (t < 2) seg[t] = lower_bound(codes, n_codes, (a + t) * 32);
  if (blockDim.x == 1) seg[1] = lower_bound(codes, n_codes, (a + 1) * 32);

  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  int tid = -1;
  const int tb = tgt_base[(long long)a * csize + j];
  if (tb < total) {
    tx = x[tb + r];
    ty = y[tb + r];
    tz = z[tb + r];
    tid = sid[tb + r];
  }
  __syncthreads();
  const int lo = seg[0], hi = seg[1];

  float ax = 0.0f, ay = 0.0f, az = 0.0f, ap = 0.0f;
  const long long src_row = (long long)a * 27 * csize + j;
  const int s0 = j * m_c;  // this thread's slab in the stage
  for (int p = lo; p < hi; ++p) {
    const int k = codes[p] & 31;
    const int sb = src_base[src_row + (long long)k * csize];
    if (sb < total) {
      sx[t] = x[sb + r];
      sy[t] = y[sb + r];
      sz[t] = z[sb + r];
      ss[t] = sid[sb + r];
    } else {
      sx[t] = sy[t] = sz[t] = 1.0e8f;  // EMPTY_POS
      ss[t] = -1;
    }
    __syncthreads();
    if (tid >= 0) {
      float px = 0.0f, py = 0.0f, pz = 0.0f, pp = 0.0f;
      for (int i = s0; i < s0 + m_c; ++i)
        pair_step<KIND>(tx, ty, tz, tid, sx[i], sy[i], sz[i], ss[i], cutoff2,
                        prm, px, py, pz, pp);
      ax += px;
      ay += py;
      az += pz;
      ap += pp;
    }
    __syncthreads();  // the stage is refilled by the next code
  }
  const long long o = (long long)a * tile + t;
  fx[o] = ax;
  fy[o] = ay;
  fz[o] = az;
  pot[o] = ap;
}

}  // namespace

// Kernel F. Planes x, y, z (float32) and slot_id (int32), flat, `total`
// slots; codes (int32, n_codes) sorted, padded with n_clusters*32;
// tgt_base (int32, n_clusters x csize) and src_base (int32, n_clusters x 27
// x csize) the flat slot bases of each cluster's cells, unshifted and
// shifted by stencil slot k, `total` for the sentinel cell; outputs fx, fy,
// fz, pot (float32, n_clusters x csize*m_c). csize*m_c <= 1024 threads.
// Allocates nothing and does not synchronise; returns the launch's
// cudaError_t.
extern "C" int cell_sfc_forces_f32(const void* x, const void* y,
                                   const void* z, const void* slot_id,
                                   const void* codes, const void* tgt_base,
                                   const void* src_base, void* fx, void* fy,
                                   void* fz, void* pot, int n_codes,
                                   int n_clusters, int csize, int m_c,
                                   int total, float cutoff2, int kind,
                                   float p0, float p1, float p2, float p3,
                                   int n_extra, void* stream) {
  if (m_c < 1 || csize < 1 || csize * m_c > kMaxThreads || n_codes < 1 ||
      n_clusters < 1 || total < 1)
    return cudaErrorInvalidValue;
  const int threads = csize * m_c;
  const size_t smem = (size_t)16 * threads;
  const PairParams prm{p0, p1, p2, p3, n_extra};
  return by_kind(kind, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    sfc_kernel<K><<<(unsigned)n_clusters, threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(z), static_cast<const int*>(slot_id),
        static_cast<const int*>(codes), n_codes,
        static_cast<const int*>(tgt_base), static_cast<const int*>(src_base),
        static_cast<float*>(fx), static_cast<float*>(fy),
        static_cast<float*>(fz), static_cast<float*>(pot), total, m_c, csize,
        cutoff2, prm);
    return cudaGetLastError();
  });
}
