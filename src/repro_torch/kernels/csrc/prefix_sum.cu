// Paper §6 inclusive prefix sum (the paper's CUDA Code 1) for int32.
//
// Replaces src/repro/kernels/prefix_sum.py::prefix_sum, the Pallas kernel
// that scans one VMEM-resident array in 2h-3 shift+mask+add passes.
//
// What bounds it on the card: bytes. A scan reads each element once and
// writes it once (8 bytes per element for n int32 adds), far below the
// card's operation rate, so at the binning's sizes (262,144 to 2,097,152
// cell counts) the least time is 8n bytes over the memory rate.
//
// Design: one block of kThreads threads scans a tile of 2*kThreads elements
// in shared memory with the paper's schedule exactly as
// repro/kernels/prefix_sum.py::_levels and repro/core/prefix.py order it:
// upward levels with js doubling, then downward levels from max(4, js_exit/2),
// one __syncthreads() per level (2h-3 barriers, after the one that ends the
// load). Each thread updates at most one element per level. Longer arrays
// compose tiles in three passes: (1) per-tile scan writing each tile's total,
// (2) the same scan on the totals, recursively until one tile remains,
// (3) each tile adds the inclusive total of the tiles before it. Every
// tile is read from and written to device memory once per pass, which is
// what a later, fused single-pass (decoupled look-back) scan would remove.
// Integer addition is associative, so the result is bit-identical to any
// other inclusive scan of the same int32 values.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 2 * kThreads;

__global__ void __launch_bounds__(kThreads)
paper_scan_tiles(const int* in, int* out, int* totals, long long n) {
  __shared__ int s[kTile];
  const long long base = (long long)blockIdx.x * kTile;
  const int m = (int)min((long long)kTile, n - base);
  for (int i = threadIdx.x; i < m; i += kThreads) s[i] = in[base + i];
  __syncthreads();

  // Upward pass: element js-1, 2js-1, ... absorbs the partial sum js/2 to
  // its left; right-spine elements are final after it.
  int js = 2;
  for (; js <= m; js *= 2) {
    const int idx = js - 1 + threadIdx.x * js;
    if (idx < m) s[idx] += s[idx - js / 2];
    __syncthreads();
  }
  // Downward pass: propagate each node's value to the element halfway into
  // the next block. `start < m` is the same for every thread of the block,
  // so the barrier is never divergent.
  for (js = max(4, js / 2); js > 1; js /= 2) {
    const int jsd2 = js / 2;
    const int start = js + jsd2 - 1;
    if (start < m) {
      const int idx = start + threadIdx.x * js;
      if (idx < m) s[idx] += s[idx - jsd2];
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < m; i += kThreads) out[base + i] = s[i];
  if (totals != nullptr && threadIdx.x == 0) totals[blockIdx.x] = s[m - 1];
}

// Tile b >= 1 adds the inclusive total of tiles 0..b-1.
__global__ void add_carry(int* data, const int* scanned_totals, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = kTile + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    data[i] += scanned_totals[i / kTile - 1];
  }
}

cudaError_t scan(const int* in, int* out, int* scratch, long long n,
                 long long scratch_elems, cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 1 && scratch_elems < tiles) return cudaErrorInvalidValue;
  int* totals = tiles > 1 ? scratch : nullptr;
  paper_scan_tiles<<<(unsigned)tiles, kThreads, 0, stream>>>(in, out, totals,
                                                             n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  // the totals are scanned in place; their own totals go after them
  err = scan(totals, totals, scratch + tiles, tiles, scratch_elems - tiles,
             stream);
  if (err != cudaSuccess) return err;
  const long long rest = n - kTile;
  const long long want = (rest + 255) / 256;
  const unsigned blocks = (unsigned)(want < 8192 ? want : 8192);
  add_carry<<<blocks, 256, 0, stream>>>(out, totals, n);
  return cudaGetLastError();
}

}  // namespace

// Inclusive scan of n int32 values. `scratch` holds scratch_elems int32:
// ceil(n/T) + ceil(n/T^2) + ... until one tile remains (T = 1024), as
// repro_torch/kernels/prefix_sum.py::scratch_elems computes. Allocates
// nothing and does not synchronise; returns the launches' cudaError_t.
extern "C" int paper_scan_i32(const void* in, void* out, void* scratch,
                              long long n, long long scratch_elems,
                              void* stream) {
  if (n <= 0) return cudaSuccess;
  return (int)scan(static_cast<const int*>(in), static_cast<int*>(out),
                   static_cast<int*>(scratch), n, scratch_elems,
                   static_cast<cudaStream_t>(stream));
}
