// Paper §6 inclusive prefix sum (the paper's CUDA Code 1) for int32.
//
// Replaces src/repro/kernels/prefix_sum.py::prefix_sum, the Pallas kernel
// that scans one VMEM-resident array in 2h-3 shift+mask+add passes.
//
// What bounds it on the card: bytes. A scan reads each element once and
// writes it once (8 bytes per element for n int32 adds), far below the
// card's operation rate, so at the binning's sizes (262,144 to 2,097,152
// cell counts) the least time is 8n bytes over the memory rate. At those
// sizes a call is as short as its launch, so the design spends one launch
// and no device-side allocation per call.
//
// Design: one launch, one pass, a chained scan with decoupled look-back
// (Merrill & Garland, 2016). Each block takes a ticket from an atomic
// counter as its tile index, so a tile's predecessors were all started
// before it and the look-back cannot wait on a block that is not resident.
// The block scans its tile of 2*kThreads elements in shared memory with the
// paper's schedule exactly as repro/kernels/prefix_sum.py::_levels and
// repro/core/prefix.py order it: upward levels with js doubling, then
// downward levels from max(4, js_exit/2), one __syncthreads() per level
// (2h-3 barriers, after the one that ends the load). Warp 0 then publishes
// the tile's total as an "aggregate" status word, looks back over the words
// of its predecessors, adding aggregates until it meets an "inclusive
// prefix", and publishes its own inclusive prefix; the block adds the
// exclusive prefix while it writes the tile out. The look-back reads 256
// predecessors per round, eight independent loads per lane, so at the
// binning's sizes one round trip to L2 usually reaches tile 0 (with 32 a
// round, tile 200 waited for seven in a row). The carry a tile adds is the
// same as a scan of the tile totals gives, and integer addition is
// associative, so the result is bit-identical to any other inclusive scan of
// the same int32 values.
//
// Status buffer (int64 words, owned by one stream; the wrapper caches one per
// (device, stream)): word 0 holds the launch's parity in its high half and
// the ticket counter in its low half; then two arrays of `capacity` status
// words, used by alternate launches. A launch reads and writes the array of
// its parity and zeroes the other one, which the previous launch used, so
// the next launch finds its array clean; the block that draws the last
// ticket resets the counter and flips the parity. No memset and no host-side
// state per call, so the launch is also safe to capture in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 2 * kThreads;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPerLane = 8;                   // look-back loads per lane
constexpr int kWindow = 32 * kPerLane;        // predecessors per round
constexpr uint64_t kAggregate = 1ull << 32;   // status flags (high half)
constexpr uint64_t kInclusive = 2ull << 32;

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  return *reinterpret_cast<const volatile uint64_t*>(p);
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t flag,
                                             int value) {
  *reinterpret_cast<volatile uint64_t*>(p) = flag | (uint32_t)value;
}

__global__ void __launch_bounds__(kThreads)
paper_scan_lookback(const int* in, int* out, long long n,
                    unsigned long long* control, uint64_t* status,
                    long long capacity) {
  __shared__ int s[kTile];
  __shared__ long long tile_sh;
  __shared__ int carry_sh;

  const long long n_tiles = (n + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    const unsigned long long c = atomicAdd(control, 1ull);
    const long long tile = (long long)(c & 0xffffffffull);
    const unsigned parity = (unsigned)(c >> 32) & 1u;
    tile_sh = tile | ((long long)parity << 40);
    if (tile == n_tiles - 1)                 // every ticket is drawn
      *control = (unsigned long long)(parity ^ 1u) << 32;
  }
  __syncthreads();
  const long long tile = tile_sh & ((1ll << 40) - 1);
  const int parity = (int)(tile_sh >> 40);
  uint64_t* mine = status + parity * capacity;
  uint64_t* other = status + (parity ^ 1) * capacity;

  // zero this block's share of the other parity's array for the next launch
  for (long long i = tile * kThreads + threadIdx.x; i < capacity;
       i += n_tiles * kThreads)
    other[i] = 0;

  const long long base = tile * kTile;
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

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int total = s[m - 1];
    if (tile == 0) {
      if (lane == 0) {
        store_status(mine, kInclusive, total);
        carry_sh = 0;
      }
    } else {
      if (lane == 0) store_status(mine + tile, kAggregate, total);
      unsigned carry = 0;
      long long j0 = tile - 1;              // the nearest predecessor first
      while (true) {
        // kWindow predecessors per round, kPerLane independent loads a lane:
        // word k of lane l is tile j0 - (32 k + l)
        uint64_t w[kPerLane];
        bool pending = false;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const long long j = j0 - (32 * k + lane);
          w[k] = j >= 0 ? load_status(mine + j) : kInclusive;
          pending |= (w[k] >> 32) == 0;
        }
        while (__any_sync(kFull, pending)) {        // not yet published
          pending = false;
#pragma unroll
          for (int k = 0; k < kPerLane; ++k)
            if ((w[k] >> 32) == 0) {
              w[k] = load_status(mine + (j0 - (32 * k + lane)));
              pending |= (w[k] >> 32) == 0;
            }
        }
        // the nearest inclusive word: first k whose ballot is not empty,
        // its lowest lane; words up to and including it contribute
        int stop = kWindow - 1;
        bool found = false;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const unsigned inc = __ballot_sync(kFull, (w[k] >> 32) == 2);
          if (!found && inc) {
            stop = 32 * k + __ffs(inc) - 1;
            found = true;
          }
        }
        unsigned v = 0;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k)
          if (32 * k + lane <= stop) v += (uint32_t)w[k];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        carry += v;
        if (found) break;
        j0 -= kWindow;
      }
      if (lane == 0) {
        store_status(mine + tile, kInclusive, (int)(carry + (unsigned)total));
        carry_sh = (int)carry;
      }
    }
  }
  __syncthreads();
  const unsigned carry = (unsigned)carry_sh;
  for (int i = threadIdx.x; i < m; i += kThreads)
    out[base + i] = (int)((unsigned)s[i] + carry);
}

}  // namespace

// Inclusive scan of n int32 values in one launch. `status` holds 1 + 2 *
// capacity int64 words, zeroed when first allocated and afterwards left to
// the kernel, owned by this stream; capacity >= ceil(n / 1024) (as
// repro_torch/kernels/prefix_sum.py::status_words sizes it). Allocates
// nothing and does not synchronise; returns the launch's cudaError_t.
extern "C" int paper_scan_i32(const void* in, void* out, void* status,
                              long long n, long long capacity, void* stream) {
  if (n <= 0) return cudaSuccess;
  const long long tiles = (n + kTile - 1) / kTile;
  if (capacity < tiles || tiles > 0xffffffffll) return cudaErrorInvalidValue;
  auto* words = static_cast<uint64_t*>(status);
  paper_scan_lookback<<<(unsigned)tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(in), static_cast<int*>(out), n,
      reinterpret_cast<unsigned long long*>(words), words + 1, capacity);
  return (int)cudaGetLastError();
}
