// Causal sliding-window attention, flash-style, fp32 arithmetic: kernel G.
//
// Replaces src/repro/kernels/window_attn.py::window_attention (Pallas grid
// (B*H, nq, nw): one program per (head, query block, KV block), the
// online-softmax state m, l, acc carried in VMEM scratch across the
// sequential third axis). It computes what that kernel computes: scores
// (q * D^-0.5) . k^T in fp32, an optional softcap c * tanh(s / c), the mask
// k <= q and q - k < window, an online softmax in fp32, o = acc / max(l,
// 1e-30) in q's dtype; query head h reads KV head h / (H / KH).
//
// Design: the Pallas grid's sequential carry becomes a loop inside one
// block. One block of 4 warps owns one (batch, head) and a tile of 32
// consecutive queries, staged once in shared memory as fp32 times the
// scale; it loops over the 32-key tiles that intersect (q0 - window,
// q_last], the paper's X-pencil on a 1-D token grid: the query tile is the
// resident target, the KV tiles of the window stream through shared memory
// one at a time, and a tile wholly outside the window is never loaded. Each
// warp owns 8 query rows and keeps their m, l and accumulators (D / 32 per
// lane) in registers. Scores: lane j takes key j of the tile, against the
// warp's 8 rows (a float4 of K, 8 broadcast float4s of Q, 32 FMA). Online
// softmax: warp max and sum by shuffles; a masked score is -1e30 and its
// probability is set to exactly 0, so a tile that is masked for a row adds
// nothing to it (no NaN can appear, and no exp(0) term waits for a later
// rescale as in the Pallas kernel). P.V: lane c takes output columns c, c +
// 32, ...; each probability is broadcast by a shuffle. A warp skips the
// arithmetic of a tile that none of its rows sees. Ragged tiles (S not a
// multiple of 32) are masked and zero-filled here.
//
// What bounds it on the card: operations. Each in-window (q, k) pair costs
// 4 * D FLOP (2 D for q.k, 2 D for p.v); at gemma2-2b's local layers (S =
// 8192, window 4096, H = 8, D = 256) that is 206.2 GFLOP per sequence, a
// bound of 0.208 ms against the 989 TFLOP/s of bf16 tensor cores, while
// q, k, v and o (100.7 MB) bound it at 0.030 ms only. This body keeps the
// arithmetic on the CUDA cores in fp32 (67 TFLOP/s, so at least 3.1 ms per
// sequence), with shared-memory traffic near the FMA rate. It is kernel G's
// route for fp32 inputs (TF32 tensor cores would miss the fp32 tolerance)
// and for bf16 head dims that are not a multiple of 16; bf16 with D % 16 ==
// 0 runs on the tensor cores (window_attn_sm90.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                   // query rows per warp
constexpr int kBQ = kWarps * kRows;        // query rows per block
constexpr int kBK = 32;                    // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr size_t kMaxSmem = 232448;        // 227 KB a block may opt in to
constexpr float kNegInf = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);                // round to nearest even
}

// Row stride of the Q and K tiles in floats: D rounded up to float4s, an
// odd number of them, so the 32 lanes' float4 loads of K rows hit distinct
// banks in every 8-lane phase.
__host__ __device__ inline int padded_d(int d) {
  return 4 * (((d + 3) / 4) | 1);
}

__host__ inline size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * padded_d(d) +
                          (size_t)kBK * d);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// DPL: output columns per lane, ceil(D / 32) rounded up to 1, 2, 4 or 8.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
window_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                   int S, int D, int window, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_d(D);
  const int d4 = (D + 3) / 4;
  float* qs = smem;                        // (kBQ, dp)
  float* ks = qs + kBQ * dp;               // (kBK, dp)
  float* vs = ks + kBK * dp;               // (kBK, D)

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * kBQ;
  const int q_last = min(q0 + kBQ, S) - 1;
  const long long head = (long long)S * D;
  const T* qb = q + bh * head;
  const T* kb = k + ((long long)b * KH + kvh) * head;
  const T* vb = v + ((long long)b * KH + kvh) * head;
  T* ob = o + bh * head;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kBQ; r += kWarps)
    for (int c = lane; c < dp; c += 32)
      qs[r * dp + c] = (c < D && q0 + r < S)
                           ? to_f32(qb[(long long)(q0 + r) * D + c]) * scale
                           : 0.0f;

  const int row0 = q0 + warp * kRows;      // this warp's first query
  const int row_last = min(row0 + kRows, S) - 1;
  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }

  const int lo = max(0, q0 - window + 1);  // first key any row sees
  for (int t = (lo / kBK) * kBK; t <= q_last; t += kBK) {
    __syncthreads();                       // the previous tile is consumed
    for (int r = warp; r < kBK; r += kWarps) {
      const bool in = t + r < S;
      for (int c = lane; c < dp; c += 32)
        ks[r * dp + c] = (in && c < D)
                             ? to_f32(kb[(long long)(t + r) * D + c])
                             : 0.0f;
      for (int c = lane; c < D; c += 32)
        vs[r * D + c] = in ? to_f32(vb[(long long)(t + r) * D + c]) : 0.0f;
    }
    __syncthreads();
    // warp-uniform: no row of this warp sees a key of this tile
    if (row0 > row_last || t > row_last || t + kBK - 1 < row0 - window + 1)
      continue;

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const float4* kr = reinterpret_cast<const float4*>(ks + lane * dp);
    const float* qw = qs + warp * kRows * dp;
    for (int c4 = 0; c4 < d4; ++c4) {
      const float4 kk = kr[c4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(qw + r * dp)[c4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int key = t + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = row0 + r;
      const bool ok = qpos < S && key <= qpos && qpos - key < window;
      float x = s[r];
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      x = ok ? x : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = ok ? expf(x - m_new) : 0.0f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      s[r] = p;
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        vv[i] = c < D ? vs[j * D + c] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = row0 + r;
    if (qpos >= S) break;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) store(ob + (long long)qpos * D + c, acc[r][i] / den);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KH, int S, int D, int window,
                   float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_kernel<T, DPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)(B * H));
  window_attn_kernel<T, DPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, S, D, window,
      softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KH, int S, int D, int window,
                     float softcap, float scale, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 1>(q, k, v, o, B, H, KH, S, D, window, softcap, scale,
                        stream);
  if (D <= 64)
    return launch<T, 2>(q, k, v, o, B, H, KH, S, D, window, softcap, scale,
                        stream);
  if (D <= 128)
    return launch<T, 4>(q, k, v, o, B, H, KH, S, D, window, softcap, scale,
                        stream);
  return launch<T, 8>(q, k, v, o, B, H, KH, S, D, window, softcap, scale,
                      stream);
}

}  // namespace

// Kernel G. q, o of shape (B, H, S, D), k, v of shape (B, KH, S, D), all
// contiguous, of one dtype: float32 (bf16 = 0) or bfloat16 (bf16 = 1).
// H % KH == 0, 1 <= D <= 256, window >= 1; softcap <= 0 means none; scale
// multiplies q (D^-0.5). Needs 4 * (64 * padded_d(D) + 32 * D) bytes of
// shared memory (99,328 B at D = 256). Allocates nothing and does not
// synchronise; returns the launch's cudaError_t.
extern "C" int window_attention_fwd(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int KH, int S, int D, int window,
                                    float softcap, float scale, int bf16,
                                    void* stream) {
  if (B < 1 || S < 1) return cudaSuccess;
  if (H < 1 || KH < 1 || H % KH || D < 1 || D > kMaxD || window < 1 ||
      (long long)B * H > 65535 || smem_bytes(D) > kMaxSmem)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return by_width<__nv_bfloat16>(q, k, v, o, B, H, KH, S, D, window,
                                   softcap, scale, st);
  return by_width<float>(q, k, v, o, B, H, KH, S, D, window, softcap, scale,
                         st);
}
