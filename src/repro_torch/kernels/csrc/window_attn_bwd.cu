// Backward of causal sliding-window attention, fp32 arithmetic: kernel Gb.
//
// Replaces no TPU kernel. The JAX package trains gemma2's local layers
// through XLA's autodiff of the plain window_attention_blocked
// (src/repro/models/model.py); the port's local layers run kernel G
// (window_attn.cu, window_attn_sm90.cu) instead, and this is G's gradient,
// so that loss.backward() runs on the card without the plain version.
//
// What it computes, for q, out, dout of shape (B, H, S, D) and k, v of shape
// (B, KH, S, D), query head h reading KV head h / (H / KH), scale = D^-0.5:
//   s_ij = (q_i * scale) . k_j, c_ij = cap * tanh(s_ij / cap) (cap > 0) or
//   s_ij, key j visible to query i when j <= i and i - j < window;
//   lse_i = log sum_j exp(c_ij) over the visible keys, P_ij = exp(c_ij -
//   lse_i) (0 where not visible), delta_i = dout_i . out_i;
//   dV_j = sum_i P_ij dout_i,  dC_ij = P_ij (dout_i . v_j - delta_i),
//   dS_ij = dC_ij (1 - t^2), t = clip(c_ij / cap, -1, 1) (cap > 0),
//   dQ_i = scale * sum_j dS_ij k_j,  dK_j = sum_i dS_ij (q_i * scale),
// with dK and dV summed over the H / KH query heads of a group. All in fp32;
// dq, dk, dv are written in the inputs' dtype (fp32 or bf16). delta uses the
// forward's out, as JAX's _flash_bwd does. A masked score gives P = 0 and
// dS = 0 exactly, so no -1e30 reaches an exp or the softcap derivative.
//
// Design: three launches on the caller's stream, no atomics, so the result
// is the same bit for bit from run to run.
//   (i)   stats: one block of 8 warps per (batch, head, 32-query tile); the
//         32-key tiles of the tile's window stream through shared memory as
//         in kernel G's SIMT body, an online max and sum per row give lse;
//         delta is a warp sum over D. Both to fp32 scratch (B, H, S).
//   (ii)  dK, dV: one block per (batch, KV head, 32-key tile), K and V
//         resident; it loops over the H / KH heads of the group and the
//         32-query tiles whose window reaches the key tile (queries k0 ...
//         k_last + window - 1). Per query tile: Q (times scale) and dout
//         staged in shared memory, S and dout . V^T computed with lane j on
//         key j against the warp's 4 rows, P and dS written to shared
//         memory, then each warp accumulates 4 keys' dK and dV rows in
//         registers (lane c on columns c, c + 32, ...). The GQA sum is the
//         loop over heads inside the block.
//   (iii) dQ: one block per (batch, head, 32-query tile), Q and dout
//         resident, over the key tiles of its window; dS broadcast by
//         shuffles as kernel G broadcasts P, dQ rows in registers.
// Tiles are zero-filled past S and masked, so S needs no multiple of 32.
//
// What bounds it on the card: operations. The gradient needs 10 D FLOP per
// visible pair (recompute q.k, dout.v, and the products for dV, dK, dQ); at
// gemma2-2b's local layers (B = 2, H = 8, KH = 4, S = 8192, D = 256, window
// 4096: 402,685,952 pairs) that is 1030.9 GFLOP, 1.042 ms at 989 TFLOP/s of
// bf16 tensor cores. This design recomputes the scores three times (16 D
// FLOP a pair) on the CUDA cores in fp32 (67 TFLOP/s, so at least 24.6 ms):
// a simple body that is right first; its rebuild on wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 32;                    // query rows per tile
constexpr int kBK = 32;                    // keys per tile: one per lane
constexpr int kRows = kBQ / kWarps;        // query rows per warp (scores)
constexpr int kKeys = kBK / kWarps;        // keys per warp (dK, dV sums)
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

// Row stride of a staged tile in floats: D rounded up to an odd number of
// float4s, so 32 lanes reading a float4 of 32 different rows hit distinct
// banks in every 8-lane phase (kernel G's layout).
__host__ __device__ inline int padded_d(int d) {
  return 4 * (((d + 3) / 4) | 1);
}

// Shared memory of each launch, in bytes.
__host__ inline size_t stats_smem(int d) {
  return sizeof(float) * (size_t)(kBQ + kBK) * padded_d(d);
}
__host__ inline size_t dkdv_smem(int d) {
  return sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) * padded_d(d) +
                          2 * kBQ * kBK + 2 * kBQ);
}
__host__ inline size_t dq_smem(int d) {
  return sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) * padded_d(d) +
                          2 * kBQ);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Stage rows row0 ... row0 + 31 of a (S, D) matrix into dst (32, dp) as
// fp32 times mul; rows past S and columns past D are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S, int D, int dp, float mul) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < 32; r += kWarps) {
    const bool in = row0 + r < S;
    for (int c = lane; c < dp; c += 32)
      dst[r * dp + c] =
          (in && c < D) ? to_f32(src[(long long)(row0 + r) * D + c]) * mul
                        : 0.0f;
  }
}

// out[r] = a_r . b_lane for the warp's kRows rows a (broadcast, stride dp)
// and this lane's row b.
__device__ __forceinline__ void dots(const float* a, const float* b, int dp,
                                     int d4, float (&out)[kRows]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r] = 0.0f;
  const float4* br = reinterpret_cast<const float4*>(b + lane * dp);
  for (int c4 = 0; c4 < d4; ++c4) {
    const float4 bb = br[c4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 aa = reinterpret_cast<const float4*>(a + r * dp)[c4];
      out[r] = fmaf(aa.x, bb.x, out[r]);
      out[r] = fmaf(aa.y, bb.y, out[r]);
      out[r] = fmaf(aa.z, bb.z, out[r]);
      out[r] = fmaf(aa.w, bb.w, out[r]);
    }
  }
}

__device__ __forceinline__ bool visible(int qpos, int key, int S,
                                        int window) {
  return qpos < S && key <= qpos && qpos - key < window;
}

// P and dS of the warp's rows (first row `row0`, local index `lrow0`)
// against this lane's key, from the scores s and dout . v products dp.
__device__ __forceinline__ void p_and_ds(const float (&s)[kRows],
                                         const float (&dp)[kRows], int row0,
                                         int lrow0, int key, int S,
                                         int window, float softcap,
                                         const float* lse_s,
                                         const float* delta_s,
                                         float (&p)[kRows],
                                         float (&ds)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool ok = visible(row0 + r, key, S, window);
    float c = s[r];
    if (softcap > 0.0f) c = softcap * tanhf(c / softcap);
    p[r] = ok ? expf(c - lse_s[lrow0 + r]) : 0.0f;
    float g = p[r] * (dp[r] - delta_s[lrow0 + r]);
    if (softcap > 0.0f) {
      const float t = fminf(fmaxf(c / softcap, -1.0f), 1.0f);
      g *= 1.0f - t * t;
    }
    ds[r] = ok ? g : 0.0f;
  }
}

// (i) lse and delta of one (batch, head) tile of 32 queries.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ lse, float* __restrict__ delta, int H,
                 int KH, int S, int D, int window, float softcap,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_d(D), d4 = (D + 3) / 4;
  float* qs = smem;                        // (kBQ, dp)
  float* ks = qs + kBQ * dp;               // (kBK, dp)

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * kBQ;
  const int q_last = min(q0 + kBQ, S) - 1;
  const long long head = (long long)S * D;
  const T* kb = k + ((long long)b * KH + kvh) * head;
  load_tile(qs, q + bh * head, q0, S, D, dp, scale);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = q0 + warp * kRows;
  const int row_last = min(row0 + kRows, S) - 1;
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
  }
  const int lo = max(0, q0 - window + 1);
  for (int t = (lo / kBK) * kBK; t <= q_last; t += kBK) {
    __syncthreads();                       // the previous tile is consumed
    load_tile(ks, kb, t, S, D, dp, 1.0f);
    __syncthreads();
    // warp-uniform: no row of this warp sees a key of this tile
    if (row0 > row_last || t > row_last || t + kBK - 1 < row0 - window + 1)
      continue;
    float s[kRows];
    dots(qs + warp * kRows * dp, ks, dp, d4, s);
    const int key = t + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = visible(row0 + r, key, S, window);
      float x = s[r];
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      x = ok ? x : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = ok ? expf(x - m_new) : 0.0f;
      l[r] = l[r] * expf(m[r] - m_new) + warp_sum(p);
      m[r] = m_new;
    }
  }

  const T* ob = out + bh * head;
  const T* dob = dout + bh * head;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = row0 + r;
    if (qpos >= S) break;                  // warp-uniform
    float acc = 0.0f;
    for (int c = lane; c < D; c += 32)
      acc = fmaf(to_f32(dob[(long long)qpos * D + c]),
                 to_f32(ob[(long long)qpos * D + c]), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      lse[(long long)bh * S + qpos] = m[r] + logf(fmaxf(l[r], 1e-30f));
      delta[(long long)bh * S + qpos] = acc;
    }
  }
}

// Stage lse and delta of rows row0 ... row0 + 31 of head bh (0 past S).
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* lse,
                                           const float* delta, long long bh,
                                           int row0, int S) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = row0 + r < S;
    lse_s[r] = in ? lse[bh * S + row0 + r] : 0.0f;
    delta_s[r] = in ? delta[bh * S + row0 + r] : 0.0f;
  }
}

// (ii) dK and dV of one (batch, KV head) tile of 32 keys, summed over the
// group's query heads. DPL: output columns per lane, 1, 2, 4 or 8.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int H, int KH, int S, int D, int window,
                float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_d(D), d4 = (D + 3) / 4;
  float* qs = smem;                        // (kBQ, dp), q * scale
  float* dos = qs + kBQ * dp;              // (kBQ, dp)
  float* ks = dos + kBQ * dp;              // (kBK, dp)
  float* vs = ks + kBK * dp;               // (kBK, dp)
  float* ps = vs + kBK * dp;               // (kBQ, kBK)
  float* dss = ps + kBQ * kBK;             // (kBQ, kBK)
  float* lse_s = dss + kBQ * kBK;          // (kBQ)
  float* delta_s = lse_s + kBQ;            // (kBQ)

  const int bkh = blockIdx.y;
  const int b = bkh / KH, kvh = bkh - b * KH;
  const int group = H / KH;
  const int k0 = blockIdx.x * kBK;
  const int k_last = min(k0 + kBK, S) - 1;
  const long long head = (long long)S * D;
  load_tile(ks, k + bkh * head, k0, S, D, dp, 1.0f);
  load_tile(vs, v + bkh * head, k0, S, D, dp, 1.0f);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc_k[kKeys][DPL], acc_v[kKeys][DPL];
#pragma unroll
  for (int j = 0; j < kKeys; ++j)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_k[j][i] = acc_v[j][i] = 0.0f;

  // the last query that sees a key of this tile
  const int i_end = (int)min((long long)S - 1, (long long)k_last + window - 1);
  for (int g = 0; g < group; ++g) {
    const long long bh = (long long)b * H + kvh * group + g;
    const T* qb = q + bh * head;
    const T* dob = dout + bh * head;
    for (int i0 = k0; i0 <= i_end; i0 += kBQ) {
      __syncthreads();                     // the previous tile is consumed
      load_tile(qs, qb, i0, S, D, dp, scale);
      load_tile(dos, dob, i0, S, D, dp, 1.0f);
      load_stats(lse_s, delta_s, lse, delta, bh, i0, S);
      __syncthreads();
      float s[kRows], dpv[kRows], p[kRows], ds[kRows];
      dots(qs + warp * kRows * dp, ks, dp, d4, s);
      dots(dos + warp * kRows * dp, vs, dp, d4, dpv);
      p_and_ds(s, dpv, i0 + warp * kRows, warp * kRows, k0 + lane, S, window,
               softcap, lse_s, delta_s, p, ds);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        ps[(warp * kRows + r) * kBK + lane] = p[r];
        dss[(warp * kRows + r) * kBK + lane] = ds[r];
      }
      __syncthreads();
      for (int r = 0; r < kBQ; ++r) {
        float qv[DPL], dov[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int c = lane + 32 * i;
          qv[i] = c < D ? qs[r * dp + c] : 0.0f;
          dov[i] = c < D ? dos[r * dp + c] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const float pj = ps[r * kBK + warp * kKeys + j];
          const float dsj = dss[r * kBK + warp * kKeys + j];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            acc_v[j][i] = fmaf(pj, dov[i], acc_v[j][i]);
            acc_k[j][i] = fmaf(dsj, qv[i], acc_k[j][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const int key = k0 + warp * kKeys + j;
    if (key >= S) break;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) {
        store(dk + bkh * head + (long long)key * D + c, acc_k[j][i]);
        store(dv + bkh * head + (long long)key * D + c, acc_v[j][i]);
      }
    }
  }
}

// (iii) dQ of one (batch, head) tile of 32 queries.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int H, int KH, int S, int D, int window,
              float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_d(D), d4 = (D + 3) / 4;
  float* qs = smem;                        // (kBQ, dp), q * scale
  float* dos = qs + kBQ * dp;              // (kBQ, dp)
  float* ks = dos + kBQ * dp;              // (kBK, dp)
  float* vs = ks + kBK * dp;               // (kBK, dp)
  float* lse_s = vs + kBK * dp;            // (kBQ)
  float* delta_s = lse_s + kBQ;            // (kBQ)

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * kBQ;
  const int q_last = min(q0 + kBQ, S) - 1;
  const long long head = (long long)S * D;
  const T* kb = k + ((long long)b * KH + kvh) * head;
  const T* vb = v + ((long long)b * KH + kvh) * head;
  load_tile(qs, q + bh * head, q0, S, D, dp, scale);
  load_tile(dos, dout + bh * head, q0, S, D, dp, 1.0f);
  load_stats(lse_s, delta_s, lse, delta, bh, q0, S);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = q0 + warp * kRows;
  const int row_last = min(row0 + kRows, S) - 1;
  float acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;

  const int lo = max(0, q0 - window + 1);
  for (int t = (lo / kBK) * kBK; t <= q_last; t += kBK) {
    __syncthreads();                       // the previous tile is consumed
    load_tile(ks, kb, t, S, D, dp, 1.0f);
    load_tile(vs, vb, t, S, D, dp, 1.0f);
    __syncthreads();
    // warp-uniform: no row of this warp sees a key of this tile
    if (row0 > row_last || t > row_last || t + kBK - 1 < row0 - window + 1)
      continue;
    float s[kRows], dpv[kRows], p[kRows], ds[kRows];
    dots(qs + warp * kRows * dp, ks, dp, d4, s);
    dots(dos + warp * kRows * dp, vs, dp, d4, dpv);
    p_and_ds(s, dpv, row0, warp * kRows, t + lane, S, window, softcap, lse_s,
             delta_s, p, ds);
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float kv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        kv[i] = c < D ? ks[j * dp + c] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(dsj, kv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = row0 + r;
    if (qpos >= S) break;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D)
        store(dq + bh * head + (long long)qpos * D + c, acc[r][i] * scale);
    }
  }
}

template <typename F>
cudaError_t set_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, void* dq, void* dk,
                   void* dv, float* lse, float* delta, int B, int H, int KH,
                   int S, int D, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  cudaError_t err;
  if ((err = set_smem(bwd_stats_kernel<T>, stats_smem(D))) != cudaSuccess ||
      (err = set_smem(bwd_dkdv_kernel<T, DPL>, dkdv_smem(D))) !=
          cudaSuccess ||
      (err = set_smem(bwd_dq_kernel<T, DPL>, dq_smem(D))) != cudaSuccess)
    return err;
  const unsigned tiles = (unsigned)((S + kBQ - 1) / kBQ);
  bwd_stats_kernel<T><<<dim3(tiles, B * H), kThreads, stats_smem(D),
                        stream>>>(qt, kt, static_cast<const T*>(out), dot,
                                  lse, delta, H, KH, S, D, window, softcap,
                                  scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dkdv_kernel<T, DPL><<<dim3(tiles, B * KH), kThreads, dkdv_smem(D),
                            stream>>>(qt, kt, vt, dot, lse, delta,
                                      static_cast<T*>(dk),
                                      static_cast<T*>(dv), H, KH, S, D,
                                      window, softcap, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq_kernel<T, DPL><<<dim3(tiles, B * H), kThreads, dq_smem(D),
                          stream>>>(qt, kt, vt, dot, lse, delta,
                                    static_cast<T*>(dq), H, KH, S, D, window,
                                    softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, void* dq, void* dk,
                     void* dv, float* lse, float* delta, int B, int H,
                     int KH, int S, int D, int window, float softcap,
                     float scale, cudaStream_t st) {
  if (D <= 32)
    return launch<T, 1>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, H, KH,
                        S, D, window, softcap, scale, st);
  if (D <= 64)
    return launch<T, 2>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, H, KH,
                        S, D, window, softcap, scale, st);
  if (D <= 128)
    return launch<T, 4>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, H, KH,
                        S, D, window, softcap, scale, st);
  return launch<T, 8>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, H, KH,
                      S, D, window, softcap, scale, st);
}

}  // namespace

// Kernel Gb: the gradient of kernel G. q, out, dout, dq of shape (B, H, S,
// D) and k, v, dk, dv of shape (B, KH, S, D), all contiguous, of one dtype:
// float32 (bf16 = 0) or bfloat16 (bf16 = 1); lse and delta are float32
// scratch of B * H * S elements. H % KH == 0, 1 <= D <= 256, window >= 1,
// B * H <= 65535; softcap <= 0 means none; scale multiplies q (D^-0.5).
// Needs 4 * (128 * padded_d(D) + 2,112) bytes of shared memory (141,568 B
// at D = 256). Three launches; allocates nothing and does not synchronise;
// returns the first launch error.
extern "C" int window_attention_bwd(const void* q, const void* k,
                                    const void* v, const void* out,
                                    const void* dout, void* dq, void* dk,
                                    void* dv, void* lse, void* delta, int B,
                                    int H, int KH, int S, int D, int window,
                                    float softcap, float scale, int bf16,
                                    void* stream) {
  if (B < 1 || S < 1) return cudaSuccess;
  if (H < 1 || KH < 1 || H % KH || D < 1 || D > kMaxD || window < 1 ||
      (long long)B * H > 65535 || dkdv_smem(D) > kMaxSmem)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (bf16)
    return by_width<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, ls, dl, B,
                                   H, KH, S, D, window, softcap, scale, st);
  return by_width<float>(q, k, v, out, dout, dq, dk, dv, ls, dl, B, H, KH, S,
                         D, window, softcap, scale, st);
}
