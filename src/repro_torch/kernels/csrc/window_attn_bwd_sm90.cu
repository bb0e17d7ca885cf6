// Backward of causal sliding-window attention on Hopper tensor cores: kernel
// Gb's bf16 route.
//
// Replaces no TPU kernel: it is the gradient of kernel G's bf16 route
// (window_attn_sm90.cu), for bf16 q, k, v with head_dim D % 16 == 0 and
// 16 <= D <= 256; window_attn_bwd.cu keeps fp32 and the other head dims.
// What it computes is window_attn_bwd.cu's function (its header states it):
// P from the scaled, capped scores and each row's log-sum-exp, delta =
// rowsum(dout * out), dS = P (dout . v - delta) (1 - t^2) with t = c / cap
// clipped to [-1, 1], dV = P^T dout, dK = scale dS^T q, dQ = scale dS k, dK
// and dV summed over the H / KH query heads of a group. The log-sum-exp is
// kernel G's residual (its lse output), never recomputed here. P and dS are
// rounded to bf16 before the products (the tensor cores take bf16
// operands), the kind of rounding kernel G makes to P.
//
// What bounds it on the card: operations. The gradient needs 10 D FLOP per
// visible pair; this design spends 14 D (the scores q . k and dout . v are
// computed once in the dK/dV launch and once in the dQ launch, so that no
// block adds into another's output: no atomics, the same bits every run).
// At gemma2-2b's local layers (B = 2, H = 8, KH = 4, S = 8192, D = 256,
// window 4096: 402,685,952 pairs) that is 1443 GFLOP, 1.46 ms at 989
// TFLOP/s; q, k, v, out, dout, dq, dk, dv (235 MB) take 0.070 ms.
//
// Design (FlashAttention-3's backward, without its atomic dQ): three
// launches on the caller's stream.
//   (i)   prep: one warp a row; lse2 = lse * log2(e) and delta =
//         rowsum(dout * out) in fp32, into (B * H, S rounded up to 64)
//         scratch whose rows past S are 0, so the next launches copy 64
//         rows at a time with no bounds.
//   (ii)  dK, dV: a block of 3 warpgroups per (batch, KV head, 64-key
//         tile), heaviest tiles first. K and V stay resident (one TMA load);
//         the producer warpgroup streams (Q, dout, lse2, delta) tiles of 64
//         queries of every head of the group whose window reaches the key
//         tile through a two-stage mbarrier ring. The transposed tiles make
//         every product one of kernel G's two wgmma forms:
//           warpgroup 1: S^T = K Q^T (SS, both K-major), P^T, then
//                        dV += P^T dout (RS, dout MN-major);
//           warpgroup 2: dP^T = V dout^T (SS), dS^T from P^T (1 - t^2),
//                        which warpgroup 1 hands over through 16 KB of
//                        shared memory in the accumulator's own layout
//                        (named barriers), then dK += dS^T Q (RS, Q
//                        MN-major).
//         A 64 x 256 fp32 accumulator is 128 registers a thread, so dK and
//         dV take one warpgroup each. The GQA sum is the loop inside the
//         block.
//   (iii) dQ: a block per (batch, head, 64-query tile), heaviest first;
//         Q, dout, lse2 and delta stay resident, the K and V tiles of the
//         window stream through a two-stage ring. Consumer warpgroup c
//         takes the tiles it = c, c + 2, ... (stage c): S = Q K^T and dP =
//         dout V^T (SS), dS, dQ += dS K (RS, K MN-major); at the end
//         warpgroup 2 hands its partial dQ to warpgroup 1 through the idle
//         ring, which adds it in a fixed order.
// Only tiles that cross the diagonal, the window's far edge or S compute a
// mask; a masked pair gives P = dS = 0 exactly. Tiles are read by TMA from
// 3-D maps (rows past S zero-filled). Shared memory at D = 256: dK/dV
// 215,080 B (K, V 64 KB, ring 2 x 64.5 KB, P 16 KB), dQ 197,672 B; one block
// an SM. The softcap's tanh is kernel G's (1 - 2 / (exp(2x) + 1), ex2 and a
// fast divide), so P agrees with the lse kernel G wrote.

#include "wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kTile = 64;                  // rows of every streamed tile
constexpr int kStages = 2;
constexpr int kThreads = 384;              // producer + 2 consumer warpgroups
constexpr int kPrepRows = 8;               // rows (one a warp) a prep block
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;
constexpr int kBarPFull = 1, kBarPEmpty = 2, kBarDone = 3;   // named barriers

// Rows of the lse2 / delta scratch of one head: S rounded up to a tile.
__host__ __device__ constexpr int padded_rows(int s) {
  return (s + kTile - 1) / kTile * kTile;
}

// Bytes of one (64, D) bf16 tile.
__host__ __device__ constexpr size_t tile_bytes(int d) {
  return (size_t)kTile * d * 2;
}

// Shared memory of the two main launches: tiles, the fp32 lse2 / delta rows
// of each stage and the P hand-over (dK/dV), the mbarriers, and 1 KB of
// slack to align the base to the swizzle atom.
__host__ __device__ constexpr size_t dkdv_smem_bytes(int d) {
  return 2 * tile_bytes(d) + kStages * (2 * tile_bytes(d) + 2 * kTile * 4) +
         kTile * kTile * 4 + 8 * (1 + 2 * kStages) + 1024;
}
__host__ __device__ constexpr size_t dq_smem_bytes(int d) {
  return 2 * tile_bytes(d) + kStages * 2 * tile_bytes(d) +
         8 * (1 + 2 * kStages) + 1024;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The scaled, capped score of raw score x = q . k in log2 units, and the
// softcap's derivative 1 - t^2 (1 without a cap): kernel G's arithmetic.
__device__ __forceinline__ float capped(float x, float score_log2,
                                        float cap_in, float cap_log2,
                                        float& dcap) {
  if (cap_in > 0.0f) {
    const float e = exp2f(x * cap_in);                 // exp(2 x / cap)
    const float t =
        fminf(fmaxf(1.0f - __fdividef(2.0f, e + 1.0f), -1.0f), 1.0f);
    dcap = 1.0f - t * t;
    return cap_log2 * t;
  }
  dcap = 1.0f;
  return x * score_log2;
}

// (i) lse2 and delta of one row of (B * H, SP) a warp.
__global__ void __launch_bounds__(kPrepRows * 32)
bwd_sm90_prep_kernel(const __nv_bfloat16* __restrict__ out,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ lse2,
                     float* __restrict__ delta, int S, int SP, int D,
                     long long rows) {
  const long long r = (long long)blockIdx.x * kPrepRows + threadIdx.x / 32;
  if (r >= rows) return;                   // warp-uniform
  const int lane = threadIdx.x & 31;
  const long long bh = r / SP;
  const int i = (int)(r - bh * SP);
  float acc = 0.0f, l = 0.0f;
  if (i < S) {
    const long long off = (bh * S + i) * D;
    const __nv_bfloat162* o2 =
        reinterpret_cast<const __nv_bfloat162*>(out + off);
    const __nv_bfloat162* d2 =
        reinterpret_cast<const __nv_bfloat162*>(dout + off);
    for (int c = lane; c < D / 2; c += 32) {
      const float2 a = __bfloat1622float2(o2[c]);
      const float2 g = __bfloat1622float2(d2[c]);
      acc = fmaf(a.x, g.x, acc);
      acc = fmaf(a.y, g.y, acc);
    }
    l = lse[bh * S + i] * kLog2e;
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    lse2[r] = l;
    delta[r] = acc;
  }
}

// (ii) dK and dV of one (batch, KV head) tile of 64 keys.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_sm90_dkdv_kernel(__grid_constant__ const CUtensorMap tm_q,
                     __grid_constant__ const CUtensorMap tm_do,
                     __grid_constant__ const CUtensorMap tm_k,
                     __grid_constant__ const CUtensorMap tm_v,
                     const float* __restrict__ lse2,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int BKH, int group,
                     int S, int SP, int window, float score_log2,
                     float cap_in, float cap_log2, float scale) {
  constexpr int W = block_cols(D);          // columns per smem block
  constexpr int NB = D / W;                 // column blocks
  constexpr int RB = 2 * W;                 // bytes per row of a block
  constexpr uint32_t SW = W == 64 ? 1 : (W == 32 ? 2 : 3);
  constexpr uint32_t BLOCK = kTile * RB;    // one column block of a tile
  constexpr uint32_t TILE = NB * BLOCK;     // one (64, D) tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ks = base, vs = base + TILE;
  auto qs = [&](int s) { return base + 2 * TILE + s * 2 * TILE; };
  auto dos = [&](int s) { return qs(s) + TILE; };
  const uint32_t stats = base + 2 * TILE + kStages * 2 * TILE;
  auto lse_s = [&](int s) { return stats + s * 2 * kTile * 4; };
  auto dl_s = [&](int s) { return lse_s(s) + kTile * 4; };
  const uint32_t pbuf = stats + kStages * 2 * kTile * 4;
  const uint32_t bars = pbuf + kTile * kTile * 4;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto generic = [&](uint32_t a) {
    return reinterpret_cast<float*>(smem_raw + (a - raw));
  };

  // heaviest key tiles first: the lowest see the most queries
  const int bkh = blockIdx.x % BKH;
  const int k0 = (blockIdx.x / BKH) * kTile;
  const int k_last = min(k0 + kTile, S) - 1;
  const int i_end = (int)min((long long)S - 1, (long long)k_last + window - 1);
  const int n_q = (i_end - k0) / kTile + 1;       // query tiles of a head
  const int n_items = group * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer -----------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * TILE);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load_3d(ks + c * BLOCK, &tm_k, kv_full, c * W, k0, bkh);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load_3d(vs + c * BLOCK, &tm_v, kv_full, c * W, k0, bkh);
      for (int it = 0; it < n_items; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const int g = it / n_q, i0 = k0 + (it - g * n_q) * kTile;
        const int bh = bkh * group + g;           // b * H + kvh * group + g
        mbar_expect_tx(full(s), 2 * TILE + 2 * kTile * 4);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_3d(qs(s) + c * BLOCK, &tm_q, full(s), c * W, i0, bh);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_3d(dos(s) + c * BLOCK, &tm_do, full(s), c * W, i0, bh);
        const long long row = (long long)bh * SP + i0;
        bulk_load(lse_s(s), lse2 + row, kTile * 4, full(s));
        bulk_load(dl_s(s), delta + row, kTile * 4, full(s));
      }
    }
  } else {
    // ---- consumers: 1 = S^T, P^T, dV; 2 = dP^T, dS^T, dK -----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid / 32, lane = tid & 31;
    const int key_a = k0 + 16 * warp + lane / 4;       // and key_a + 8
    const int col_q = 2 * (lane & 3);
    float* pb = generic(pbuf);

    float acc[NB][W / 2];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[c][i] = 0.0f;

    // A: K or V (resident, K-major); B: Q or dout of stage 0 (K-major) for
    // the scores, dout or Q of stage 0 (MN-major) for the accumulation
    const uint64_t desc_a = make_desc(cw == 0 ? ks : vs, 16, 8 * RB, SW);
    const uint64_t desc_b =
        make_desc(cw == 0 ? qs(0) : dos(0), 16, 8 * RB, SW);
    const uint64_t desc_mn =
        make_desc(cw == 0 ? dos(0) : qs(0), BLOCK, 8 * RB, SW);

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_items; ++it) {
      const int s = it % kStages;
      const int g = it / n_q, i0 = k0 + (it - g * n_q) * kTile;
      const uint32_t so = s * 2 * TILE;            // the stage's offset
      mbar_wait(full(s), (it / kStages) & 1);
      float x[32];                                 // S^T or dP^T
      fence_regs(x);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int j = 0; j < W / 16; ++j) {
          const uint32_t off = c * BLOCK + j * 32;
          wgmma_ss_n64(x, desc_a + (off >> 4), desc_b + ((so + off) >> 4),
                       (c | j) != 0);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(x);

      const bool need_mask = k0 + kTile - 1 > i0 ||
                             i0 + kTile - 1 - k0 >= window ||
                             i0 + kTile > S || k0 + kTile > S;
      if (cw == 0) {
        // P^T into x (for dV) and P^T (1 - t^2) to the hand-over (for dS)
        const float* ls = generic(lse_s(s));
        if (it > 0) bar_sync(kBarPEmpty, 256);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * i + 2 * hh + e;
              const int col = 8 * i + col_q + e;
              const int key = key_a + 8 * hh, query = i0 + col;
              float dcap;
              const float c =
                  capped(x[idx], score_log2, cap_in, cap_log2, dcap);
              const bool ok = !need_mask ||
                              (key <= query && query - key < window &&
                               query < S && key < S);
              const float p = ok ? exp2f(c - ls[col]) : 0.0f;
              x[idx] = p;
              pb[idx * 128 + tid] = p * dcap;
            }
        bar_arrive(kBarPFull, 256);
      } else {
        // dS^T = P^T (1 - t^2) (dP^T - delta)
        const float* dl = generic(dl_s(s));
        bar_sync(kBarPFull, 256);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * i + 2 * hh + e;
              x[idx] = pb[idx * 128 + tid] * (x[idx] - dl[8 * i + col_q + e]);
            }
        if (it + 1 < n_items) bar_arrive(kBarPEmpty, 256);
      }

      // dV += P^T dout or dK += dS^T Q, the left factor in bf16 registers
      uint32_t pa[4][4];
      pack_a(x, pa);
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<W>(acc[c], pa[kk],
                      desc_mn + ((so + c * BLOCK + kk * 16 * RB) >> 4));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      mbar_arrive(empty(s));
    }

    // ---- epilogue: dV, or dK times scale, bf16x2 stores ----------------------
    __nv_bfloat16* dst = cw == 0 ? dv : dk;
    const float mul = cw == 0 ? 1.0f : scale;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key_a + 8 * hh;
      if (key < S) {
        __nv_bfloat16* row = dst + ((long long)bkh * S + key) * D;
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int i = 0; i < W / 8; ++i)
            *reinterpret_cast<__nv_bfloat162*>(row + c * W + 8 * i + col_q) =
                __floats2bfloat162_rn(acc[c][4 * i + 2 * hh] * mul,
                                      acc[c][4 * i + 2 * hh + 1] * mul);
      }
    }
  }
}

// (iii) dQ of one (batch, head) tile of 64 queries.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_sm90_dq_kernel(__grid_constant__ const CUtensorMap tm_q,
                   __grid_constant__ const CUtensorMap tm_do,
                   __grid_constant__ const CUtensorMap tm_k,
                   __grid_constant__ const CUtensorMap tm_v,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int BH, int H, int group,
                   int KH, int S, int SP, int window, float score_log2,
                   float cap_in, float cap_log2, float scale) {
  constexpr int W = block_cols(D);
  constexpr int NB = D / W;
  constexpr int RB = 2 * W;
  constexpr uint32_t SW = W == 64 ? 1 : (W == 32 ? 2 : 3);
  constexpr uint32_t BLOCK = kTile * RB;
  constexpr uint32_t TILE = NB * BLOCK;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t qs = base, dos = base + TILE;
  auto ks = [&](int s) { return base + 2 * TILE + s * 2 * TILE; };
  auto vs = [&](int s) { return ks(s) + TILE; };
  const uint32_t bars = base + 2 * TILE + kStages * 2 * TILE;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  // heaviest query tiles first (reverse q order across all heads)
  const int nq = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - blockIdx.x / BH) * kTile;
  const int b = bh / H, h = bh - b * H;
  const int bkh = b * KH + h / group;
  const int q_last = min(q0 + kTile, S) - 1;
  const int t_lo = (max(0, q0 - window + 1) / kTile) * kTile;
  const int n_tiles = (q_last - t_lo) / kTile + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);            // stage s has one consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer -----------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * TILE);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load_3d(qs + c * BLOCK, &tm_q, q_full, c * W, q0, bh);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load_3d(dos + c * BLOCK, &tm_do, q_full, c * W, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const int t = t_lo + it * kTile;
        mbar_expect_tx(full(s), 2 * TILE);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_3d(ks(s) + c * BLOCK, &tm_k, full(s), c * W, t, bkh);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_3d(vs(s) + c * BLOCK, &tm_v, full(s), c * W, t, bkh);
      }
    }
  } else {
    // ---- consumers: warpgroup cw + 1 takes key tiles cw, cw + 2, ... -------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid / 32, lane = tid & 31;
    const int row_a = q0 + 16 * warp + lane / 4;       // and row_a + 8
    const int col_q = 2 * (lane & 3);
    float l2[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l2[hh] = lse2[(long long)bh * SP + row_a + 8 * hh];
      dl[hh] = delta[(long long)bh * SP + row_a + 8 * hh];
    }

    float acc[NB][W / 2];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[c][i] = 0.0f;

    const uint64_t desc_q = make_desc(qs, 16, 8 * RB, SW);
    const uint64_t desc_do = make_desc(dos, 16, 8 * RB, SW);
    const uint64_t desc_k = make_desc(ks(0), 16, 8 * RB, SW);
    const uint64_t desc_v = make_desc(vs(0), 16, 8 * RB, SW);
    const uint64_t desc_kmn = make_desc(ks(0), BLOCK, 8 * RB, SW);

    mbar_wait(q_full, 0);
    for (int it = cw; it < n_tiles; it += kStages) {
      const int s = cw;
      const uint32_t so = s * 2 * TILE;
      const int t = t_lo + it * kTile;
      mbar_wait(full(s), (it / kStages) & 1);
      float x[32], y[32];                          // S and dP
      fence_regs(x);
      fence_regs(y);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int j = 0; j < W / 16; ++j) {
          const uint32_t off = c * BLOCK + j * 32;
          wgmma_ss_n64(x, desc_q + (off >> 4), desc_k + ((so + off) >> 4),
                       (c | j) != 0);
        }
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int j = 0; j < W / 16; ++j) {
          const uint32_t off = c * BLOCK + j * 32;
          wgmma_ss_n64(y, desc_do + (off >> 4), desc_v + ((so + off) >> 4),
                       (c | j) != 0);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(x);
      fence_regs(y);

      // dS = P (1 - t^2) (dP - delta), 0 where masked
      const bool need_mask = t + kTile - 1 > q0 ||
                             q0 + kTile - 1 - t >= window ||
                             t + kTile > S || q0 + kTile > S;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * i + 2 * hh + e;
            const int key = t + 8 * i + col_q + e, row = row_a + 8 * hh;
            float dcap;
            const float c =
                capped(x[idx], score_log2, cap_in, cap_log2, dcap);
            const bool ok = !need_mask || (key <= row && row - key < window &&
                                           key < S && row < S);
            x[idx] = ok ? exp2f(c - l2[hh]) * dcap * (y[idx] - dl[hh]) : 0.0f;
          }

      uint32_t pa[4][4];
      pack_a(x, pa);
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<W>(acc[c], pa[kk],
                      desc_kmn + ((so + c * BLOCK + kk * 16 * RB) >> 4));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      mbar_arrive(empty(s));
    }

    // ---- the two partial sums, added in a fixed order through the idle
    // ring; dq = scale * (first + second), bf16x2 stores ---------------------
    float* red = reinterpret_cast<float*>(smem_raw + (ks(0) - raw));
    bar_sync(kBarDone, 256);               // both loops done: the ring is free
    if (cw == 1) {
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int i = 0; i < W / 2; ++i)
          red[(c * (W / 2) + i) * 128 + tid] = acc[c][i];
    }
    bar_sync(kBarDone, 256);
    if (cw == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row_a + 8 * hh;
        if (row < S) {
          __nv_bfloat16* orow = dq + ((long long)bh * S + row) * D;
#pragma unroll
          for (int c = 0; c < NB; ++c)
#pragma unroll
            for (int i = 0; i < W / 8; ++i) {
              const int i0 = 4 * i + 2 * hh, i1 = i0 + 1;
              const float a0 = acc[c][i0] + red[(c * (W / 2) + i0) * 128 + tid];
              const float a1 = acc[c][i1] + red[(c * (W / 2) + i1) * 128 + tid];
              *reinterpret_cast<__nv_bfloat162*>(orow + c * W + 8 * i + col_q) =
                  __floats2bfloat162_rn(a0 * scale, a1 * scale);
            }
        }
      }
    }
  }
}

// -- host side -----------------------------------------------------------------

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tdo,
                   const CUtensorMap& tk, const CUtensorMap& tv,
                   const float* lse2, const float* delta, void* dq, void* dk,
                   void* dv, int B, int H, int KH, int S, int window,
                   float softcap, float scale, cudaStream_t stream) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_sm90_dkdv_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)dkdv_smem_bytes(D))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_sm90_dq_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)dq_smem_bytes(D))) != cudaSuccess)
    return err;
  const int nt = (S + kTile - 1) / kTile;
  const int SP = padded_rows(S);
  // log2 units: p = exp2(y - lse2) with y = score * log2(e)
  const float score_log2 = scale * kLog2e;
  const float cap_in = softcap > 0.0f ? 2.0f * kLog2e * scale / softcap : 0.0f;
  const float cap_log2 = softcap * kLog2e;
  bwd_sm90_dkdv_kernel<D><<<(unsigned)(B * KH * nt), kThreads,
                            dkdv_smem_bytes(D), stream>>>(
      tq, tdo, tk, tv, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B * KH, H / KH, S, SP, window,
      score_log2, cap_in, cap_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_sm90_dq_kernel<D><<<(unsigned)(B * H * nt), kThreads, dq_smem_bytes(D),
                          stream>>>(
      tq, tdo, tk, tv, lse2, delta, static_cast<__nv_bfloat16*>(dq), B * H,
      H, H / KH, KH, S, SP, window, score_log2, cap_in, cap_log2, scale);
  return cudaGetLastError();
}

}  // namespace

// Kernel Gb, bf16 route. q, out, dout, dq of shape (B, H, S, D) and k, v,
// dk, dv of shape (B, KH, S, D), bfloat16, contiguous, q, k, v, dout
// 16-byte aligned; lse float32 (B, H, S), kernel G's residual; lse2 and
// delta float32 scratch of B * H * SP elements, SP = S rounded up to 64,
// 16-byte aligned. H % KH == 0, D % 16 == 0, 16 <= D <= 256, window >= 1;
// softcap <= 0 means none; scale multiplies the fp32 scores (D^-0.5). Three
// launches; allocates nothing and does not synchronise; returns the first
// launch error (cudaErrorInvalidValue for arguments it does not take or a
// tensor map the driver refuses).
extern "C" int window_attention_bwd_sm90(const void* q, const void* k,
                                         const void* v, const void* out,
                                         const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv,
                                         void* lse2, void* delta, int B,
                                         int H, int KH, int S, int D,
                                         int window, float softcap,
                                         float scale, void* stream) {
  if (B < 1 || S < 1) return cudaSuccess;
  const long long tiles = (S + kTile - 1) / kTile;
  if (H < 1 || KH < 1 || H % KH || D < 16 || D > 256 || D % 16 ||
      window < 1 || dkdv_smem_bytes(D) > kMaxSmem ||
      dq_smem_bytes(D) > kMaxSmem || (long long)B * H * tiles > 0x7fffffffLL ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)lse2 | (uintptr_t)delta) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  if (!bind_device(q) || !make_map(&tq, q, B * H, S, D, kTile) ||
      !make_map(&tdo, dout, B * H, S, D, kTile) ||
      !make_map(&tk, k, B * KH, S, D, kTile) ||
      !make_map(&tv, v, B * KH, S, D, kTile))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int SP = padded_rows(S);
  const long long rows = (long long)B * H * SP;
  float* l2 = static_cast<float*>(lse2);
  float* dl = static_cast<float*>(delta);
  bwd_sm90_prep_kernel<<<(unsigned)((rows + kPrepRows - 1) / kPrepRows),
                         kPrepRows * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      l2, dl, S, SP, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (D / 16) {
#define GB_CASE(n)                                                         \
  case n:                                                                  \
    return launch<16 * n>(tq, tdo, tk, tv, l2, dl, dq, dk, dv, B, H, KH, S, \
                          window, softcap, scale, st);
    GB_CASE(1) GB_CASE(2) GB_CASE(3) GB_CASE(4) GB_CASE(5) GB_CASE(6)
    GB_CASE(7) GB_CASE(8) GB_CASE(9) GB_CASE(10) GB_CASE(11) GB_CASE(12)
    GB_CASE(13) GB_CASE(14) GB_CASE(15) GB_CASE(16)
#undef GB_CASE
  }
  return cudaErrorInvalidValue;
}
