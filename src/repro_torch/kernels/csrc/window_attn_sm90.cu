// Causal sliding-window attention on Hopper tensor cores: kernel G's bf16
// route.
//
// Replaces src/repro/kernels/window_attn.py::window_attention for bf16 q, k,
// v with head_dim D % 16 == 0 and D <= 256 (window_attn.cu keeps the fp32
// route and other head dims). It computes what that kernel computes: scores
// q . k^T in fp32 times D^-0.5 (applied to the fp32 scores, not to bf16 q),
// an optional softcap c * tanh(s / c), the mask k <= q and q - k < window, an
// online softmax in fp32 and o = acc / max(l, 1e-30) in bf16; query head h
// reads KV head h / (H / KH). The one new rounding against the Pallas kernel
// is P, rounded to bf16 before P . V (the tensor cores take bf16 operands).
//
// What bounds it on the card: operations. Each in-window (q, k) pair costs
// 4 D FLOP; at gemma2-2b's local layers (B = 2, H = 8, S = 8192, D = 256,
// window 4096) that is 412 GFLOP, 0.417 ms at 989 TFLOP/s, while q, k, v, o
// (201 MB) take 0.060 ms. Only wgmma reaches that rate.
//
// Design (FlashAttention-3's shape): a block of 3 warpgroups owns 128
// consecutive queries of one (batch, head) and loops over the 64-key tiles
// that meet (q0 - window, q_last]; tiles wholly outside the window are never
// loaded. Warpgroup 0 is the producer: one thread issues TMA loads (Q once,
// then K and V tiles into a two-stage ring, each stage with full and empty
// mbarriers) and setmaxnreg gives its registers to the two consumer
// warpgroups (24 against 240). Each consumer owns 64 query rows:
//   S = Q K^T    wgmma m64n64k16, A = Q and B = K from shared memory;
//   softmax      on the fp32 accumulator fragment (a thread holds 2 rows x
//                16 columns; row max and sum over the 4-thread quad), only
//                tiles that cross the diagonal, the window's far edge or S
//                compute a mask; a masked score is -1e30 and its probability
//                exactly 0;
//   O += P V     P converted to bf16 in registers (the accumulator layout is
//                wgmma's A-fragment layout), V from shared memory MN-major,
//                wgmma m64nWk16 over the D / W column blocks.
// Shared memory holds Q and the K, V ring in column blocks of W = 64, 32 or
// 16 columns (the largest dividing D) with the matching 128, 64 or 32-byte
// TMA swizzle, which is the layout the wgmma descriptors name. At D = 256:
// Q 64 KB, K and V 2 x 32 KB each, 192 KB in all; one block per SM. The
// tensor maps are 3-D (D, S, B*heads), so rows past S are zero-filled by
// TMA and masked here. Blocks take query tiles heaviest first (reverse q
// order across all heads), so the short tiles of the first window fill the
// last wave. The softcap's tanh is 1 - 2 / (exp(2x) + 1) with ex2 and a fast
// divide: its absolute error (~1e-7) is what the score sees, where
// tanh.approx's 2^-11 relative error would move a capped score by ~0.025.
// Asked for a pointer (a forward whose gradient is wanted), the epilogue
// also writes each row's log-sum-exp in fp32, the residual kernel Gb's wgmma
// route (window_attn_bwd_sm90.cu) reads instead of recomputing the scores.
// The PTX wrappers, descriptors and tensor maps live in wgmma.cuh.

#include "wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 128;                   // query rows per block
constexpr int kBK = 64;                    // keys per K/V tile
constexpr int kStages = 2;
constexpr int kThreads = 384;              // producer + 2 consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kMaxSmem = 232448;

// Bytes of shared memory one block asks for: Q, the K and V rings, the
// mbarriers, and 1 KB of slack to align the base to the swizzle atom.
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return 2 * (size_t)d * (kBQ + 2 * kStages * kBK) + 8 * (1 + 3 * kStages) +
         1024;
}

// -- the kernel ----------------------------------------------------------------
//
// Accumulator layout and shared-memory tiles: wgmma.cuh.

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
window_attn_sm90_kernel(__grid_constant__ const CUtensorMap tm_q,
                        __grid_constant__ const CUtensorMap tm_k,
                        __grid_constant__ const CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int BH, int H, int group,
                        int KH, int S, int window, float score_log2,
                        float cap_in, float cap_log2) {
  constexpr int W = block_cols(D);          // columns per smem block
  constexpr int NB = D / W;                 // column blocks
  constexpr int RB = 2 * W;                 // bytes per row of a block
  constexpr uint32_t SW = W == 64 ? 1 : (W == 32 ? 2 : 3);
  constexpr uint32_t Q_BLOCK = kBQ * RB;    // bytes of one Q column block
  constexpr uint32_t KV_BLOCK = kBK * RB;   // bytes of one K/V column block
  constexpr uint32_t KV_TILE = NB * KV_BLOCK;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t ks = qs + NB * Q_BLOCK;
  const uint32_t vs = ks + kStages * KV_TILE;
  const uint32_t bars = vs + kStages * KV_TILE;
  const uint32_t q_full = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  // heaviest query tiles first, across all heads
  const int nq = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - blockIdx.x / BH) * kBQ;
  const int b = bh / H, h = bh - b * H;
  const int kvh = b * KH + h / group;
  const int q_last = min(q0 + kBQ, S) - 1;
  const int t_lo = (max(0, q0 - window + 1) / kBK) * kBK;
  const int n_tiles = (q_last - t_lo) / kBK + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ---------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kBQ * D * 2);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load_3d(qs + c * Q_BLOCK, &tm_q, q_full, c * W, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t parity = ((it / kStages) & 1) ^ 1;
        mbar_wait(empty(s), parity);
        const int t = t_lo + it * kBK;
        mbar_expect_tx(full_k(s), kBK * D * 2);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_3d(ks + s * KV_TILE + c * KV_BLOCK, &tm_k, full_k(s), c * W,
                      t, kvh);
        mbar_expect_tx(full_v(s), kBK * D * 2);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_3d(vs + s * KV_TILE + c * KV_BLOCK, &tm_v, full_v(s), c * W,
                      t, kvh);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int r_base = q0 + 64 * cw;           // first row of this consumer
    const int r_last = min(r_base + 63, S - 1);
    const int row_a = r_base + 16 * warp + lane / 4;   // and row_a + 8
    const int col_q = 2 * (lane & 3);

    float o_acc[NB][W / 2];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < W / 2; ++i) o_acc[c][i] = 0.0f;
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};

    // Q: this consumer's 64 rows of each column block; K and V column blocks
    const uint64_t desc_q =
        make_desc(qs + cw * 64 * RB, 16, 8 * RB, SW);
    const uint64_t desc_k = make_desc(ks, 16, 8 * RB, SW);
    const uint64_t desc_v = make_desc(vs, KV_BLOCK, 8 * RB, SW);

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int t = t_lo + it * kBK;
      mbar_wait(full_k(s), parity);
      // warpgroup-uniform: does any row of this consumer see a key here?
      const bool visible = r_base < S && t <= r_last &&
                           t + kBK - 1 >= r_base - window + 1;
      if (visible) {
        float sc[32];
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int j = 0; j < W / 16; ++j) {
            const uint32_t off = (c * Q_BLOCK + j * 32) >> 4;
            const uint32_t koff = (s * KV_TILE + c * KV_BLOCK + j * 32) >> 4;
            wgmma_ss_n64(sc, desc_q + off, desc_k + koff, (c | j) != 0);
          }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scores in log2 units: scale (and softcap) applied in fp32
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (cap_in > 0.0f) {
            const float e = exp2f(sc[i] * cap_in);     // exp(2 x / cap)
            sc[i] = cap_log2 * (1.0f - __fdividef(2.0f, e + 1.0f));
          } else {
            sc[i] *= score_log2;
          }
        }
        const bool need_mask = t + kBK - 1 > r_base ||
                               r_last - t >= window || t + kBK > S;
        if (need_mask) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = t + 8 * i + col_q + e;
                const int row = row_a + 8 * hh;
                const bool ok = key <= row && row - key < window && key < S;
                if (!ok) sc[4 * i + 2 * hh + e] = kNegInf;
              }
        }
        float alpha[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = m_run[hh];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * hh], sc[4 * i + 2 * hh + 1]));
          mx = quad_max(mx);
          float sum = 0.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float y = sc[4 * i + 2 * hh + e];
              const float p = y == kNegInf ? 0.0f : exp2f(y - mx);
              sc[4 * i + 2 * hh + e] = p;
              sum += p;
            }
          alpha[hh] = exp2f(m_run[hh] - mx);
          m_run[hh] = mx;
          l_run[hh] = l_run[hh] * alpha[hh] + sum;   // quad-partial sum
        }
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int i = 0; i < W / 8; ++i)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              o_acc[c][4 * i + 2 * hh] *= alpha[hh];
              o_acc[c][4 * i + 2 * hh + 1] *= alpha[hh];
            }
        // P in bf16: keys 16 kk .. 16 kk + 15 form wgmma's A fragment
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }

        mbar_wait(full_v(s), parity);
#pragma unroll
        for (int c = 0; c < NB; ++c) fence_regs(o_acc[c]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t voff =
                (s * KV_TILE + c * KV_BLOCK + kk * 16 * RB) >> 4;
            wgmma_rs<W>(o_acc[c], pa[kk], desc_v + voff);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NB; ++c) fence_regs(o_acc[c]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      } else {
        mbar_wait(full_v(s), parity);   // the stage's loads have landed
      }
      mbar_arrive(empty(s));
    }

    // ---- epilogue: o = acc / max(l, 1e-30), bf16x2 stores; lse in natural
    // log units of the scaled, capped score (m_run is in log2 units) -------
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_a + 8 * hh;
      const float den = fmaxf(quad_sum(l_run[hh]), 1e-30f);
      if (lse != nullptr && row < S && (lane & 3) == 0)
        lse[(long long)bh * S + row] = (m_run[hh] + log2f(den)) * kLn2;
      if (row < S) {
        __nv_bfloat16* orow = o + ((long long)bh * S + row) * D;
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int i = 0; i < W / 8; ++i) {
            const int col = c * W + 8 * i + col_q;
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o_acc[c][4 * i + 2 * hh] / den,
                                      o_acc[c][4 * i + 2 * hh + 1] / den);
          }
      }
    }
  }
}

// -- host side -----------------------------------------------------------------

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, float* lse, int B, int H,
                   int KH, int S, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (S + kBQ - 1) / kBQ;
  // log2 units: p = exp2(y - max y) with y = score * log2(e)
  const float score_log2 = scale * kLog2e;
  const float cap_in = softcap > 0.0f ? 2.0f * kLog2e * scale / softcap : 0.0f;
  const float cap_log2 = softcap * kLog2e;
  window_attn_sm90_kernel<D><<<(unsigned)(B * H * nq), kThreads, smem,
                               stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B * H, H, H / KH, KH,
      S, window, score_log2, cap_in, cap_log2);
  return cudaGetLastError();
}

}  // namespace

// Kernel G, bf16 route. q, o of shape (B, H, S, D), k, v of shape (B, KH, S,
// D), bfloat16, contiguous, 16-byte aligned. H % KH == 0, D % 16 == 0, 16 <=
// D <= 256, window >= 1; softcap <= 0 means none; scale multiplies the fp32
// scores (D^-0.5). lse, when not NULL, is float32 (B, H, S): each row's
// natural-log log-sum-exp of its scaled, capped scores, the residual kernel
// Gb's wgmma route reads; o is the same bit for bit with or without it.
// Allocates nothing and does not synchronise; returns the launch's
// cudaError_t (cudaErrorInvalidValue for arguments it does not take or a
// tensor map the driver refuses).
extern "C" int window_attention_sm90(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int B, int H, int KH, int S, int D,
                                     int window, float softcap, float scale,
                                     void* stream) {
  if (B < 1 || S < 1) return cudaSuccess;
  if (H < 1 || KH < 1 || H % KH || D < 16 || D > 256 || D % 16 ||
      window < 1 || smem_bytes(D) > kMaxSmem ||
      (long long)B * H * ((S + kBQ - 1) / kBQ) > 0x7fffffffLL ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!bind_device(q) || !make_map(&tq, q, B * H, S, D, kBQ) ||
      !make_map(&tk, k, B * KH, S, D, kBK) ||
      !make_map(&tv, v, B * KH, S, D, kBK))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D / 16) {
#define G_CASE(n)                                                          \
  case n:                                                                  \
    return launch<16 * n>(tq, tk, tv, o, static_cast<float*>(lse), B, H,   \
                          KH, S, window, softcap, scale, st);
    G_CASE(1) G_CASE(2) G_CASE(3) G_CASE(4) G_CASE(5) G_CASE(6) G_CASE(7)
    G_CASE(8) G_CASE(9) G_CASE(10) G_CASE(11) G_CASE(12) G_CASE(13)
    G_CASE(14) G_CASE(15) G_CASE(16)
#undef G_CASE
  }
  return cudaErrorInvalidValue;
}
