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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;                   // query rows per block
constexpr int kBK = 64;                    // keys per K/V tile
constexpr int kStages = 2;
constexpr int kThreads = 384;              // producer + 2 consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;

// Columns per shared-memory block: the largest of 64, 32, 16 dividing D.
__host__ __device__ constexpr int block_cols(int d) {
  return d % 64 == 0 ? 64 : (d % 32 == 0 ? 32 : 16);
}

// Bytes of shared memory one block asks for: Q, the K and V rings, the
// mbarriers, and 1 KB of slack to align the base to the swizzle atom.
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return 2 * (size_t)d * (kBQ + 2 * kStages * kBK) + 8 * (1 + 3 * kStages) +
         1024;
}

// -- PTX wrappers ------------------------------------------------------------

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// TMA: the box at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma operands across the
// asynchronous instructions (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle of the layout (1 = 128 B, 2 = 64
// B, 3 = 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

// -- wgmma (generated operand lists) -----------------------------------------

// D (64 x 64, fp32) (+)= A (64 x 16, smem) . B (16 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 16, fp32) += A (64 x 16, registers) . B (16 x 16, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, fp32) += A (64 x 16, registers) . B (16 x 32, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int W>
__device__ __forceinline__ void wgmma_rs(float (&d)[W / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (W == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (W == 32) {
    wgmma_rs_n32(d, a, db);
  } else {
    wgmma_rs_n16(d, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- the kernel ----------------------------------------------------------------
//
// Accumulator fragment of a 64 x N wgmma (per thread: warp w of the
// warpgroup, lane l, quad q = l % 4): element 4 i + 2 h + e sits at row
// 16 w + l / 4 + 8 h, column 8 i + 2 q + e.

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
window_attn_sm90_kernel(__grid_constant__ const CUtensorMap tm_q,
                        __grid_constant__ const CUtensorMap tm_k,
                        __grid_constant__ const CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o, int BH, int H,
                        int group, int KH, int S, int window,
                        float score_log2, float cap_in, float cap_log2) {
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

    // ---- epilogue: o = acc / max(l, 1e-30), bf16x2 stores ---------------------
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_a + 8 * hh;
      const float den = fmaxf(quad_sum(l_run[hh]), 1e-30f);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so nothing links libcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map of a contiguous (heads, S, D) bf16 tensor, boxes of W columns x
// `rows` rows of one head, swizzled as the wgmma descriptors expect.
bool make_map(CUtensorMap* map, const void* ptr, int heads, int S, int D,
              int rows) {
  const int w = block_cols(D);
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)w, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz =
      w == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : (w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  EncodeTiled encode = encode_fn();
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, int B, int H, int KH,
                   int S, int window, float softcap, float scale,
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
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B * H, H, H / KH, KH, S,
      window, score_log2, cap_in, cap_log2);
  return cudaGetLastError();
}

}  // namespace

// Kernel G, bf16 route. q, o of shape (B, H, S, D), k, v of shape (B, KH, S,
// D), bfloat16, contiguous, 16-byte aligned. H % KH == 0, D % 16 == 0, 16 <=
// D <= 256, window >= 1; softcap <= 0 means none; scale multiplies the fp32
// scores (D^-0.5). Allocates nothing and does not synchronise; returns the
// launch's cudaError_t (cudaErrorInvalidValue for arguments it does not take
// or a tensor map the driver refuses).
extern "C" int window_attention_sm90(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int KH, int S, int D, int window,
                                     float softcap, float scale,
                                     void* stream) {
  if (B < 1 || S < 1) return cudaSuccess;
  if (H < 1 || KH < 1 || H % KH || D < 16 || D > 256 || D % 16 ||
      window < 1 || smem_bytes(D) > kMaxSmem ||
      (long long)B * H * ((S + kBQ - 1) / kBQ) > 0x7fffffffLL ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B * H, S, D, kBQ) ||
      !make_map(&tk, k, B * KH, S, D, kBK) ||
      !make_map(&tv, v, B * KH, S, D, kBK))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D / 16) {
#define G_CASE(n)                                                          \
  case n:                                                                  \
    return launch<16 * n>(tq, tk, tv, o, B, H, KH, S, window, softcap,     \
                          scale, st);
    G_CASE(1) G_CASE(2) G_CASE(3) G_CASE(4) G_CASE(5) G_CASE(6) G_CASE(7)
    G_CASE(8) G_CASE(9) G_CASE(10) G_CASE(11) G_CASE(12) G_CASE(13)
    G_CASE(14) G_CASE(15) G_CASE(16)
#undef G_CASE
  }
  return cudaErrorInvalidValue;
}
