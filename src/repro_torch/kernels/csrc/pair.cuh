// The pair step shared by the cutoff-force kernels (xpencil.cu: B, C, D;
// allin.cu: E), with the pair-kind dispatch and the shared-memory opt-in.
//
// pair_step is the one accumulation step of every kernel: r2 with explicit
// round-to-nearest operations (the cutoff test sees the r2 of the plain
// PyTorch version), the JAX mask (sid != tid, both ids >= 0,
// 0 < r2 < cutoff2), coeff/potential on the masked-safe r2 (1.0 where
// masked) times the 0/1 weight, and each term added to the caller's partial
// sums. The compiler fuses that multiply-add the same way in every kernel,
// since they all inline this one function: kernels that visit a target's
// sources in the same order give the same bits.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace pair_kernels {

// Kernel ids: repro_torch/core/interactions.py (LJ, LOW_FLOP, ...).
enum PairKind { kLJ = 0, kLowFlop = 1, kHighFlop = 2, kGravity = 3,
                kSphDensity = 4 };

// Parameters folded on the host in double precision, as Python folds them
// before they reach float32:
//   LJ, high_flop: p0 = sigma^2, p1 = softening, p2 = 24*eps, p3 = 4*eps
//   gravity:       p0 = -g, p1 = softening
//   sph_density:   p0 = hh = h/2, p1 = s = 1/(pi*hh^3), p2 = a scale of
//                  the coefficient: 1 for the density, the pressure
//                  force's -2*m*p_bar/rho_bar^2 (repro_torch/physics/sph.py)
struct PairParams {
  float p0, p1, p2, p3;
  int n_extra;
};

constexpr size_t kMaxSmem = 232448;  // 227 KB a block may opt in to
// Stacked systems a launch takes: one a grid y or z index, at most 65535.
constexpr int kMaxSystems = 65535;

__device__ __forceinline__ void lj(float r2, const PairParams& q, float& c,
                                   float& u) {
  const float r = r2 + q.p1;
  const float inv = q.p0 / r;
  const float a6 = inv * inv * inv;
  const float a12 = a6 * a6;
  c = q.p2 * (2.0f * a12 - a6) / r;
  u = q.p3 * (a12 - a6);
}

template <int KIND>
__device__ __forceinline__ void pair_terms(float r2, const PairParams& q,
                                           float& c, float& u) {
  if (KIND == kLJ) {
    lj(r2, q, c, u);
  } else if (KIND == kLowFlop) {
    c = r2 * 0.5f;
    u = r2 + 1.0f;
  } else if (KIND == kHighFlop) {
    lj(r2, q, c, u);
    float acc = r2;
    for (int k = 0; k < q.n_extra; ++k) {
      // Python: acc * 0.9999 + r2 * (1e-3 * (k + 1)) + 1e-7, in float32
      acc = acc * (float)0.9999 + r2 * (float)(1e-3 * (k + 1)) + (float)1e-7;
      acc = acc * (float)1.0001;
    }
    const float extra = acc * (float)1e-30;
    c = c + extra;
    u = u + extra;
  } else if (KIND == kGravity) {
    const float d = r2 + q.p1;
    c = q.p0 * rsqrtf(d) / d;
    u = q.p0 * rsqrtf(r2 + q.p1);
  } else {  // kSphDensity
    const float hh = q.p0, s = q.p1;
    const float qu = sqrtf(r2) / hh;
    const float w1 = 1.0f - 1.5f * qu * qu + 0.75f * (qu * qu * qu);
    const float tu = 2.0f - qu;
    const float w2 = 0.25f * (tu * tu * tu);
    u = s * (qu < 1.0f ? w1 : (qu < 2.0f ? w2 : 0.0f));
    const float qc = sqrtf(fmaxf(r2, (float)1e-12)) / hh;
    const float g1 = -3.0f * qc + 2.25f * qc * qc;
    const float tc = 2.0f - qc;
    const float g2 = -0.75f * (tc * tc);
    const float g = qc < 1.0f ? g1 : (qc < 2.0f ? g2 : 0.0f);
    const float r = fmaxf(sqrtf(r2), (float)1e-12);
    c = s * g / (hh * r);
    c = q.p2 * c;  // the pressure kernel's scale * base.coeff(r2); 1 * c == c
  }
}

// One candidate pair: adds the masked terms of source (sx, sy, sz, s) to
// the partial sums of target (tx, ty, tz, tid).
template <int KIND>
__device__ __forceinline__ void pair_step(float tx, float ty, float tz,
                                          int tid, float sx, float sy,
                                          float sz, int s, float cutoff2,
                                          const PairParams& prm, float& px,
                                          float& py, float& pz, float& pp) {
  const float ddx = tx - sx;
  const float ddy = ty - sy;
  const float ddz = tz - sz;
  const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx),
                                       __fmul_rn(ddy, ddy)),
                             __fmul_rn(ddz, ddz));
  const bool m = (s != tid) && (s >= 0) && (r2 < cutoff2) && (r2 > 0.0f);
  const float w = m ? 1.0f : 0.0f;
  float c, u;
  pair_terms<KIND>(m ? r2 : 1.0f, prm, c, u);
  const float sc = c * w;
  px += sc * ddx;
  py += sc * ddy;
  pz += sc * ddz;
  pp += u * w;
}

// Whether pair_step counts source (sx, sy, sz, s) for target (tx, ty, tz,
// tid): its mask, from the same r2. A pair it does not count adds exactly
// +-0 to each partial sum (its terms are finite values times a 0 weight),
// and a partial that starts at +0 is never -0, so leaving such a pair out
// keeps every bit of the sums.
__device__ __forceinline__ bool pair_counts(float tx, float ty, float tz,
                                            int tid, float sx, float sy,
                                            float sz, int s, float cutoff2) {
  const float ddx = tx - sx;
  const float ddy = ty - sy;
  const float ddz = tz - sz;
  const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx),
                                       __fmul_rn(ddy, ddy)),
                             __fmul_rn(ddz, ddz));
  return (s != tid) && (s >= 0) && (r2 < cutoff2) && (r2 > 0.0f);
}

// Calls f(std::integral_constant<int, KIND>) for the runtime pair kind.
template <typename F>
cudaError_t by_kind(int kind, F&& f) {
  switch (kind) {
    case kLJ:
      return f(std::integral_constant<int, kLJ>{});
    case kLowFlop:
      return f(std::integral_constant<int, kLowFlop>{});
    case kHighFlop:
      return f(std::integral_constant<int, kHighFlop>{});
    case kGravity:
      return f(std::integral_constant<int, kGravity>{});
    case kSphDensity:
      return f(std::integral_constant<int, kSphDensity>{});
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace pair_kernels
