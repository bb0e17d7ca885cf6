// Dense X-pencil cutoff forces (the paper's §5.2 schedule) in float32.
//
// Replaces src/repro/kernels/xpencil.py::xpencil_forces, whose Pallas kernel
// runs a (nz, ny, 9) grid: one program per target pencil, the 9 (dz, dy)
// neighbour rows streamed through VMEM, outputs accumulated across k.
//
// What bounds it on the card: operations. It evaluates every dense slot
// pair of each target's 3*m_c window (9 * 3 * m_c candidates per target
// slot), of which only the pairs of real particles within the cutoff do
// work; at 4 particles per cell and m_c = 24 that is about 3% of the
// evaluated pairs. The bytes (planes read once, outputs written once) would
// take far less time than the masked pair arithmetic. Skipping empty source
// slots (sentinel skipping), staging with TMA and packing rows are the
// later work that moves it toward the bound.
//
// Design (simple and right first): one block per (x-chunk of CX cells, y, z).
// For each of the 9 neighbour rows in the order k = 0..8 (dz = k/3 - 1,
// dy = k%3 - 1, as the TPU index map (z + k//3, y + k%3) has it) the block
// stages the row's (CX+2)*m_c slots of x, y, z, id into shared memory; each
// thread owns one target slot, keeps it in registers, scans its contiguous
// 3*m_c window and adds the window's sum to its accumulators. The outputs
// are written once at the end: no atomics, nothing carried between blocks.
// The mask is the JAX kernel's (sid != tid, both ids >= 0, 0 < r2 < cutoff2),
// and coeff/potential are evaluated on the masked-safe r2 (1.0 where masked)
// and multiplied by the 0/1 weight. r2 is computed with explicit
// round-to-nearest operations so the cutoff test sees the same r2 as the
// plain PyTorch version (no fused multiply-add across it). An empty target
// slot (tid < 0) is skipped; its output is 0 either way.

#include <cuda_runtime.h>

namespace {

// Kernel ids: repro_torch/core/interactions.py (LJ, LOW_FLOP, ...).
enum PairKind { kLJ = 0, kLowFlop = 1, kHighFlop = 2, kGravity = 3,
                kSphDensity = 4 };

// Parameters folded on the host in double precision, as Python folds them
// before they reach float32:
//   LJ, high_flop: p0 = sigma^2, p1 = softening, p2 = 24*eps, p3 = 4*eps
//   gravity:       p0 = -g, p1 = softening
//   sph_density:   p0 = hh = h/2, p1 = s = 1/(pi*hh^3)
struct PairParams {
  float p0, p1, p2, p3;
  int n_extra;
};

constexpr int kMaxThreads = 1024;
constexpr int kTargetThreads = 256;

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
  }
}

template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
xpencil_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ z, const int* __restrict__ sid,
               float* __restrict__ fx, float* __restrict__ fy,
               float* __restrict__ fz, float* __restrict__ pot, int nx,
               int ny, int m_c, int cx_cells, float cutoff2, PairParams prm) {
  extern __shared__ float stage[];
  const int stage_len = (cx_cells + 2) * m_c;
  float* sx = stage;
  float* sy = sx + stage_len;
  float* sz = sy + stage_len;
  int* ss = reinterpret_cast<int*>(sz + stage_len);

  const int x0 = blockIdx.x * cx_cells;
  const int cx = min(cx_cells, nx - x0);
  const int yy = blockIdx.y, zz = blockIdx.z;
  const long long row_len = (long long)(nx + 2) * m_c;
  const int t = threadIdx.x;
  const int cell = t / m_c;
  const int slot = t - cell * m_c;
  const bool active = t < cx * m_c;

  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  int tid = -1;
  if (active) {
    const long long ti = ((long long)(zz + 1) * (ny + 2) + (yy + 1)) * row_len
                         + (long long)(x0 + 1 + cell) * m_c + slot;
    tx = x[ti];
    ty = y[ti];
    tz = z[ti];
    tid = sid[ti];
  }
  const bool work = active && tid >= 0;

  float ax = 0.0f, ay = 0.0f, az = 0.0f, ap = 0.0f;
  const int n_stage = (cx + 2) * m_c;
  const int w0 = cell * m_c;  // window of target cell x0+cell: stage cells
                              // cell, cell+1, cell+2
  for (int k = 0; k < 9; ++k) {
    const int dz = k / 3 - 1, dy = k % 3 - 1;
    const long long row =
        ((long long)(zz + 1 + dz) * (ny + 2) + (yy + 1 + dy)) * row_len
        + (long long)x0 * m_c;
    __syncthreads();  // the previous row is no longer read
    for (int i = t; i < n_stage; i += blockDim.x) {
      sx[i] = x[row + i];
      sy[i] = y[row + i];
      sz[i] = z[row + i];
      ss[i] = sid[row + i];
    }
    __syncthreads();
    if (work) {
      float px = 0.0f, py = 0.0f, pz = 0.0f, pp = 0.0f;
      for (int j = w0; j < w0 + 3 * m_c; ++j) {
        const float ddx = tx - sx[j];
        const float ddy = ty - sy[j];
        const float ddz = tz - sz[j];
        const int s = ss[j];
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
      ax += px;
      ay += py;
      az += pz;
      ap += pp;
    }
  }
  if (active) {
    const long long o = ((long long)zz * ny + yy) * nx * m_c
                        + (long long)(x0 + cell) * m_c + slot;
    fx[o] = ax;
    fy[o] = ay;
    fz[o] = az;
    pot[o] = ap;
  }
}

template <int KIND>
cudaError_t launch(const float* x, const float* y, const float* z,
                   const int* sid, float* fx, float* fy, float* fz,
                   float* pot, int nx, int ny, int nz, int m_c, float cutoff2,
                   PairParams prm, cudaStream_t stream) {
  int cx_cells = kTargetThreads / m_c;
  if (cx_cells < 1) cx_cells = 1;
  if (cx_cells > nx) cx_cells = nx;
  const int threads = (cx_cells * m_c + 31) / 32 * 32;
  const size_t smem = (size_t)16 * (cx_cells + 2) * m_c;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xpencil_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((nx + cx_cells - 1) / cx_cells, ny, nz);
  xpencil_kernel<KIND><<<grid, threads, smem, stream>>>(
      x, y, z, sid, fx, fy, fz, pot, nx, ny, m_c, cx_cells, cutoff2, prm);
  return cudaGetLastError();
}

}  // namespace

// Planes x, y, z (float32) and slot_id (int32) of shape
// (nz+2, ny+2, (nx+2)*m_c), contiguous; outputs fx, fy, fz, pot (float32)
// of shape (nz, ny, nx*m_c). m_c <= 1024 (one thread per target slot).
// Allocates nothing and does not synchronise; returns the launch's
// cudaError_t.
extern "C" int xpencil_forces_f32(const void* x, const void* y, const void* z,
                                  const void* slot_id, void* fx, void* fy,
                                  void* fz, void* pot, int nx, int ny, int nz,
                                  int m_c, float cutoff2, int kind, float p0,
                                  float p1, float p2, float p3, int n_extra,
                                  void* stream) {
  if (m_c < 1 || m_c > kMaxThreads || nx < 1 || ny < 1 || nz < 1)
    return cudaErrorInvalidValue;
  const PairParams prm{p0, p1, p2, p3, n_extra};
  const float* px = static_cast<const float*>(x);
  const float* py = static_cast<const float*>(y);
  const float* pz = static_cast<const float*>(z);
  const int* ps = static_cast<const int*>(slot_id);
  float* ox = static_cast<float*>(fx);
  float* oy = static_cast<float*>(fy);
  float* oz = static_cast<float*>(fz);
  float* op = static_cast<float*>(pot);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kLJ:
      return launch<kLJ>(px, py, pz, ps, ox, oy, oz, op, nx, ny, nz, m_c,
                         cutoff2, prm, st);
    case kLowFlop:
      return launch<kLowFlop>(px, py, pz, ps, ox, oy, oz, op, nx, ny, nz, m_c,
                              cutoff2, prm, st);
    case kHighFlop:
      return launch<kHighFlop>(px, py, pz, ps, ox, oy, oz, op, nx, ny, nz,
                               m_c, cutoff2, prm, st);
    case kGravity:
      return launch<kGravity>(px, py, pz, ps, ox, oy, oz, op, nx, ny, nz, m_c,
                              cutoff2, prm, st);
    case kSphDensity:
      return launch<kSphDensity>(px, py, pz, ps, ox, oy, oz, op, nx, ny, nz,
                                 m_c, cutoff2, prm, st);
    default:
      return cudaErrorInvalidValue;
  }
}
