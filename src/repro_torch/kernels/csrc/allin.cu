// All-in-SM cutoff forces (the paper's §5.1 schedule) in float32: kernel E.
//
// Replaces src/repro/kernels/allin.py::allin_forces (Pallas grid
// (gz, gy, gx): one program per sub-box, the overlapping halo block copied
// from HBM into VMEM scratch by explicit DMA, then 9 windowed row
// reductions).
//
// Design: one block per sub-box of (bx, by, bz) cells, on a flat grid of
// gx*gy*gz blocks (sub-box b = iz*(gy*gx) + iy*gx + ix). The block stages
// the overlapping halo block (bz+2, by+2, (bx+2)*m_c) of x, y, z and id
// from the padded planes at origin (iz*bz, iy*by, ix*bx*m_c), the slice of
// JAX's dynamic_slice, into dynamic shared memory with plain coalesced
// loads, and synchronises once; the ghost ring supplies the out-of-domain
// reads. Each thread then takes target slots of the interior, strided over
// the block (bz*by*bx*m_c targets, 1,536 at m_c = 24 and box (4, 4, 4)).
// For each target slot it visits the 9 neighbour rows in kernel B's order,
// k = 0..8 with dz = k/3 - 1 and dy = k%3 - 1, sums the contiguous 3*m_c
// window of the row, ascending, into a partial with the shared pair_step
// (pair.cuh), and adds the partial to its accumulator. Outputs go straight
// to (nz, ny, nx*m_c): no block reassembly. With this order and the one
// pair_step, kernel E gives kernel B's bits per target, whatever the box.
//
// What bounds it on the card: operations. E does kernel B's dense-slot pair
// work (9 * 3 * m_c candidates per occupied target slot; at 4 particles per
// cell and m_c = 24 about 3% of them are pairs of real particles), and
// reads each halo slot from device memory once per sub-box, not once per
// neighbour row as B does. What it pays for that is the paper's verdict on
// All-in-SM: the staged halo is 16 * (bz+2)(by+2)(bx+2) * m_c bytes
// (82,944 B at m_c = 24 and box (4, 4, 4); 138,240 B at m_c = 40), so an SM
// holds only two blocks, or one, of at most 512 threads: 16 or 8 resident
// warps to hide the latency of the pair arithmetic, against the dozens of
// small-footprint blocks of kernel B. Overlapping the staging of the next
// sub-box with the arithmetic (cp.async or TMA into a second buffer) is
// later work; the footprint leaves room for it only at small m_c.

#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

using namespace pair_kernels;

constexpr int kAllinThreads = 512;

template <int KIND>
__global__ void __launch_bounds__(kAllinThreads)
allin_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ z, const int* __restrict__ sid,
             float* __restrict__ fx, float* __restrict__ fy,
             float* __restrict__ fz, float* __restrict__ pot, int nx, int ny,
             int m_c, int bx, int by, int bz, float cutoff2,
             PairParams prm) {
  extern __shared__ float halo[];
  const int hw = (bx + 2) * m_c;             // halo row width (slots)
  const int h_len = (bz + 2) * (by + 2) * hw;
  float* hx = halo;
  float* hy = hx + h_len;
  float* hz = hy + h_len;
  int* hs = reinterpret_cast<int*>(hz + h_len);

  const int gx = nx / bx, gy = ny / by;
  const int b = blockIdx.x;
  const int ix = b % gx, iy = (b / gx) % gy, iz = b / (gx * gy);
  const int z0 = iz * bz, y0 = iy * by;
  const long long row_len = (long long)(nx + 2) * m_c;
  const long long col0 = (long long)ix * bx * m_c;

  for (int i = threadIdx.x; i < h_len; i += blockDim.x) {
    const int r = i / hw, c = i - r * hw;
    const int hzr = r / (by + 2), hyr = r - hzr * (by + 2);
    const long long g =
        ((long long)(z0 + hzr) * (ny + 2) + (y0 + hyr)) * row_len + col0 + c;
    hx[i] = x[g];
    hy[i] = y[g];
    hz[i] = z[g];
    hs[i] = sid[g];
  }
  __syncthreads();

  const int tw = bx * m_c;                   // target slots per halo row
  const int n_targets = bz * by * tw;
  const long long out_row = (long long)nx * m_c;
  for (int t = threadIdx.x; t < n_targets; t += blockDim.x) {
    const int r = t / tw, c = t - r * tw;
    const int tz = r / by, ty = r - tz * by;
    const int w_col = (c / m_c) * m_c;       // window start: cell to the left
    const int ti = ((tz + 1) * (by + 2) + (ty + 1)) * hw + m_c + c;
    const int tid = hs[ti];
    float ax = 0.0f, ay = 0.0f, az = 0.0f, ap = 0.0f;
    if (tid >= 0) {
      const float tx = hx[ti], tyv = hy[ti], tzv = hz[ti];
      for (int k = 0; k < 9; ++k) {
        const int dz = k / 3 - 1, dy = k % 3 - 1;
        const int w0 = ((tz + 1 + dz) * (by + 2) + (ty + 1 + dy)) * hw + w_col;
        float px = 0.0f, py = 0.0f, pz = 0.0f, pp = 0.0f;
        for (int j = w0; j < w0 + 3 * m_c; ++j)
          pair_step<KIND>(tx, tyv, tzv, tid, hx[j], hy[j], hz[j], hs[j],
                          cutoff2, prm, px, py, pz, pp);
        ax += px;
        ay += py;
        az += pz;
        ap += pp;
      }
    }
    const long long o =
        ((long long)(z0 + tz) * ny + (y0 + ty)) * out_row + col0 + c;
    fx[o] = ax;
    fy[o] = ay;
    fz[o] = az;
    pot[o] = ap;
  }
}

}  // namespace

// Kernel E. Planes x, y, z (float32) and slot_id (int32) of shape
// (nz+2, ny+2, (nx+2)*m_c), contiguous; the sub-box (bx, by, bz) divides
// (nx, ny, nz); outputs fx, fy, fz, pot (float32) of shape (nz, ny, nx*m_c).
// Needs 16*(bz+2)*(by+2)*(bx+2)*m_c bytes of shared memory, at most 227 KB.
// Allocates nothing and does not synchronise; returns the launch's
// cudaError_t.
extern "C" int allin_forces_f32(const void* x, const void* y, const void* z,
                                const void* slot_id, void* fx, void* fy,
                                void* fz, void* pot, int nx, int ny, int nz,
                                int m_c, int bx, int by, int bz,
                                float cutoff2, int kind, float p0, float p1,
                                float p2, float p3, int n_extra,
                                void* stream) {
  if (m_c < 1 || nx < 1 || ny < 1 || nz < 1 || bx < 1 || by < 1 || bz < 1 ||
      nx % bx || ny % by || nz % bz)
    return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)16 * (bz + 2) * (by + 2) * (bx + 2) * (size_t)m_c;
  const long long n_blocks = (long long)(nx / bx) * (ny / by) * (nz / bz);
  if (smem > kMaxSmem || n_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int n_targets = bz * by * bx * m_c;
  const int threads = n_targets < kAllinThreads
                          ? (n_targets + 31) / 32 * 32
                          : kAllinThreads;
  const PairParams prm{p0, p1, p2, p3, n_extra};
  return by_kind(kind, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const cudaError_t err = allow_smem(allin_kernel<K>, smem);
    if (err != cudaSuccess) return err;
    allin_kernel<K><<<(unsigned)n_blocks, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(z), static_cast<const int*>(slot_id),
        static_cast<float*>(fx), static_cast<float*>(fy),
        static_cast<float*>(fz), static_cast<float*>(pot), nx, ny, m_c, bx,
        by, bz, cutoff2, prm);
    return cudaGetLastError();
  });
}
