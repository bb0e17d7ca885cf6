// The packed-row layout's slot moves (core/binning.py::pack_rows) in one
// kernel. Replaces the plain part of src/repro/core/binning.py::pack_rows
// (JAX, no Pallas kernel): about forty launches that build an int64
// destination for every dense slot and scatter each field through it.
//
// The per-cell counts and their scan (kernel A) stay outside; this kernel
// takes the per-row exclusive cell offsets and moves the data:
//   * one block per padded (z, y) row: every dense slot (c, r) of the row
//     with id >= 0 goes to packed slot offsets[c] + r when that is below
//     row_cap (the slots past it are dropped), with each field, its id and
//     its cell c; then the row's slots [min(row_count, row_cap), row_cap)
//     get the fill values (EMPTY_POS or 0 for the fields, -1 for the id, 1
//     for the cell);
//   * the blocks after those: one thread per particle maps its dense slot
//     to its packed slot, (z * ny + y) * (row_cap + 1) + position, with the
//     plain version's clamps (a particle the dense binning dropped reads the
//     first offset of the last padded plane and lands past the rows).
// Stacked systems (InteractionPlan.execute_batch): n_sys systems whose
// arrays follow one another, each of one system's size, in one launch whose
// grid's y index is the system; dense_slot and pslot stay per system.
//
// Each dense slot's id is read once, and each packed slot written once:
// the cells of dense bins hold their particles in their first slots, so
// the moved slots of a row are exactly its first min(row_count, row_cap).
//
// What bounds it: bytes. At division 64 and m_c 32 it reads 37 MB of slot
// ids and the 1 M particles' fields and writes about 34 MB of packed planes;
// the reads of the occupied slots cover a sector each for about 4 particles.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxFields = 16;
constexpr int kPackThreads = 256;
constexpr int kMaxSystems = 65535;  // a grid's y extent

// Fields of 4-byte elements (float32 or int32), moved as bits.
struct Fields {
  const uint32_t* src[kMaxFields];
  uint32_t* dst[kMaxFields];
  uint32_t fill[kMaxFields];
  int n;
};

__global__ void __launch_bounds__(kPackThreads)
pack_rows_kernel(Fields f, const int* __restrict__ sid,
                 const int* __restrict__ offsets,
                 const int* __restrict__ row_counts,
                 const int* __restrict__ dense_slot, int* __restrict__ psid,
                 int* __restrict__ pcell, int* __restrict__ pslot, int n_prow,
                 int nx, int ny, int m_c, int row_cap, int n_particles) {
  const int t = threadIdx.x;
  const int w = (nx + 2) * m_c;  // dense slots of a padded row
  const long long sys = blockIdx.y;  // the block's system
  if ((int)blockIdx.x < n_prow) {
    // systems follow one another: the row's index over the batch
    const long long row = sys * n_prow + blockIdx.x;
    const int* off = offsets + row * (nx + 2);
    const long long dbase = row * w, pbase = row * row_cap;
    for (int i = t; i < w; i += kPackThreads) {
      const int s = sid[dbase + i];
      if (s < 0) continue;
      const int c = i / m_c;
      const int d = off[c] + (i - c * m_c);
      if (d >= row_cap) continue;
      for (int a = 0; a < f.n; ++a) f.dst[a][pbase + d] = f.src[a][dbase + i];
      psid[pbase + d] = s;
      pcell[pbase + d] = c;
    }
    for (int d = min(row_counts[row], row_cap) + t; d < row_cap;
         d += kPackThreads) {
      for (int a = 0; a < f.n; ++a) f.dst[a][pbase + d] = f.fill[a];
      psid[pbase + d] = -1;
      pcell[pbase + d] = 1;
    }
    return;
  }
  const int i = (blockIdx.x - n_prow) * kPackThreads + t;
  if (i >= n_particles) return;
  offsets += sys * n_prow * (nx + 2);
  dense_slot += sys * n_particles;
  pslot += sys * n_particles;
  const int nzp = n_prow / (ny + 2);
  const long long plane = (long long)(ny + 2) * w;
  const long long ds = dense_slot[i];
  const long long zp = ds / plane, rem = ds % plane;
  const long long yp = rem / w, col = rem % w;
  const long long c = col / m_c, r = col % m_c;
  const long long zc = zp < nzp - 1 ? zp : nzp - 1;
  long long pos = offsets[(zc * (ny + 2) + yp) * (nx + 2) + c] + r;
  if (pos > row_cap) pos = row_cap;
  pslot[i] = (int)(((zp - 1) * ny + (yp - 1)) * (row_cap + 1) + pos);
}

}  // namespace

// The packed layout's moves, for n_sys stacked systems (1 <= n_sys <=
// 65535; every shape below has a leading n_sys). sid (int32) and the
// n_fields planes (4-byte elements) of shape (nz+2, ny+2, (nx+2)*m_c);
// offsets (int32) of shape (nz+2, ny+2, nx+2), each row's exclusive scan of
// its cells' occupied slots; row_counts (int32, (nz+2, ny+2)); dense_slot
// (int32, n_particles), CellBins.particle_slot. Writes the packed planes
// (fill bits fill[a]), psid, pcell of shape (nz+2, ny+2, row_cap) and pslot
// (int32, n_particles). At most 16 fields. Allocates nothing and does not
// synchronise; returns the launch's cudaError_t.
extern "C" int pack_rows_f32(const void* const* src, void* const* dst,
                             const unsigned* fill, int n_fields,
                             const void* sid, const void* offsets,
                             const void* row_counts, const void* dense_slot,
                             void* psid, void* pcell, void* pslot, int n_sys,
                             int nx, int ny, int nz, int m_c, int row_cap,
                             int n_particles, void* stream) {
  if (n_fields < 0 || n_fields > kMaxFields || n_sys < 1 ||
      n_sys > kMaxSystems || nx < 1 || ny < 1 || nz < 1 || m_c < 1 ||
      row_cap < 1 || n_particles < 0)
    return cudaErrorInvalidValue;
  Fields f;
  f.n = n_fields;
  for (int a = 0; a < n_fields; ++a) {
    f.src[a] = static_cast<const uint32_t*>(src[a]);
    f.dst[a] = static_cast<uint32_t*>(dst[a]);
    f.fill[a] = fill[a];
  }
  const int n_prow = (nz + 2) * (ny + 2);
  const int blocks = n_prow + (n_particles + kPackThreads - 1) / kPackThreads;
  pack_rows_kernel<<<dim3(blocks, n_sys), kPackThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<const int*>(sid), static_cast<const int*>(offsets),
      static_cast<const int*>(row_counts),
      static_cast<const int*>(dense_slot), static_cast<int*>(psid),
      static_cast<int*>(pcell), static_cast<int*>(pslot), n_prow, nx, ny, m_c,
      row_cap, n_particles);
  return cudaGetLastError();
}
