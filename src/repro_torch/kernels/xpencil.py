"""X-pencil forces: wrappers of the CUDA kernels in ``csrc/xpencil.cu``.

  xpencil_forces         kernel B, dense planes, every pencil
                         (replaces ``repro/kernels/xpencil.py::xpencil_forces``)
  xpencil_sparse_forces  kernel C, dense planes, a list of active pencils
                         (replaces ``::xpencil_sparse_forces``)
  xpencil_packed_forces  kernel D, packed (CSR) rows, a list of pencil rows
                         (replaces ``::xpencil_packed_forces``)

On CPU tensors each wrapper runs its plain version (the same schedule in
PyTorch, ``repro_torch.core.strategies.xpencil_*planes``); on CUDA tensors
it launches its kernel or raises. ``<wrapper>.launches`` counts the
launches. Every tensor may carry a leading axis of stacked systems; one
launch then covers them all (a kernel D tile never spans two systems). All three launch work per real particle and visit only the real
sources of each target's window, in ascending slot order: kernels B and C
compact each staged neighbour row in shared memory (``pencil_smem_bytes``
at the chunk width ``chunk_cells``); kernel D takes a tile of
``packed_tile_rows`` consecutive pencils a block and stages each dz plane's
rows of them as one segment, shared by the tile's pencils
(``packed_smem_bytes``). See the note in the CUDA source.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.interactions import PairKernel
from ..core.strategies import (xpencil_packed_planes, xpencil_planes,
                               xpencil_sparse_planes)
from ._common import (MAX_SMEM, check_tensors, cuda_form, launch,
                      new_outputs, systems)

# kernels B and C (csrc/xpencil.cu: kPencilWarps, kMaxChunkCells, kChunkSmem)
PENCIL_WARPS = 4              # 128 threads a block
MAX_CHUNK_CELLS = 64
CHUNK_SMEM = 48 * 1024        # bytes of shared memory the chunk width aims at


def pencil_smem_bytes(cx_cells: int, m_c: int) -> int:
    """Shared memory of one kernel B/C block at a chunk width of
    ``cx_cells`` cells (``csrc/xpencil.cu::pencil_smem``): two mbarriers
    (16 B), the compacted sources (16 B each) and two staging buffers of x,
    y, z and id (32 B a slot) over the ``(cx_cells+2)*m_c`` slots of a
    neighbour row, then 4 B each for the cell offsets, the target list and
    the warp counts."""
    return (16 + 48 * (cx_cells + 2) * m_c
            + 4 * (cx_cells * m_c + cx_cells + 3 + PENCIL_WARPS))


def chunk_cells(nx: int, m_c: int) -> int:
    """Kernel B/C's chunk width (``csrc/xpencil.cu::chunk_cells``): the
    widest up to ``MAX_CHUNK_CELLS`` cells whose block needs at most
    ``CHUNK_SMEM`` bytes (at least 1), evened out over the row's chunks."""
    cx = min(nx, MAX_CHUNK_CELLS)
    while cx > 1 and pencil_smem_bytes(cx, m_c) > CHUNK_SMEM:
        cx -= 1
    n_chunks = -(-nx // cx)
    return -(-nx // n_chunks)


# the largest m_c whose block of one cell fits a block's shared memory
MAX_M_C = ((MAX_SMEM - pencil_smem_bytes(1, 0))
           // (pencil_smem_bytes(1, 1) - pencil_smem_bytes(1, 0)))

# kernel D (csrc/xpencil.cu: kPackedThreads, kPackedTargets, kMaxTileRows,
# kPackedSmem, kMinTiles)
PACKED_THREADS = 384
PACKED_TARGETS = 2 * PACKED_THREADS      # the targets of a block
MAX_TILE_ROWS = 32                       # a warp's lanes hold a tile's list
PACKED_SMEM = 88 * 1024                  # two blocks an SM
MIN_TILES = 2 * 132                      # two tiles an H100 SM


def packed_smem_bytes(tile_rows: int, row_cap: int) -> int:
    """Shared memory of one kernel D block (``csrc/xpencil.cu::
    packed_smem``): at ``tile_rows >= 1`` pencils a tile, two mbarriers
    (16 B), two staging buffers of x, y, z and id (32 B a slot) over the
    ``tile_rows + 2`` rows of a dz plane and the sums of the block's
    ``PACKED_TARGETS`` targets (16 B each); at 0, one pencil a tile, one
    buffer of one row."""
    if tile_rows > 0:
        return 16 + 32 * (tile_rows + 2) * row_cap + 16 * PACKED_TARGETS
    return 16 * row_cap


def packed_split(tile_rows: int, row_cap: int) -> int:
    """The targets a kernel D block takes (``csrc/xpencil.cu::
    packed_split``): a tile's slots, ``tile_rows`` (or 1) times
    ``row_cap``, split evenly into the fewest parts of at most
    ``PACKED_TARGETS`` (``tile_rows >= 1``) or ``PACKED_THREADS`` (0)."""
    slots = max(tile_rows, 1) * row_cap
    cap = PACKED_TARGETS if tile_rows > 0 else PACKED_THREADS
    parts = -(-slots // cap)
    return -(-slots // parts)


def packed_tile_rows(row_cap: int, n_rows: int) -> int:
    """Kernel D's pencils a tile (``csrc/xpencil.cu::packed_tile_rows``):
    the most, up to ``MAX_TILE_ROWS``, whose block needs at most
    ``PACKED_SMEM`` bytes and that leave at least ``MIN_TILES`` tiles of the
    ``n_rows`` entries (at least 1); 0 where a block of one pencil exceeds
    ``MAX_SMEM`` (``row_cap`` > 2293). A launch over stacked systems sizes
    its tile on the batch's entries, ``n_sys * n_rows``."""
    if packed_smem_bytes(1, row_cap) > MAX_SMEM:
        return 0
    r = MAX_TILE_ROWS
    while r > 1 and (packed_smem_bytes(r, row_cap) > PACKED_SMEM
                     or r * MIN_TILES > n_rows):
        r -= 1
    return r


# the largest row_cap kernel D takes: one row of 16 B a slot (tile_rows 0)
MAX_ROW_CAP = MAX_SMEM // 16


def _dense_planes(x, y, z, slot_id, nx: int, m_c: int, what: str):
    """Check kernel B/C's dense planes -> (nz, ny)."""
    if not 1 <= m_c <= MAX_M_C:
        raise ValueError(
            f"m_c={m_c} does not fit the CUDA X-pencil kernel: a block of "
            f"one cell stages {pencil_smem_bytes(1, m_c)} bytes of shared "
            f"memory, at most {MAX_SMEM} (1 <= m_c <= {MAX_M_C})")
    nzp, nyp, width = x.shape[-3:]
    if width != (nx + 2) * m_c or nzp < 3 or nyp < 3:
        raise ValueError(f"planes of shape {tuple(x.shape)} do not match "
                         f"nx={nx}, m_c={m_c}")
    check_tensors(x.device, [(n, t, d, x.shape) for n, t, d in (
        ("x", x, torch.float32), ("y", y, torch.float32),
        ("z", z, torch.float32), ("slot_id", slot_id, torch.int32))], what)
    return nzp - 2, nyp - 2


def _check_chunk(cx_cells: Optional[int], nx: int, m_c: int) -> None:
    if cx_cells is not None and not (
            1 <= cx_cells <= nx
            and pencil_smem_bytes(cx_cells, m_c) <= MAX_SMEM):
        raise ValueError(
            f"cx_cells={cx_cells} is not a chunk width of kernels B/C: "
            f"1 <= cx_cells <= nx={nx}, and a block stages "
            f"{pencil_smem_bytes(cx_cells, m_c)} bytes of shared memory, "
            f"at most {MAX_SMEM}")


def xpencil_forces(planes: Dict[str, torch.Tensor], slot_id: torch.Tensor, *,
                   nx: int, m_c: int, kernel: PairKernel, cutoff2: float,
                   cx_cells: Optional[int] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """Kernel B: the X-pencil schedule over padded planes.

    Args:
      planes: "x", "y", "z" float32 planes of shape (nz+2, ny+2, (nx+2)*m_c),
        or (B, nz+2, ...) for B stacked systems (every output then (B, ...)).
      slot_id: matching int32 plane, -1 for empty slots (anywhere in a cell).
      cx_cells: the kernel's chunk width in cells, or None for
        ``chunk_cells(nx, m_c)``; the result does not depend on it.
    Returns:
      (fx, fy, fz, pot), each (nz, ny, nx*m_c) over the interior slots.
    """
    x, y, z = planes["x"], planes["y"], planes["z"]
    _check_chunk(cx_cells, nx, m_c)
    if x.device.type == "cpu":
        return xpencil_planes(x, y, z, slot_id, nx=nx, m_c=m_c,
                              kernel=kernel, cutoff2=cutoff2)
    if x.device.type != "cuda":
        raise ValueError(f"xpencil_forces runs on cpu or cuda, not {x.device}")
    form = cuda_form(kernel)
    lead, n_sys = systems(x, 3, "xpencil_forces")
    nz, ny = _dense_planes(x, y, z, slot_id, nx, m_c, "xpencil_forces")
    outs = new_outputs((*lead, nz, ny, nx * m_c), x.device)
    ptrs = (x.data_ptr(), y.data_ptr(), z.data_ptr(), slot_id.data_ptr())
    if cx_cells is None:
        launch("xpencil.cu", "xpencil_forces_f32", x, *ptrs,
               *(o.data_ptr() for o in outs), n_sys, nx, ny, nz, m_c,
               float(cutoff2), *form)
    else:
        launch("xpencil.cu", "xpencil_chunked_f32", x, *ptrs, None,
               *(o.data_ptr() for o in outs), n_sys, nz * ny, nx, ny, nz,
               m_c, cx_cells, float(cutoff2), *form)
    xpencil_forces.launches += 1
    return outs


def xpencil_sparse_forces(planes: Dict[str, torch.Tensor],
                          slot_id: torch.Tensor, active_zy: torch.Tensor, *,
                          nx: int, ny: int, m_c: int, kernel: PairKernel,
                          cutoff2: float, cx_cells: Optional[int] = None
                          ) -> Tuple[torch.Tensor, ...]:
    """Kernel C: the X-pencil schedule over the listed pencils.

    Args:
      planes / slot_id: dense padded planes as in :func:`xpencil_forces`.
      active_zy: (n_rows,) int32 interior pencil ids ``z * ny + y``, each in
        [0, nz * ny) (``Occupancy.active``; its padding, pencil 0,
        recomputes pencil 0 and is dropped by the caller's scatter);
        (B, n_rows) for stacked planes, one list a system.
      cx_cells: the chunk width, as in :func:`xpencil_forces`.
    Returns:
      (fx, fy, fz, pot), each ``(n_rows, nx*m_c)``: row ``a`` holds the
      interior forces of pencil ``active_zy[a]``.
    """
    x, y, z = planes["x"], planes["y"], planes["z"]
    _check_chunk(cx_cells, nx, m_c)
    if x.device.type == "cpu":
        return xpencil_sparse_planes(x, y, z, slot_id, active_zy, nx=nx,
                                     ny=ny, m_c=m_c, kernel=kernel,
                                     cutoff2=cutoff2)
    if x.device.type != "cuda":
        raise ValueError(
            f"xpencil_sparse_forces runs on cpu or cuda, not {x.device}")
    form = cuda_form(kernel)
    lead, n_sys = systems(x, 3, "xpencil_sparse_forces")
    nz, nyy = _dense_planes(x, y, z, slot_id, nx, m_c,
                            "xpencil_sparse_forces")
    if nyy != ny:
        raise ValueError(f"planes of shape {tuple(x.shape)} do not match "
                         f"ny={ny}")
    n_rows = active_zy.shape[-1]
    check_tensors(x.device,
                  [("active_zy", active_zy, torch.int32, (*lead, n_rows))],
                  "xpencil_sparse_forces")
    outs = new_outputs((*lead, n_rows, nx * m_c), x.device)
    ptrs = (x.data_ptr(), y.data_ptr(), z.data_ptr(), slot_id.data_ptr(),
            active_zy.data_ptr())
    if cx_cells is None:
        launch("xpencil.cu", "xpencil_sparse_f32", x, *ptrs,
               *(o.data_ptr() for o in outs), n_sys, n_rows, nx, ny, nz, m_c,
               float(cutoff2), *form)
    else:
        launch("xpencil.cu", "xpencil_chunked_f32", x, *ptrs,
               *(o.data_ptr() for o in outs), n_sys, n_rows, nx, ny, nz, m_c,
               cx_cells, float(cutoff2), *form)
    xpencil_sparse_forces.launches += 1
    return outs


def xpencil_packed_forces(planes: Dict[str, torch.Tensor],
                          slot_id: torch.Tensor, slot_cell: torch.Tensor,
                          cell_offsets: torch.Tensor,
                          active_zy: Optional[torch.Tensor], *, nx: int,
                          ny: int, m_c: int, kernel: PairKernel,
                          cutoff2: float, tile_rows: Optional[int] = None
                          ) -> Tuple[torch.Tensor, ...]:
    """Kernel D: the packed-row X-pencil over the listed pencil rows.

    Args:
      planes / slot_id / slot_cell: the packed layout's ``(nz+2, ny+2,
        row_cap)`` arrays (``core.binning.PackedRows``); cell_offsets
        ``(nz+2, ny+2, nx+3)`` int32.
      active_zy: (n_rows,) int32 interior pencil ids (an
        ``Occupancy.active`` list), or None for every row in id order.
        Stacked systems add a leading axis to every array, lists included.
      m_c: the dense bound the plain version re-expands windows to; the
        kernel reads windows from the offsets and does not need it.
      tile_rows: the kernel's pencils a tile (0: one, staged a row at a
        time in one buffer), or None for ``packed_tile_rows(row_cap,
        n_sys * n_rows)``. A tile is a run of one system's list, never of
        two. The result does not depend on it.
    Returns:
      (fx, fy, fz, pot), each ``(n_rows, row_cap)``: row ``a`` holds the
      packed-slot forces of pencil ``active_zy[a]``; padding slots are 0.
    """
    x, y, z = planes["x"], planes["y"], planes["z"]
    nzp, nyp, row_cap = x.shape[-3:]
    if tile_rows is not None and not (
            0 <= tile_rows <= MAX_TILE_ROWS
            and packed_smem_bytes(tile_rows, row_cap) <= MAX_SMEM):
        raise ValueError(
            f"tile_rows={tile_rows} is not a tile of kernel D: 0 <= "
            f"tile_rows <= {MAX_TILE_ROWS}, and a block stages "
            f"{packed_smem_bytes(tile_rows, row_cap)} bytes of shared "
            f"memory, at most {MAX_SMEM}")
    if x.device.type == "cpu":
        if active_zy is None:
            active_zy = torch.arange((nzp - 2) * ny, dtype=torch.int32
                                     ).expand(*x.shape[:-3], -1)
        return xpencil_packed_planes(x, y, z, slot_id, slot_cell,
                                     cell_offsets, active_zy, nx=nx, ny=ny,
                                     m_c=m_c, kernel=kernel, cutoff2=cutoff2)
    if x.device.type != "cuda":
        raise ValueError(
            f"xpencil_packed_forces runs on cpu or cuda, not {x.device}")
    form = cuda_form(kernel)
    lead, n_sys = systems(x, 3, "xpencil_packed_forces")
    if nyp != ny + 2 or nzp < 3 or row_cap < 1:
        raise ValueError(f"packed planes of shape {tuple(x.shape)} do not "
                         f"match ny={ny}")
    if row_cap > MAX_ROW_CAP:
        raise ValueError(
            f"row_cap={row_cap} does not fit kernel D: a block stages at "
            f"least one packed row of 16*row_cap bytes in shared memory, at "
            f"most {MAX_SMEM} (row_cap <= {MAX_ROW_CAP})")
    tensors = [
        ("x", x, torch.float32, x.shape), ("y", y, torch.float32, x.shape),
        ("z", z, torch.float32, x.shape),
        ("slot_id", slot_id, torch.int32, x.shape),
        ("slot_cell", slot_cell, torch.int32, x.shape),
        ("cell_offsets", cell_offsets, torch.int32,
         (*lead, nzp, nyp, nx + 3))]
    if active_zy is None:
        n_rows, act_ptr = (nzp - 2) * ny, None
    else:
        n_rows, act_ptr = active_zy.shape[-1], active_zy.data_ptr()
        tensors.append(("active_zy", active_zy, torch.int32,
                        (*lead, n_rows)))
    check_tensors(x.device, tensors, "xpencil_packed_forces")
    outs = new_outputs((*lead, n_rows, row_cap), x.device)
    launch("xpencil.cu", "xpencil_packed_f32", x, x.data_ptr(), y.data_ptr(),
           z.data_ptr(), slot_id.data_ptr(), slot_cell.data_ptr(),
           cell_offsets.data_ptr(), act_ptr, *(o.data_ptr() for o in outs),
           n_sys, n_rows, nx, ny, nzp - 2, row_cap,
           -1 if tile_rows is None else tile_rows, float(cutoff2), *form)
    xpencil_packed_forces.launches += 1
    return outs


xpencil_forces.launches = 0
xpencil_sparse_forces.launches = 0
xpencil_packed_forces.launches = 0
