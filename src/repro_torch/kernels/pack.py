"""The packed-row layout: wrapper of ``csrc/pack.cu``.

``pack_slots`` is all of ``core.binning.pack_rows`` on dense bins: each
padded row's per-cell counts of occupied slots, their exclusive scan
(``cell_offsets``, ``row_counts``), every occupied slot moved to its packed
slot with the fill values written behind, and each particle's dense slot
mapped to its packed one. On CPU tensors it runs the plain version
(``core.binning.pack_slots_plain``, JAX's ``pack_rows`` in PyTorch); on
CUDA tensors it launches the kernel (one call, two grids: the rows, then
the particle map, which reads offsets other row blocks wrote) or raises.
``pack_slots.launches`` counts those calls. Stacked bins (a leading system
axis on every tensor) take one call. It replaces no Pallas kernel:
``src/repro/core/binning.py::pack_rows`` is plain JAX.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from ..core.binning import EMPTY_POS, CellBins, pack_slots_plain
from ._common import check_tensors, launch, systems

MAX_FIELDS = 16          # csrc/pack.cu: kMaxFields
MAX_ROW_CELLS = 12272    # csrc/pack.cu: kMaxRowCells, nx + 3 at most
PACK_THREADS = 256       # csrc/pack.cu: kPackThreads, a block's threads
MAX_ROWS_PER_BLOCK = 8   # csrc/pack.cu: kMaxRowsPerBlock
ROW_WORK = 4             # csrc/pack.cu: kRowWork


def rows_per_block(nx: int, m_c: int, row_cap: int) -> int:
    """Padded rows one block of the pack kernel packs (``csrc/pack.cu::
    rows_per_block``): the most, a power of two up to MAX_ROWS_PER_BLOCK,
    that leave each row enough threads to take at most ROW_WORK of its
    packed positions and of its 16-byte id loads a thread."""
    work = max(row_cap, ((nx + 2) * m_c + 3) // 4)
    rows = MAX_ROWS_PER_BLOCK
    while rows > 1 and PACK_THREADS // rows * ROW_WORK < work:
        rows //= 2
    return rows


def _fill_bits(name: str, dtype: torch.dtype) -> int:
    """The fill of a packed field's empty slots as the bits of a 4-byte
    element: EMPTY_POS for x, y, z, else 0 (``pack_slots_plain``)."""
    fill = EMPTY_POS if name in ("x", "y", "z") else 0.0
    return int(torch.tensor([fill], dtype=dtype).view(torch.int32)) & 0xFFFFFFFF


def pack_slots(bins: CellBins, *, nx: int, ny: int, row_cap: int
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor,
                          torch.Tensor, torch.Tensor, torch.Tensor]:
    """The packed layout's tensors from dense bins.

    Args:
      bins: dense :class:`CellBins` whose cells hold their particles in
        their first slots (as every producer of dense bins leaves them).
    Returns:
      (planes, slot_id, slot_cell, cell_offsets, row_counts,
      particle_slot): every field of ``bins.planes`` and the ids and cells,
      each (nz+2, ny+2, row_cap); (nz+2, ny+2, nx+3) int32 cell offsets,
      each row's exclusive scan of its cells' occupied slots and then its
      total; (nz+2, ny+2) int32 occupied slots per row; the (N,) int32
      packed slot of every particle. (Stacked bins: each with the bins'
      leading system axis.)
    """
    sid = bins.slot_id
    if sid.device.type == "cpu":
        return pack_slots_plain(bins, nx=nx, ny=ny, row_cap=row_cap)
    if sid.device.type != "cuda":
        raise ValueError(f"pack_slots runs on cpu or cuda, not {sid.device}")
    lead, n_sys = systems(sid, 3, "pack_slots")
    nzp, nyp, width = sid.shape[-3:]
    m_c = bins.m_c
    if nyp != ny + 2 or width != (nx + 2) * m_c or row_cap < 1:
        raise ValueError(f"dense planes of shape {tuple(sid.shape)} do not "
                         f"match nx={nx}, ny={ny}, m_c={m_c}")
    if len(bins.planes) > MAX_FIELDS:
        raise ValueError(f"pack_slots moves at most {MAX_FIELDS} fields, got "
                         f"{len(bins.planes)}")
    if nx + 3 > MAX_ROW_CELLS:
        raise ValueError(f"pack_slots scans rows of at most "
                         f"{MAX_ROW_CELLS - 3} cells, got nx={nx}")
    n = bins.particle_slot.shape[-1]
    tensors = [("slot_id", sid, torch.int32, sid.shape),
               ("particle_slot", bins.particle_slot, torch.int32,
                (*lead, n))]
    for name, plane in bins.planes.items():
        if plane.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"pack_slots moves 4-byte fields; {name} is "
                             f"{plane.dtype}")
        tensors.append((name, plane, plane.dtype, sid.shape))
    check_tensors(sid.device, tensors, "pack_slots")
    shape = (*lead, nzp, nyp, row_cap)
    *planes, slot_id, slot_cell, cell_offsets, row_counts, particle_slot = \
        _outputs(sid.device, [
            *((p.dtype, shape) for p in bins.planes.values()),
            (torch.int32, shape), (torch.int32, shape),
            (torch.int32, (*lead, nzp, nyp, nx + 3)),
            (torch.int32, (*lead, nzp, nyp)), (torch.int32, (*lead, n))])
    planes = dict(zip(bins.planes, planes))
    k = len(planes)
    src = (ctypes.c_void_p * max(k, 1))(
        *(p.data_ptr() for p in bins.planes.values()))
    dst = (ctypes.c_void_p * max(k, 1))(*(p.data_ptr() for p in planes.values()))
    fill = _fill_array(tuple((name, p.dtype)
                             for name, p in bins.planes.items()))
    launch("pack.cu", "pack_rows_f32", sid, *(ctypes.cast(a, ctypes.c_void_p)
                                              for a in (src, dst, fill)), k,
           sid.data_ptr(), bins.particle_slot.data_ptr(), slot_id.data_ptr(),
           slot_cell.data_ptr(), cell_offsets.data_ptr(),
           row_counts.data_ptr(), particle_slot.data_ptr(), n_sys, nx, ny,
           nzp - 2, m_c, row_cap, n)
    pack_slots.launches += 1
    return planes, slot_id, slot_cell, cell_offsets, row_counts, particle_slot


def _outputs(device, specs):
    """One contiguous tensor of each (dtype, shape) of ``specs`` (4-byte
    dtypes), all views of one int32 allocation: ``pack_slots`` returns
    eight tensors or more, and on the card each allocation costs the host
    more than a view does."""
    size, views = _layout(tuple(specs))
    buf = torch.empty((size,), dtype=torch.int32, device=device)
    return [buf.as_strided(shape, strides, start) if dtype == torch.int32
            else buf.as_strided(shape, strides, start).view(dtype)
            for dtype, shape, strides, start in views]


@functools.lru_cache(maxsize=256)
def _layout(specs):
    """(int32 elements, [(dtype, shape, strides, start)]) of ``_outputs``:
    each tensor contiguous, starting on a 512-byte boundary as the caching
    allocator's blocks do."""
    views, end = [], 0
    for dtype, shape in specs:
        strides = [1] * len(shape)
        for i in range(len(shape) - 1, 0, -1):
            strides[i - 1] = strides[i] * shape[i]
        views.append((dtype, shape, tuple(strides), end))
        end += -(-math.prod(shape) // 128) * 128
    return end, tuple(views)


@functools.lru_cache(maxsize=256)
def _fill_array(fields) -> ctypes.Array:
    """The C array of the fill bits of ``fields``' (name, dtype) pairs."""
    return (ctypes.c_uint * max(len(fields), 1))(
        *(_fill_bits(name, dtype) for name, dtype in fields))


pack_slots.launches = 0
