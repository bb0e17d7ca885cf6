"""The packed-row layout's slot moves: wrapper of ``csrc/pack.cu``.

``pack_slots`` is the part of ``core.binning.pack_rows`` after the per-cell
counts and their scan (kernel A): it moves every occupied dense slot of a
padded row to its packed slot, writes the fill values of the rest, and maps
each particle's dense slot to its packed one. On CPU tensors it runs the
plain version (``core.binning.pack_slots_plain``, the same scatters in
PyTorch that JAX's ``pack_rows`` makes); on CUDA tensors it launches the
kernel or raises. ``pack_slots.launches`` counts the launches. Stacked
bins (a leading system axis on every tensor) take one launch. It replaces
no Pallas kernel: ``src/repro/core/binning.py::pack_rows`` is plain JAX.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..core.binning import EMPTY_POS, CellBins, pack_slots_plain
from ._common import check_tensors, launch, systems

MAX_FIELDS = 16        # csrc/pack.cu: kMaxFields


def _fill_bits(name: str, dtype: torch.dtype) -> int:
    """The fill of a packed field's empty slots as the bits of a 4-byte
    element: EMPTY_POS for x, y, z, else 0 (``pack_slots_plain``)."""
    fill = EMPTY_POS if name in ("x", "y", "z") else 0.0
    return int(torch.tensor([fill], dtype=dtype).view(torch.int32)) & 0xFFFFFFFF


def pack_slots(bins: CellBins, offsets: torch.Tensor, row_counts: torch.Tensor,
               *, nx: int, ny: int, row_cap: int
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The packed layout's planes from dense bins.

    Args:
      bins: dense :class:`CellBins` whose cells hold their particles in
        their first slots (as ``bin_particles`` leaves them).
      offsets: (nz+2, ny+2, nx+2) int32, each padded row's exclusive scan of
        its cells' occupied slots.
      row_counts: (nz+2, ny+2) int32 occupied slots per padded row.
      (Stacked bins: each with the bins' leading system axis.)
    Returns:
      (planes, slot_id, slot_cell, particle_slot): every field of
      ``bins.planes`` and the ids and cells, each (nz+2, ny+2, row_cap),
      and the (N,) int32 packed slot of every particle.
    """
    sid = bins.slot_id
    if sid.device.type == "cpu":
        return pack_slots_plain(bins, offsets, row_counts, nx=nx, ny=ny,
                                row_cap=row_cap)
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
    n = bins.particle_slot.shape[-1]
    tensors = [("slot_id", sid, torch.int32, sid.shape),
               ("offsets", offsets, torch.int32, (*lead, nzp, nyp, nx + 2)),
               ("row_counts", row_counts, torch.int32, (*lead, nzp, nyp)),
               ("particle_slot", bins.particle_slot, torch.int32,
                (*lead, n))]
    for name, plane in bins.planes.items():
        if plane.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"pack_slots moves 4-byte fields; {name} is "
                             f"{plane.dtype}")
        tensors.append((name, plane, plane.dtype, sid.shape))
    check_tensors(sid.device, tensors, "pack_slots")
    shape = (*lead, nzp, nyp, row_cap)
    planes = {name: torch.empty(shape, dtype=p.dtype, device=sid.device)
              for name, p in bins.planes.items()}
    slot_id = torch.empty(shape, dtype=torch.int32, device=sid.device)
    slot_cell = torch.empty(shape, dtype=torch.int32, device=sid.device)
    particle_slot = torch.empty((*lead, n), dtype=torch.int32,
                                device=sid.device)
    k = len(planes)
    src = (ctypes.c_void_p * max(k, 1))(
        *(p.data_ptr() for p in bins.planes.values()))
    dst = (ctypes.c_void_p * max(k, 1))(*(p.data_ptr() for p in planes.values()))
    fill = (ctypes.c_uint * max(k, 1))(
        *(_fill_bits(name, p.dtype) for name, p in bins.planes.items()))
    launch("pack.cu", "pack_rows_f32", sid, *(ctypes.cast(a, ctypes.c_void_p)
                                              for a in (src, dst, fill)), k,
           sid.data_ptr(), offsets.data_ptr(), row_counts.data_ptr(),
           bins.particle_slot.data_ptr(), slot_id.data_ptr(),
           slot_cell.data_ptr(), particle_slot.data_ptr(), n_sys, nx, ny,
           nzp - 2, m_c, row_cap, n)
    pack_slots.launches += 1
    return planes, slot_id, slot_cell, particle_slot


pack_slots.launches = 0
