"""All-in-SM forces: the wrapper of the CUDA kernel in ``csrc/allin.cu``.

  allin_forces  kernel E, dense planes, one block per sub-box
                (replaces ``repro/kernels/allin.py::allin_forces``)

On CPU tensors the wrapper runs its plain version (the same schedule in
PyTorch, ``repro_torch.core.strategies.allin_planes``); on CUDA tensors it
launches the kernel or raises. ``allin_forces.launches`` counts the
launches. The planes may carry a leading axis of stacked systems; one
launch then covers them all, each block reading its own system's halo.
Kernel E stages its sub-box's halo block in shared memory with
each cell compacted to its real particles (``halo_bytes``, no more) and
visits only the real sources of each real target's 27 cells, in kernel B's
order; the staging and the two blocks, or one, that the halo leaves an SM
set its pace (see the note in the CUDA source), and the block's threads
follow them (``allin_threads``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.interactions import PairKernel
from ..core.strategies import allin_planes
from ._common import (MAX_SMEM, check_tensors, cuda_form, launch, new_outputs,
                      systems, visit_counter)

MAX_THREADS = 1024     # csrc/allin.cu::kAllinMaxThreads, the launch bound
SM_SMEM = 233472       # bytes of shared memory an H100 SM holds (228 KB)
SMEM_RESERVED = 1024   # of which the runtime keeps 1 KB a block


def halo_bytes(box: Tuple[int, int, int], m_c: int) -> int:
    """Shared memory kernel E stages per block: x, y, z and id (4 B each)
    of the (bz+2, by+2, (bx+2)*m_c) halo block."""
    bx, by, bz = box
    return 16 * (bz + 2) * (by + 2) * (bx + 2) * m_c


def allin_threads(box: Tuple[int, int, int], m_c: int) -> int:
    """Kernel E's threads a block: 512 where two blocks' halos fit an SM's
    shared memory (two blocks of 1024 would need more than the SM's 64K
    registers), else ``MAX_THREADS`` (the SM holds one block)."""
    two = 2 * (halo_bytes(box, m_c) + SMEM_RESERVED) <= SM_SMEM
    return 512 if two else MAX_THREADS


def allin_forces(planes: Dict[str, torch.Tensor], slot_id: torch.Tensor, *,
                 box: Tuple[int, int, int], m_c: int, kernel: PairKernel,
                 cutoff2: float, visits: Optional[torch.Tensor] = None,
                 threads: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Kernel E: the All-in-SM schedule over padded planes.

    Args:
      planes: "x", "y", "z" float32 planes of shape (nz+2, ny+2, (nx+2)*m_c),
        or (B, nz+2, ...) for B stacked systems (every output then (B, ...)).
      slot_id: matching int32 plane, -1 for empty slots.
      box: interior sub-box (bx, by, bz); must divide (nx, ny, nz)
        (``core.strategies.shrink_to_divisors``).
      visits: optional int64 tensor of one element on the card, to which
        the kernel adds the number of pair steps it took (CUDA only).
      threads: the kernel's threads a block, a multiple of 32 up to
        ``MAX_THREADS``, or None for ``allin_threads(box, m_c)``; the result
        does not depend on it (CUDA only).
    Returns:
      (fx, fy, fz, pot), each (nz, ny, nx*m_c) over the interior slots.
    """
    x, y, z = planes["x"], planes["y"], planes["z"]
    nzp, nyp, width = x.shape[-3:]
    if m_c < 1 or width % m_c or min(width // m_c, nyp, nzp) < 3:
        raise ValueError(f"planes of shape {tuple(x.shape)} do not match "
                         f"m_c={m_c}")
    nx, ny, nz = width // m_c - 2, nyp - 2, nzp - 2
    bx, by, bz = box = tuple(int(b) for b in box)
    if min(box) < 1 or nx % bx or ny % by or nz % bz:
        raise ValueError(f"sub-box {box} must divide the grid "
                         f"({nx}, {ny}, {nz})")
    if threads is None:
        threads = allin_threads(box, m_c)
    if not (32 <= threads <= MAX_THREADS and threads % 32 == 0):
        raise ValueError(f"threads={threads} is not a block of kernel E: a "
                         f"multiple of 32 up to {MAX_THREADS}")
    if x.device.type == "cpu":
        return allin_planes(x, y, z, slot_id, box=box, m_c=m_c,
                            kernel=kernel, cutoff2=cutoff2)
    if x.device.type != "cuda":
        raise ValueError(f"allin_forces runs on cpu or cuda, not {x.device}")
    form = cuda_form(kernel)
    lead, n_sys = systems(x, 3, "allin_forces")
    smem = halo_bytes(box, m_c)
    if smem > MAX_SMEM:
        raise ValueError(
            f"sub-box {box} at m_c={m_c} does not fit kernel E: a block "
            f"stages its (bz+2, by+2, (bx+2)*m_c) halo block of x, y, z, id, "
            f"{smem} bytes of shared memory, at most {MAX_SMEM}")
    check_tensors(x.device, [(n, t, d, x.shape) for n, t, d in (
        ("x", x, torch.float32), ("y", y, torch.float32),
        ("z", z, torch.float32), ("slot_id", slot_id, torch.int32))],
        "allin_forces")
    outs = new_outputs((*lead, nz, ny, nx * m_c), x.device)
    launch("allin.cu", "allin_forces_f32", x, x.data_ptr(), y.data_ptr(),
           z.data_ptr(), slot_id.data_ptr(), *(o.data_ptr() for o in outs),
           visit_counter(visits, x.device), n_sys, nx, ny, nz, m_c, bx, by,
           bz,
           threads, float(cutoff2), *form)
    allin_forces.launches += 1
    return outs


allin_forces.launches = 0
