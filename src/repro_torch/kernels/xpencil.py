"""Dense X-pencil forces: wrapper of the CUDA kernel ``csrc/xpencil.cu``.

Replaces ``repro/kernels/xpencil.py::xpencil_forces``. On CPU tensors the
wrapper runs the plain version (``repro_torch.core.strategies.xpencil_planes``,
the same schedule in PyTorch); on CUDA tensors it launches the kernel or
raises. ``xpencil_forces.launches`` counts the launches.

The kernel evaluates every dense slot pair of each target's 3*m_c window,
so it is bound by operations, not bytes; see the note in the CUDA source.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.interactions import PairKernel
from ..core.strategies import xpencil_planes
from . import _build

MAX_M_C = 1024         # one thread per target slot of a block


def xpencil_forces(planes: Dict[str, torch.Tensor], slot_id: torch.Tensor, *,
                   nx: int, m_c: int, kernel: PairKernel, cutoff2: float
                   ) -> Tuple[torch.Tensor, ...]:
    """Run the X-pencil schedule over padded planes.

    Args:
      planes: "x", "y", "z" float32 planes of shape (nz+2, ny+2, (nx+2)*m_c).
      slot_id: matching int32 plane, -1 for empty slots.
    Returns:
      (fx, fy, fz, pot), each (nz, ny, nx*m_c) over the interior slots.
    """
    x, y, z = planes["x"], planes["y"], planes["z"]
    if x.device.type == "cpu":
        return xpencil_planes(x, y, z, slot_id, nx=nx, m_c=m_c,
                              kernel=kernel, cutoff2=cutoff2)
    if x.device.type != "cuda":
        raise ValueError(f"xpencil_forces runs on cpu or cuda, not {x.device}")
    if kernel.cuda is None:
        raise ValueError(f"pair kernel {kernel.name!r} has no CUDA form; use "
                         "backend='reference'")
    if not 1 <= m_c <= MAX_M_C:
        raise ValueError(f"m_c={m_c} does not fit the CUDA X-pencil kernel "
                         f"(one thread per target slot, 1 <= m_c <= {MAX_M_C})")
    nzp, nyp, width = x.shape
    if width != (nx + 2) * m_c or nzp < 3 or nyp < 3:
        raise ValueError(f"planes of shape {tuple(x.shape)} do not match "
                         f"nx={nx}, m_c={m_c}")
    for name, t, dtype in (("x", x, torch.float32), ("y", y, torch.float32),
                           ("z", z, torch.float32),
                           ("slot_id", slot_id, torch.int32)):
        if (t.device != x.device or t.dtype != dtype
                or tuple(t.shape) != tuple(x.shape) or not t.is_contiguous()):
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape "
                f"{tuple(x.shape)} on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    nz, ny = nzp - 2, nyp - 2
    outs = [torch.empty((nz, ny, nx * m_c), dtype=torch.float32,
                        device=x.device) for _ in range(4)]
    form = kernel.cuda
    p = (tuple(form.params) + (0.0,) * 4)[:4]
    lib = _build.load("xpencil.cu")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xpencil_forces_f32(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), slot_id.data_ptr(),
            *(o.data_ptr() for o in outs), nx, ny, nz, m_c, float(cutoff2),
            form.kind, *p, form.n_extra, stream)
    _build.check(rc, "xpencil_forces_f32")
    xpencil_forces.launches += 1
    return tuple(outs)


xpencil_forces.launches = 0
