"""What every kernel wrapper shares: argument checks, the pair kernel's
CUDA form, output allocation and the launch through ``_build``.

Every particle kernel takes stacked systems: its tensors may carry one
leading system axis (``InteractionPlan.execute_batch``), and one launch
covers all of them."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.interactions import PairKernel
from ..core.strategies import SMEM_BUDGET_BYTES
from . import _build

MAX_SMEM = SMEM_BUDGET_BYTES   # bytes of shared memory a block may opt in to
MAX_SYSTEMS = 65535            # csrc/pair.cuh: kMaxSystems, a grid y/z extent


def check_tensors(device: torch.device, tensors, what: str) -> None:
    """Raise unless every (name, tensor, dtype, shape) is a contiguous
    tensor of that dtype and shape on ``device``."""
    for name, t, dtype, shape in tensors:
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be a contiguous {dtype} tensor of "
                f"shape {tuple(shape)} on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def systems(t: torch.Tensor, rank: int, what: str
            ) -> Tuple[Tuple[int, ...], int]:
    """(leading shape, number of systems) of ``t``, whose shape for one
    system has ``rank`` axes: () and 1, or (B,) and B for B stacked
    systems; raise on more leading axes or more than MAX_SYSTEMS."""
    lead = tuple(t.shape[:-rank])
    n_sys = lead[0] if lead else 1
    if t.dim() not in (rank, rank + 1) or not 1 <= n_sys <= MAX_SYSTEMS:
        raise ValueError(f"{what}: a tensor of shape {tuple(t.shape)} is not "
                         f"one system of rank {rank} or 1 to {MAX_SYSTEMS} "
                         "stacked on a leading axis")
    return lead, n_sys


def cuda_form(kernel: PairKernel):
    """(kind, p0, p1, p2, p3, n_extra) of the kernel's CUDA form."""
    form = kernel.cuda
    if form is None:
        raise ValueError(f"pair kernel {kernel.name!r} has no CUDA form; use "
                         "backend='reference'")
    return (form.kind, *(tuple(form.params) + (0.0,) * 4)[:4], form.n_extra)


def new_outputs(shape, device) -> Tuple[torch.Tensor, ...]:
    """fx, fy, fz, pot: four uninitialised float32 tensors."""
    return tuple(torch.empty(shape, dtype=torch.float32, device=device)
                 for _ in range(4))


def visit_counter(visits: Optional[torch.Tensor], device) -> Optional[int]:
    """The pointer a kernel adds its pair-step count to: None (NULL) or a
    one-element int64 tensor on ``device``."""
    if visits is None:
        return None
    check_tensors(device, [("visits", visits, torch.int64, (1,))],
                  "visit counter")
    return visits.data_ptr()


def launch(source: str, entry: str, x: torch.Tensor, *args) -> None:
    """Call C entry point ``entry`` of ``csrc/<source>`` on the current
    stream of ``x``'s device; raise if it returns a CUDA error. The stream
    is read as its raw handle, and the current device switched only when
    ``x`` lies on another: each Python object the host builds here costs
    it microseconds a launch."""
    fn = getattr(_build.load(source), entry)
    index = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    _build.check(rc, entry)
