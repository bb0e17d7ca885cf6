"""The paper's §6 prefix sum: wrapper of the CUDA kernel ``csrc/prefix_sum.cu``.

Replaces ``repro/kernels/prefix_sum.py::prefix_sum`` (a Pallas kernel over
one VMEM-resident array). On a CPU tensor the wrapper runs the plain version
(``repro_torch.core.prefix.paper_prefix_sum``); on a CUDA tensor it launches
the kernel or raises. ``prefix_sum.launches`` counts the launches.

The kernel scans 1024-element tiles with the paper's schedule and composes
longer arrays in three passes (tile scans, a recursive scan of the tile
totals, a carry add); ``core.prefix.tiled_prefix_sum`` is that composition
in plain PyTorch. The result is bit-identical to ``torch.cumsum``.
"""

from __future__ import annotations

import torch

from ..core.prefix import paper_prefix_sum
from . import _build

TILE = 1024            # elements per block: 2 x 512 threads (csrc kTile)


def scratch_elems(n: int) -> int:
    """int32 scratch the kernel needs for the tile totals of every level."""
    total = 0
    while n > TILE:
        n = -(-n // TILE)
        total += n
    return total


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a rank-1 int32 tensor (paper §6 schedule)."""
    if x.device.type == "cpu":
        return paper_prefix_sum(x)
    if x.device.type != "cuda":
        raise ValueError(f"prefix_sum runs on cpu or cuda, not {x.device}")
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"prefix_sum takes a contiguous rank-1 int32 tensor, "
                         f"got {x.dtype} of shape {tuple(x.shape)}")
    n = x.shape[0]
    out = torch.empty_like(x)
    scratch = torch.empty((max(1, scratch_elems(n)),), dtype=torch.int32,
                          device=x.device)
    lib = _build.load("prefix_sum.cu")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paper_scan_i32(x.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), n, scratch_elems(n),
                                stream)
    _build.check(rc, "paper_scan_i32")
    prefix_sum.launches += 1
    return out


prefix_sum.launches = 0

