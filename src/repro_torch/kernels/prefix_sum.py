"""The paper's §6 prefix sum: wrapper of the CUDA kernel ``csrc/prefix_sum.cu``.

Replaces ``repro/kernels/prefix_sum.py::prefix_sum`` (a Pallas kernel over
one VMEM-resident array). On a CPU tensor the wrapper runs the plain version
(``repro_torch.core.prefix.paper_prefix_sum``); on a CUDA tensor it launches
the kernel or raises. ``prefix_sum.launches`` counts the launches.

The kernel scans 1024-element tiles with the paper's schedule and chains
them in one pass: each tile looks back over the published totals of the
tiles before it for its carry (decoupled look-back).
``core.prefix.tiled_prefix_sum`` computes the same carries as a scan of
the tile totals in plain PyTorch. The result is bit-identical to
``torch.cumsum``.

The kernel's status words live in a buffer cached per (device, stream),
grown when a longer array needs more and never allocated per call; each
stream has its own, so two streams never share one.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.prefix import paper_prefix_sum
from . import _build

TILE = 1024            # elements per block: 2 x 512 threads (csrc kTile)

# (device index, stream handle) -> (int64 status buffer, its address, its
# capacity in tiles); csrc: word 0 is the ticket counter, then two arrays of
# ``capacity`` words
_STATUS: Dict[Tuple[int, int], Tuple[torch.Tensor, int, int]] = {}



def status_words(n: int) -> int:
    """int64 words of the status buffer a scan of ``n`` elements needs: the
    ticket counter and two arrays of one word per tile."""
    return 1 + 2 * max(1, -(-n // TILE))


def _status(device: int, stream: int, n: int):
    """(buffer, address, capacity) of this stream's status buffer, grown
    (zeroed) if it is short for ``n`` elements."""
    entry = _STATUS.get((device, stream))
    if entry is None or entry[2] * TILE < n:
        buf = torch.zeros(status_words(n), dtype=torch.int64,
                          device=torch.device("cuda", device))
        entry = (buf, buf.data_ptr(), (buf.numel() - 1) // 2)
        _STATUS[(device, stream)] = entry
    return entry


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a rank-1 int32 tensor (paper §6 schedule)."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return paper_prefix_sum(x)
        raise ValueError(f"prefix_sum runs on cpu or cuda, not {x.device}")
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"prefix_sum takes a contiguous rank-1 int32 tensor, "
                         f"got {x.dtype} of shape {tuple(x.shape)}")
    n = x.shape[0]
    device = x.get_device()
    # the current stream's handle as an int, without building a Stream
    # object (the call Triton's and Inductor's launchers make)
    stream = torch._C._cuda_getCurrentRawStream(device)
    _, status, capacity = _status(device, stream, n)
    out = torch.empty_like(x)
    scan = _build.load("prefix_sum.cu").paper_scan_i32
    if device == torch.cuda.current_device():
        rc = scan(x.data_ptr(), out.data_ptr(), status, n, capacity, stream)
    else:
        with torch.cuda.device(device):
            rc = scan(x.data_ptr(), out.data_ptr(), status, n, capacity,
                      stream)
    if rc:
        _build.check(rc, "paper_scan_i32")
    prefix_sum.launches += 1
    return out


prefix_sum.launches = 0
