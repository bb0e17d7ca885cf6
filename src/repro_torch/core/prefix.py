"""The paper's prefix sum (Section 6 / Algorithm 6) in PyTorch.

The plain version of the CUDA scan kernel (``repro_torch.kernels.prefix_sum``)
and a port of ``repro.core.prefix``. The paper's variant of Blelloch's scan
places the final value of every "right spine" element during the upward pass
and therefore needs ``2h - 3`` barriers instead of ``2h``
(h = ceil(log2(N + 1))), ``N - 1`` updates upward and ``N - h`` downward.
Each ``while`` iteration below is one barrier-delimited level; the indexed
add inside is what all threads of the block do between two barriers.

``tiled_prefix_sum`` composes tiles as the CUDA kernel does for arrays
longer than one block's tile: each tile is scanned on its own and adds the
sum of the tiles before it. The kernel finds that carry in one pass by
looking back over its predecessors' published totals (decoupled look-back);
here it is a scan of the tile totals. Integer addition is associative, so
every composition gives the same bits as ``torch.cumsum``.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch


def _levels(n: int):
    """(target start, source distance, stride) per barrier-delimited level,
    in the paper's order (``repro/kernels/prefix_sum.py::_levels``)."""
    out = []
    js = 2
    while js <= n:
        out.append((js - 1, js // 2, js))
        js *= 2
    # Downward levels start at js_exit / 2, as the paper's CUDA Code 1 does.
    js = max(4, js // 2)
    while js > 1:
        jsd2 = js // 2
        start = js + jsd2 - 1
        if start < n:
            out.append((start, jsd2, js))
        js = jsd2
    return out


def paper_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, paper's schedule."""
    n = x.shape[-1]
    if n <= 1:
        return x.clone()
    x = x.clone()
    for start, dist, stride in _levels(n):
        idx = torch.arange(start, n, stride, device=x.device)
        x[..., idx] = x[..., idx] + x[..., idx - dist]
    return x


def exclusive_prefix_sum(x: torch.Tensor,
                         scan: Callable[[torch.Tensor], torch.Tensor]
                         = paper_prefix_sum) -> torch.Tensor:
    """Exclusive scan built from an inclusive one, the paper's by default
    (binning needs the cell start offsets, paper Figure 1). The binning
    passes the CUDA scan kernel's wrapper as ``scan``."""
    inc = scan(x)
    zero = torch.zeros_like(x[..., :1])
    return torch.cat([zero, inc[..., :-1]], dim=-1)


def tiled_prefix_sum(x: torch.Tensor, tile: int) -> torch.Tensor:
    """Inclusive scan of a rank-1 tensor composed from ``tile``-element
    paper scans: scan each tile, add each tile's carry, the sum of the tiles
    before it (here a recursive scan of the tile totals; the CUDA kernel's
    look-back computes the same carry). The CUDA kernel's result at any
    length."""
    n = x.shape[0]
    if n <= tile:
        return paper_prefix_sum(x)
    n_tiles = -(-n // tile)
    pad = torch.zeros(n_tiles * tile - n, dtype=x.dtype, device=x.device)
    tiles = paper_prefix_sum(torch.cat([x, pad]).view(n_tiles, tile))
    totals = tiled_prefix_sum(tiles[:, -1].contiguous(), tile)
    carry = torch.cat([torch.zeros_like(totals[:1]), totals[:-1]])
    return (tiles + carry[:, None]).reshape(-1)[:n]


def operation_counts(n: int) -> Tuple[int, int, int]:
    """(updates_upward, updates_downward, barriers) for length ``n``."""
    ups = downs = 0
    levels_up = levels_down = 0
    for start, dist, stride in _levels(n):
        count = len(range(start, n, stride))
        if start == stride - 1:           # upward level (downward: 1.5 js - 1)
            ups += count
            levels_up += 1
        else:
            downs += count
            levels_down += 1
    return ups, downs, levels_up + levels_down


def blelloch_counts(n: int) -> Tuple[int, int, int]:
    """Classic Blelloch work/barrier counts: N-1 updates up-sweep, N-1
    down-sweep, 2h barriers (h = ceil(log2 N))."""
    h = max(1, math.ceil(math.log2(n))) if n > 1 else 1
    return n - 1, n - 1, 2 * h


def paper_height(n: int) -> int:
    """h = ceil(log2(N + 1)) — the abstract-tree height used by the paper."""
    return math.ceil(math.log2(n + 1))
