"""Plain PyTorch versions of the CUDA kernels (the allclose targets).

The force kernels are held against the strategies of ``core`` (the same
schedules); the scan against ``torch.cumsum``, independent of the
paper's own schedule; the window attention against a dense masked
softmax over the whole sequence.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import strategies as S
from ..core.binning import CellBins, Occupancy, PackedRows, SfcClusters
from ..core.domain import Domain
from ..core.interactions import PairKernel


def xpencil_ref(domain: Domain, bins: CellBins, kernel: PairKernel
                ) -> Tuple[torch.Tensor, ...]:
    """(nz, ny, nx*m_c) interior force/potential planes."""
    nx, ny, nz = domain.ncells
    out = S.xpencil(domain, bins, kernel)
    return tuple(o.reshape(nz, ny, nx * bins.m_c) for o in out)


def xpencil_sparse_ref(domain: Domain, bins: CellBins, kernel: PairKernel,
                       occ: Occupancy) -> Tuple[torch.Tensor, ...]:
    """(nz, ny, nx*m_c) planes of the compacted schedule (inactive and
    dropped pencils 0)."""
    nx, ny, nz = domain.ncells
    out = S.xpencil_sparse(domain, bins, kernel, occ)
    return tuple(o.reshape(nz, ny, nx * bins.m_c) for o in out)


def xpencil_packed_ref(domain: Domain, packed: PackedRows,
                       kernel: PairKernel, occ: Occupancy
                       ) -> Tuple[torch.Tensor, ...]:
    """(nz * ny, row_cap) packed planes of the packed-row schedule."""
    return S.xpencil_packed(domain, packed, kernel, occ)


def allin_ref(domain: Domain, bins: CellBins, kernel: PairKernel,
              box: Tuple[int, int, int]) -> Tuple[torch.Tensor, ...]:
    """(nz, ny, nx*m_c) interior force/potential planes of All-in-SM."""
    nx, ny, nz = domain.ncells
    out = S.allin(domain, bins, kernel, box=box)
    return tuple(o.reshape(nz, ny, nx * bins.m_c) for o in out)


def cell_sfc_ref(domain: Domain, sfc: SfcClusters, kernel: PairKernel
                 ) -> Tuple[torch.Tensor, ...]:
    """(n_clusters, csize*m_c) cluster tiles of the SFC schedule."""
    return S.cell_sfc(domain, sfc, kernel)


def prefix_sum_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1, dtype=x.dtype)


def window_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: int, softcap: float = 0.0
                         ) -> torch.Tensor:
    """Dense masked local attention, fp32 throughout (the counterpart of
    ``repro/kernels/ref.py::window_attention_ref``)."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    kf = torch.repeat_interleave(k.float(), group, dim=1)
    vf = torch.repeat_interleave(v.float(), group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / (d ** 0.5)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = (kpos <= qpos) & (qpos - kpos < window)
    scores = torch.where(mask, scores, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
