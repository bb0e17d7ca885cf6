"""SFC cluster-pair forces: the wrapper of the CUDA kernel in
``csrc/sfc.cu``.

  cell_sfc_forces  kernel F, the compressed cluster-pair list over the
                   dense planes, one warp per cluster
                   (replaces ``repro/kernels/sfc.py::cell_sfc_forces``)

On CPU tensors the wrapper runs its plain version (the same schedule in
PyTorch, ``repro_torch.core.strategies.cell_sfc_tiles``); on CUDA tensors
it launches the kernel or raises. ``cell_sfc_forces.launches`` counts the
launches. The planes and codes may carry a leading axis of stacked
systems (the slot-base tables are one system's, shared); one launch then
covers them all. Kernel F compacts a cluster's real targets, stages the source
slabs of its kept codes compacted to their real particles, and lets each
target visit only its own slab's real sources; the staging of 27 slabs a
cell sets its pace (see the note in the CUDA source). A warp's shared
memory (``sfc_warp_smem_bytes``) limits the tile, not a thread count.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.interactions import PairKernel
from ..core.strategies import cell_sfc_tiles
from ._common import (MAX_SMEM, check_tensors, cuda_form, launch, new_outputs,
                      systems, visit_counter)

# kernel F (csrc/sfc.cu: kSfcStageBytes)
SFC_STAGE_BYTES = 6144   # staged slabs a warp aims at


def sfc_group(tile: int) -> int:
    """Codes kernel F stages at a time for a tile of ``csize*m_c`` slots
    (``csrc/sfc.cu::sfc_group``): 4, 2 or 1, the most whose slabs (16 B a
    slot) fit ``SFC_STAGE_BYTES``."""
    return next(g for g in (4, 2, 1)
                if 16 * g * tile <= SFC_STAGE_BYTES or g == 1)


def sfc_warp_smem_bytes(csize: int, m_c: int) -> int:
    """Shared memory of one kernel F warp (``csrc/sfc.cu::sfc_warp_smem``):
    the staged slabs of ``sfc_group`` codes (16 B a slot), the target list
    (4 B a tile slot), the source bases of 32 codes and their stencil
    slots, rounded up to 16 B."""
    tile = csize * m_c
    n = 16 * sfc_group(tile) * tile + 4 * tile + 128 * csize + 128
    return -(-n // 16) * 16


def cell_sfc_forces(planes: Dict[str, torch.Tensor], slot_id: torch.Tensor,
                    codes: torch.Tensor, tgt_base: torch.Tensor,
                    src_base: torch.Tensor, *, m_c: int, kernel: PairKernel,
                    cutoff2: float, visits: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """Kernel F: the SFC cluster schedule over the compressed pair list.

    Args:
      planes: "x", "y", "z" float32 padded planes (nz+2, ny+2, (nx+2)*m_c).
      slot_id: matching int32 plane, -1 for empty slots.
      codes: (pair_cap,) int32 sorted pair codes ``cluster * 32 + k``,
        padded with ``n_clusters * 32`` (``binning.build_sfc_clusters``);
        stacked planes (B, ...) take (B, pair_cap), one list a system.
      tgt_base, src_base: int32 (n_clusters, csize) and (n_clusters, 27,
        csize) flat slot bases of the clusters' cells, unshifted and shifted
        by stencil slot k; a base equal to the planes' size is the empty
        sentinel cell (``binning.sfc_device_slot_tables``).
      visits: optional int64 tensor of one element on the card, to which
        the kernel adds the number of pair steps it took (CUDA only).
    Returns:
      (fx, fy, fz, pot), each (n_clusters, csize*m_c) cluster tiles.
    """
    x, y, z = planes["x"], planes["y"], planes["z"]
    if x.device.type == "cpu":
        return cell_sfc_tiles(x, y, z, slot_id, codes, tgt_base, src_base,
                              m_c=m_c, kernel=kernel, cutoff2=cutoff2)
    if x.device.type != "cuda":
        raise ValueError(f"cell_sfc_forces runs on cpu or cuda, not "
                         f"{x.device}")
    form = cuda_form(kernel)
    lead, n_sys = systems(x, 3, "cell_sfc_forces")
    n_clusters, csize = tgt_base.shape
    if m_c < 1 or csize < 1 or sfc_warp_smem_bytes(csize, m_c) > MAX_SMEM:
        raise ValueError(
            f"csize={csize} x m_c={m_c} does not fit kernel F: a warp "
            f"stages {sfc_warp_smem_bytes(csize, m_c)} bytes of shared "
            f"memory, at most {MAX_SMEM}")
    total = x.numel() // n_sys                       # slots a system
    if total >= 2 ** 31 or n_clusters * 32 >= 2 ** 31:
        raise ValueError(f"{total} slots or {n_clusters} clusters exceed "
                         "kernel F's int32 slot bases and pair codes")
    if m_c < 1 or x.shape[-1] % m_c:
        raise ValueError(f"planes of shape {tuple(x.shape)} do not match "
                         f"m_c={m_c}")
    check_tensors(x.device, [
        ("x", x, torch.float32, x.shape), ("y", y, torch.float32, x.shape),
        ("z", z, torch.float32, x.shape),
        ("slot_id", slot_id, torch.int32, x.shape),
        ("codes", codes, torch.int32, (*lead, codes.shape[-1])),
        ("tgt_base", tgt_base, torch.int32, (n_clusters, csize)),
        ("src_base", src_base, torch.int32, (n_clusters, 27, csize))],
        "cell_sfc_forces")
    outs = new_outputs((*lead, n_clusters, csize * m_c), x.device)
    launch("sfc.cu", "cell_sfc_forces_f32", x, x.data_ptr(), y.data_ptr(),
           z.data_ptr(), slot_id.data_ptr(), codes.data_ptr(),
           tgt_base.data_ptr(), src_base.data_ptr(),
           *(o.data_ptr() for o in outs), visit_counter(visits, x.device),
           n_sys, codes.shape[-1], n_clusters, csize, m_c, total,
           float(cutoff2),
           *form)
    cell_sfc_forces.launches += 1
    return outs


cell_sfc_forces.launches = 0
