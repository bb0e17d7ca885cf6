"""SFC cluster-pair forces: the wrapper of the CUDA kernel in
``csrc/sfc.cu``.

  cell_sfc_forces  kernel F, the compressed cluster-pair list over the
                   dense planes, one block per cluster
                   (replaces ``repro/kernels/sfc.py::cell_sfc_forces``)

On CPU tensors the wrapper runs its plain version (the same schedule in
PyTorch, ``repro_torch.core.strategies.cell_sfc_tiles``); on CUDA tensors
it launches the kernel or raises. ``cell_sfc_forces.launches`` counts the
launches. Kernel F evaluates 27 one-cell slabs of m_c slots per target of
a kept cluster, so like kernel B it is bound by operations (see the note in
the CUDA source).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.interactions import PairKernel
from ..core.strategies import cell_sfc_tiles
from ._common import check_tensors, cuda_form, launch, new_outputs

MAX_TILE = 1024        # kernel F: one thread per slot of a cluster's tile


def cell_sfc_forces(planes: Dict[str, torch.Tensor], slot_id: torch.Tensor,
                    codes: torch.Tensor, tgt_base: torch.Tensor,
                    src_base: torch.Tensor, *, m_c: int, kernel: PairKernel,
                    cutoff2: float) -> Tuple[torch.Tensor, ...]:
    """Kernel F: the SFC cluster schedule over the compressed pair list.

    Args:
      planes: "x", "y", "z" float32 padded planes (nz+2, ny+2, (nx+2)*m_c).
      slot_id: matching int32 plane, -1 for empty slots.
      codes: (pair_cap,) int32 sorted pair codes ``cluster * 32 + k``,
        padded with ``n_clusters * 32`` (``binning.build_sfc_clusters``).
      tgt_base, src_base: int32 (n_clusters, csize) and (n_clusters, 27,
        csize) flat slot bases of the clusters' cells, unshifted and shifted
        by stencil slot k; a base equal to the planes' size is the empty
        sentinel cell (``binning.sfc_device_slot_tables``).
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
    n_clusters, csize = tgt_base.shape
    if not 1 <= csize * m_c <= MAX_TILE:
        raise ValueError(
            f"csize={csize} x m_c={m_c} does not fit kernel F (one thread "
            f"per slot of a cluster's tile, csize * m_c <= {MAX_TILE})")
    total = x.numel()
    if total >= 2 ** 31 or n_clusters * 32 >= 2 ** 31:
        raise ValueError(f"{total} slots or {n_clusters} clusters exceed "
                         "kernel F's int32 slot bases and pair codes")
    if m_c < 1 or x.dim() != 3 or x.shape[2] % m_c:
        raise ValueError(f"planes of shape {tuple(x.shape)} do not match "
                         f"m_c={m_c}")
    check_tensors(x.device, [
        ("x", x, torch.float32, x.shape), ("y", y, torch.float32, x.shape),
        ("z", z, torch.float32, x.shape),
        ("slot_id", slot_id, torch.int32, x.shape),
        ("codes", codes, torch.int32, (codes.numel(),)),
        ("tgt_base", tgt_base, torch.int32, (n_clusters, csize)),
        ("src_base", src_base, torch.int32, (n_clusters, 27, csize))],
        "cell_sfc_forces")
    outs = new_outputs((n_clusters, csize * m_c), x.device)
    launch("sfc.cu", "cell_sfc_forces_f32", x, x.data_ptr(), y.data_ptr(),
           z.data_ptr(), slot_id.data_ptr(), codes.data_ptr(),
           tgt_base.data_ptr(), src_base.data_ptr(),
           *(o.data_ptr() for o in outs), codes.numel(), n_clusters, csize,
           m_c, total, float(cutoff2), *form)
    cell_sfc_forces.launches += 1
    return outs


cell_sfc_forces.launches = 0
