"""Carry state between the JAX package and the port.

On the particle side the state is a domain, a pair kernel, particles and
bins; on the LM side it is the params tree (nested dicts of arrays), the
AdamW state and the data cursor. The JAX objects are read by attribute
(duck typing) or handed over as numpy arrays, so this module imports
neither JAX nor ``repro``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .core.api import ParticleState
from .core.binning import CellBins, Occupancy, PackedRows, SfcClusters
from .core.domain import Domain
from .core.interactions import (PairKernel, make_gravity, make_high_flop,
                                make_lennard_jones, make_low_flop,
                                make_sph_density)
from .data.pipeline import DataState
from .models.model import check_ported

_FACTORIES = {
    "lennard_jones": make_lennard_jones,
    "low_flop": make_low_flop,
    "high_flop": make_high_flop,
    "gravity": make_gravity,
    "sph_density": make_sph_density,
}


def domain_from_jax(d) -> Domain:
    """The port's Domain with the same box, grid, cutoff and periodicity."""
    return Domain(box=tuple(float(v) for v in d.box),
                  ncells=tuple(int(v) for v in d.ncells),
                  cutoff=float(d.cutoff), periodic=d.periodic)


def kernel_from_jax(k) -> PairKernel:
    """The port's pair kernel of the same factory and parameters."""
    factory = _FACTORIES.get(k.name)
    if factory is None:
        raise ValueError(f"no port of pair kernel {k.name!r}; known: "
                         f"{sorted(_FACTORIES)}")
    out = factory(*k.static_params)
    if (out.name, out.flops, out.static_params) != \
            (k.name, k.flops, tuple(k.static_params)):
        raise ValueError(f"pair kernel {k.name!r} with static_params "
                         f"{k.static_params} does not round-trip")
    return out


def state_from_numpy(positions, fields: Optional[Dict[str, object]] = None,
                     valid=None, *, device) -> ParticleState:
    """A ParticleState on ``device`` from numpy arrays (float32 positions)."""
    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)
    return ParticleState(
        positions=t(positions, np.float32),
        fields={k: t(v) for k, v in (fields or {}).items()},
        valid=None if valid is None else t(valid, np.bool_))


def bins_to_numpy(bins: CellBins) -> Dict[str, np.ndarray]:
    """Every binned array as numpy, planes under their own names."""
    out = {k: v.cpu().numpy() for k, v in bins.planes.items()}
    out.update(slot_id=bins.slot_id.cpu().numpy(),
               counts=bins.counts.cpu().numpy(),
               offsets=bins.offsets.cpu().numpy(),
               particle_slot=bins.particle_slot.cpu().numpy())
    return out


def packed_to_numpy(packed: PackedRows) -> Dict[str, np.ndarray]:
    """Every packed-row array as numpy, planes under their own names."""
    out = {k: v.cpu().numpy() for k, v in packed.planes.items()}
    for name in ("slot_id", "slot_cell", "cell_offsets", "row_counts",
                 "counts", "particle_slot"):
        out[name] = getattr(packed, name).cpu().numpy()
    return out


def occupancy_to_numpy(occ: Occupancy) -> Dict[str, np.ndarray]:
    """The occupancy summary's arrays (and its write-side indices) as
    numpy."""
    return {"unit_counts": occ.unit_counts.cpu().numpy(),
            "active": occ.active.cpu().numpy(),
            "n_active": occ.n_active.cpu().numpy(),
            "scatter_indices": occ.scatter_indices().cpu().numpy()}


def sfc_to_numpy(sfc: SfcClusters) -> Dict[str, np.ndarray]:
    """The pair list's arrays as numpy (the bins: :func:`bins_to_numpy`)."""
    return {"codes": sfc.codes.cpu().numpy(),
            "n_pairs": sfc.n_pairs.cpu().numpy(),
            "cluster_counts": sfc.cluster_counts.cpu().numpy()}


def _tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 from ml_dtypes included) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_jax(cfg, tree, device) -> dict:
    """The port's params from JAX's ``init_params`` output after
    ``np.asarray`` (a nested dict of numpy arrays), leaf by leaf on
    ``device``; the dict layout is the same on both sides."""
    check_ported(cfg)
    want = {"embed", "final_norm", "layers"} | (
        set() if cfg.tie_embeddings else {"lm_head"}) | (
        {"shared_attn"} if cfg.family == "hybrid" and cfg.hybrid_attn_every
        else set())
    if set(tree) != want:
        raise ValueError(f"params of {cfg.name} have keys {sorted(want)}, "
                         f"got {sorted(tree)}")

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _tensor_from_numpy(node, device)
    return walk(tree)


def opt_state_from_jax(cfg, state, device) -> dict:
    """The port's AdamW state from JAX's ``init_opt_state`` / ``adam_update``
    output after ``np.asarray`` (``{"m": tree, "v": tree, "step": int32
    scalar}``): the moments leaf by leaf as :func:`params_from_jax` carries
    params, ``step`` a 0-d int32 tensor on ``device``."""
    if set(state) != {"m", "v", "step"}:
        raise ValueError(f"an AdamW state has keys ['m', 'step', 'v'], got "
                         f"{sorted(state)}")
    return {"m": params_from_jax(cfg, state["m"], device),
            "v": params_from_jax(cfg, state["v"], device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def data_state_from_dict(d) -> DataState:
    """The port's data cursor from JAX's ``DataState.to_dict()`` (the
    checkpoint's ``extra``); the cursor is a step count on both sides."""
    return DataState.from_dict(d)
