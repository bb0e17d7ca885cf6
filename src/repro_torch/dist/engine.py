"""Distributed halo execution engine: ``plan(..., backend="halo")`` (port of
``repro.dist.engine``).

Any cell-schedule :class:`~repro_torch.core.api.InteractionPlan` runs as a
domain decomposition into Z-slabs. One executor per plan does, end to end:

  1. **partition**: a Z-slab gather groups particles by shard under the
     plan's static ``shard_cap`` (``dist.halo.partition_by_shard``),
  2. **per-shard binning**: each shard bins its own rows into the slab's
     padded planes (sentinel rows masked out) and offsets its slot ids by
     ``shard * cap``, so the kernels' self-pair exclusion stays exact
     across shard boundaries,
  3. **ghost exchange**: the two boundary Z-planes of every binned plane
     (coordinates, extra fields, slot ids) go to the neighbouring shards;
     periodic Z wraps around the shard ring with the minimum-image shift,
     open Z boundaries get empty planes. ``layout="packed"`` plans pack the
     slab first and exchange the packed planes, ``layout="sfc"`` plans
     exchange the dense planes and build each slab's pair list after,
  4. **local schedule**: the plan's strategy runs on the slabs through the
     same backend registry as single-device execution (``halo_inner``),
  5. **scatter-back**: per-shard results return to particle order.

Where the shards live:

  * ``mesh=None``: every shard on the plan's device, stacked on the system
    axis that kernels A-F and the pack kernel take (``execute_batch``), so
    one chain of launches covers all shards; B systems of S shards run as
    B * S systems. The exchange is an indexed copy between neighbouring
    systems' boundary planes. This is the port's counterpart of the JAX
    package's emulated host devices: the same computation as its
    ``shard_map`` over a mesh.
  * a 1-D ``torch.distributed.device_mesh.DeviceMesh``: one slab per rank
    of the mesh's ``shard_axis``, the boundary planes sent to ranks r +/- 1
    (``dist.halo.exchange_halo_ranks``), each rank's results gathered
    (``all_gather``) so every rank returns the full ``(N, 3)`` / ``(N,)``.
    Every rank passes the same full state.

Overflow stays a global contract: ``InteractionPlan.check_overflow`` reduces
the per-shard loads and active-pencil counts (max over shards) against the
plan's static bounds, so ``execute_or_replan`` grows exactly the bound that
overflowed (``m_c``, ``shard_cap``, ``max_active``, ``row_cap`` or
``pair_cap``). A single-shard halo plan runs the inner backend directly,
bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.binning import (EMPTY_POS, _host, bin_particles,
                            build_sfc_clusters, cell_counts, pack_rows,
                            sfc_n_clusters, sfc_pair_count,
                            shard_pencil_active, shard_slab_counts)
from ..core.domain import Domain, slab_domain
from ..obs.trace import trace as _obs_trace
from . import halo as H

# ghost-plane exchanges staged per executor build (one count a value plane,
# as JAX's count moves once per trace, not per call)
GHOST_EXCHANGE_TOTAL = "repro_torch_ghost_exchange_total"

DEFAULT_SHARD_AXIS = "halo"


# --------------------------------------------------------------------------
# shard count and mesh resolution
# --------------------------------------------------------------------------

def visible_devices(device=None) -> int:
    """The device count a shard axis may use (JAX's ``jax.device_count()``):
    ``torch.cuda.device_count()`` for a plan on the card (``device`` None or
    CUDA), 1 on the CPU."""
    on_card = device is None or torch.device(device).type == "cuda"
    return torch.cuda.device_count() if on_card else 1


def default_n_shards(domain: Domain, device_count: Optional[int] = None,
                     device=None) -> int:
    """Largest divisor of ``nz`` that fits ``device_count`` devices (>= 1;
    default :func:`visible_devices` of ``device``), so one card gives 1
    shard, as one JAX device does."""
    if device_count is None:
        device_count = visible_devices(device)
    for n in range(min(device_count, domain.nz), 0, -1):
        if domain.nz % n == 0:
            return n
    return 1


def shard_count(domain: Domain, mesh=None, axis: str = DEFAULT_SHARD_AXIS,
                n_shards: Optional[int] = None, device=None) -> int:
    """``n_shards``, or its default: the size of ``mesh``'s ``axis``, else
    :func:`default_n_shards` of ``device``."""
    if n_shards is not None:
        return n_shards
    if mesh is not None:
        return mesh_axis_size(mesh, axis)
    return default_n_shards(domain, device=device)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s dimension names (``()`` when it has none)."""
    return tuple(mesh.mesh_dim_names or ())


def mesh_axis_size(mesh, axis: str) -> int:
    return int(mesh.size(mesh_axis_names(mesh).index(axis)))


def resolve_mesh(plan):
    """The ``DeviceMesh`` a halo plan runs its shards on, one slab per rank,
    or None: every shard stacked on the plan's device."""
    mesh = plan.mesh
    if mesh is None:
        return None
    names = mesh_axis_names(mesh)
    if plan.shard_axis not in names:
        raise ValueError(
            f"plan.mesh has axes {names}, no {plan.shard_axis!r} shard axis")
    if mesh.ndim != 1:
        raise ValueError(f"plan.mesh must be 1-D, got axes {names}")
    size = mesh_axis_size(mesh, plan.shard_axis)
    if size != plan.n_shards:
        raise ValueError(
            f"plan.mesh axis {plan.shard_axis!r} has size {size}, plan "
            f"expects {plan.n_shards} shards")
    return mesh


# --------------------------------------------------------------------------
# the sharded executor body
# --------------------------------------------------------------------------

class _HaloRunner:
    """``runner(states) -> (forces (B, N, 3), potential (B, N))`` of a
    multi-shard plan over stacked systems; see :func:`halo_impl`."""

    def __init__(self, plan, field_names: Tuple[str, ...]):
        from ..core.api import get_backend
        dom = plan.domain
        self.plan = plan
        self.n_shards = plan.n_shards
        self.cap = plan.shard_cap
        self.nz_loc = dom.nz // plan.n_shards
        self.lz_loc = dom.box[2] / plan.n_shards
        self.periodic_z = dom.periodic_axes[2]
        self.local_dom = slab_domain(dom, plan.n_shards)
        # the per-shard plan: same schedule and static bounds on the slab
        # domain and the inner backend, dispatched through the registry
        self.inner = dataclasses.replace(
            plan, domain=self.local_dom, backend=plan.halo_inner,
            n_shards=None, shard_cap=None, mesh=None)
        self.inner_fn = get_backend(plan.halo_inner, plan.strategy,
                                    plan.layout)
        self.mesh = resolve_mesh(plan)
        if self.mesh is not None:
            self.group = self.mesh.get_group(plan.shard_axis)
            self.rank = self.mesh.get_local_rank(plan.shard_axis)
        self.n_value_planes = 3 + len(field_names)
        self._staged = False

    def _span(self, name: str, **attrs):
        """A ``phase="trace"`` span on the executor's first call only (JAX
        records these while it traces, once per compile)."""
        if self._staged:
            return contextlib.nullcontext()
        return _obs_trace(name, phase="trace", n_shards=self.n_shards,
                          **attrs)

    def _exchange(self, plane: torch.Tensor, n_sys: int, fill,
                  coord_shift: float = 0.0) -> torch.Tensor:
        kw = dict(n_shards=self.n_shards, nz_loc=self.nz_loc,
                  periodic_z=self.periodic_z, fill=fill,
                  coord_shift=coord_shift)
        if self.mesh is None:
            H.exchange_halo(plane.unflatten(0, (n_sys, self.n_shards)), **kw)
        else:
            H.exchange_halo_ranks(plane, group=self.group,
                                  shard_index=self.rank, **kw)
        return plane

    def _exchange_planes(self, planes, n_sys: int):
        with self._span("dist.ghost_exchange", layout=self.plan.layout,
                        planes=len(planes)):
            for name, plane in planes.items():
                if name == "z":
                    self._exchange(plane, n_sys, EMPTY_POS, self.lz_loc)
                elif name in ("x", "y"):
                    self._exchange(plane, n_sys, EMPTY_POS)
                else:                      # extra per-particle field
                    self._exchange(plane, n_sys, 0.0)
        return planes

    def __call__(self, states) -> Tuple[torch.Tensor, torch.Tensor]:
        p, ns, cap = self.plan, self.n_shards, self.cap
        n_sys, n = states.positions.shape[:2]
        with self._span("dist.partition", shard_cap=cap, n=n):
            gather_idx, blocks = self._partition(states)
        with self._span("dist.shard_dispatch", strategy=p.strategy,
                        layout=p.layout):
            data, local_state, valid = self._layout(*blocks, n_sys)
            f, u = self.inner_fn(self.inner, data, local_state)
            f = torch.where(valid[..., None], f, 0.0)
            u = torch.where(valid, u, 0.0)
        if self.mesh is not None:
            f, u = (self._all_gather(t) for t in (f, u))
        f = f.reshape(n_sys, ns * cap, 3)
        u = u.reshape(n_sys, ns * cap)
        self._staged = True
        return (H.scatter_from_shards(gather_idx, n, f),
                H.scatter_from_shards(gather_idx, n, u))

    def layout(self, states):
        """-> ``(layout data, inner plan)``: what the inner backend is given
        for stacked ``states`` (``mesh=None``): B * S systems of the slab
        domain, shard ``s`` of system ``b`` at ``b * S + s``, ghost planes
        exchanged. For holding a kernel against its plain version on the
        shards it is launched on."""
        if self.mesh is not None:
            raise ValueError("layout() is for stacked shards (mesh=None)")
        _, blocks = self._partition(states)
        data, _, _ = self._layout(*blocks, states.positions.shape[0])
        return data, self.inner

    def _partition(self, states):
        """-> ``(gather_idx, (pos_blk, fields_blk, shard))``: the local
        shards ``(K, cap, ...)`` and the shard index of each."""
        p, ns, cap = self.plan, self.n_shards, self.cap
        pos = states.positions
        n_sys = pos.shape[0]
        dev = pos.device
        gather_idx, pos_part, fields_part = H.partition_by_shard(
            p.domain, pos, states.fields, ns, cap, valid=states.valid)
        if self.mesh is None:           # all shards, stacked: B * S systems
            if self.inner.backend == "cuda":
                from ..kernels._common import MAX_SYSTEMS
                if n_sys * ns > MAX_SYSTEMS:
                    raise ValueError(
                        f"{n_sys} systems x {ns} shards = {n_sys * ns} "
                        f"stacked systems exceed the kernels' "
                        f"{MAX_SYSTEMS}; use a smaller batch")
            pos_blk = pos_part.reshape(n_sys * ns, cap, 3)
            fields_blk = {k: v.reshape(n_sys * ns, cap)
                          for k, v in fields_part.items()}
            shard = torch.arange(ns, device=dev).repeat(n_sys)
        else:                           # this rank's shard of each system
            pos_blk = pos_part.view(n_sys, ns, cap, 3)[:, self.rank]
            fields_blk = {k: v.view(n_sys, ns, cap)[:, self.rank]
                          for k, v in fields_part.items()}
            shard = torch.full((n_sys,), self.rank, device=dev)
        return gather_idx, (pos_blk, fields_blk, shard)

    def _layout(self, pos_blk, fields_blk, shard, n_sys):
        """Bin and exchange the local shards ``(K, cap, ...)``, shard
        ``shard[k]`` each. -> (layout data, the inner backend's state,
        the rows' valid mask)."""
        from ..core.api import ParticleState
        p, cap = self.plan, self.cap
        valid = pos_blk[..., 0] < H.VALID_MAX
        z_shift = shard.to(pos_blk.dtype) * self.lz_loc
        local_pos = pos_blk.clone()
        local_pos[..., 2] = pos_blk[..., 2] - z_shift[:, None]
        bins = bin_particles(self.local_dom, local_pos, fields_blk,
                             m_c=p.m_c, valid=valid)
        # globally unique slot ids: the shard offset keeps the self-pair
        # exclusion exact when a pair straddles a shard boundary
        off = (shard.to(torch.int32) * cap).view(-1, 1, 1, 1)
        sid = torch.where(bins.slot_id >= 0, bins.slot_id + off,
                          bins.slot_id)
        local_state = ParticleState(
            torch.where(valid[..., None], local_pos, 0.0), fields_blk)
        if p.layout == "packed":
            # pack the slab first, then exchange the packed planes: a
            # boundary plane crosses as row_cap slots plus its row-local
            # cell offsets; slot ids already carry the sender's offset
            packed = pack_rows(self.local_dom,
                               dataclasses.replace(bins, slot_id=sid),
                               row_cap=p.row_cap)
            self._exchange_planes(packed.planes, n_sys)
            self._exchange(packed.slot_id, n_sys, -1)
            self._exchange(packed.slot_cell, n_sys, 1)
            self._exchange(packed.cell_offsets, n_sys, 0)
            self._exchange(packed.row_counts[..., None], n_sys, 0)
            data = packed
        else:
            self._exchange_planes(bins.planes, n_sys)
            bins = dataclasses.replace(bins,
                                       slot_id=self._exchange(sid, n_sys, -1))
            data = bins
            if p.layout == "sfc":
                # each slab's pair list over its own cluster order, its Z
                # ghost planes holding the neighbours' occupancy
                data = build_sfc_clusters(self.local_dom, bins,
                                          pair_cap=p.pair_cap)
        return data, local_state, valid

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(B, cap, ...) of this rank -> (B, S, cap, ...) of every rank."""
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(self.n_shards)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.stack(parts, dim=1)


def halo_impl(plan, field_names: Tuple[str, ...] = ()):
    """-> ``fn(states) -> (forces (B, N, 3), potential (B, N))`` of a halo
    plan with ``n_shards >= 2`` over B stacked systems (the single-shard
    fallback is the plan layer's: it runs the inner backend directly).

    Built once per (plan, field names) by the plan's executor, which counts
    the build (``recompile_count``) and moves ``GHOST_EXCHANGE_TOTAL`` by
    the runner's ``n_value_planes``; the runner's first call records the
    ``dist.partition``, ``dist.shard_dispatch`` and ``dist.ghost_exchange``
    spans with ``phase="trace"`` (JAX records them at trace time)."""
    if not plan._multi_shard:
        raise ValueError("halo_impl needs a halo plan with n_shards >= 2")
    return _HaloRunner(plan, tuple(field_names))


# --------------------------------------------------------------------------
# the overflow contract, reduced across shards
# --------------------------------------------------------------------------

def halo_overflow(plan, counts: torch.Tensor) -> bool:
    """True when any shard's load exceeds ``shard_cap``, any shard's pair
    list ``pair_cap`` (sfc) or any shard's active pencils ``max_active``
    (compacted). ``counts`` are the global per-cell counts of the ``m_c``
    check, so the whole safety check stays one binning pass."""
    return halo_overflow_class(plan, counts) is not None


def halo_overflow_class(plan, counts: torch.Tensor) -> Optional[str]:
    """Which shard-level bound overflowed, ``"shard_cap"`` /
    ``"pair_cap"`` / ``"max_active"``, or None."""
    loads = shard_slab_counts(plan.domain, counts, plan.n_shards)
    if int(loads.max()) > plan.shard_cap:
        return "shard_cap"
    if plan.layout == "sfc":
        if max(shard_sfc_pairs(plan.domain, counts,
                               plan.n_shards)) > plan.pair_cap:
            return "pair_cap"
    if plan.compact:
        act = shard_pencil_active(plan.domain, counts, plan.n_shards)
        if int(act.max()) > plan.max_active:
            return "max_active"
    return None


def shard_sfc_pairs(domain: Domain, counts, n_shards: int) -> list:
    """Per-shard compressed pair-list lengths of an SFC halo plan: each
    shard's list over its slab's cluster order, with the Z ghost planes
    holding the neighbouring shard's boundary occupancy (periodic wrap
    across the ring, empty at open Z boundaries), the occupancy the
    exchanged planes carry at run time. Host side; waits for the device."""
    nx, ny, nz = domain.ncells
    nz_loc = nz // n_shards
    grid = _host(counts).reshape(nz, ny, nx)
    local_dom = slab_domain(domain, n_shards)
    pz = domain.periodic_axes[2]
    empty = np.zeros((ny, nx), grid.dtype)
    out = []
    for s in range(n_shards):
        lo, hi = s * nz_loc - 1, (s + 1) * nz_loc
        below = grid[lo % nz] if (pz or lo >= 0) else empty
        above = grid[hi % nz] if (pz or hi < nz) else empty
        out.append(sfc_pair_count(
            local_dom, counts=grid[s * nz_loc:(s + 1) * nz_loc],
            ghost_z=(below, above)))
    return out


def shard_pair_cap(n_pairs: int, align: int = 8) -> int:
    """The per-shard ``pair_cap`` for a busiest shard's pair list of
    ``n_pairs``: slack 1.25, rounded up to ``align``."""
    return -(-max(1, int(n_pairs * 1.25 + 0.999)) // align) * align


def halo_bounds(domain: Domain, positions: torch.Tensor, n_shards: int, *,
                layout: str = "dense", compact: bool = False,
                shard_cap: Optional[int] = None,
                max_active: Optional[int] = None,
                pair_cap: Optional[int] = None, align: int = 8
                ) -> Tuple[int, Optional[int], Optional[int]]:
    """-> ``(shard_cap, max_active, pair_cap)`` of a halo plan at
    ``n_shards >= 2`` shards: each bound given is kept, each missing one is
    measured per shard from ``positions``: ``shard_cap`` the busiest slab's
    load (``suggest_shard_cap``), ``max_active`` (``compact`` only) its
    active pencils (``suggest_shard_max_active``), ``pair_cap``
    (``layout="sfc"`` only) its pair list (:func:`shard_sfc_pairs`,
    :func:`shard_pair_cap`)."""
    if shard_cap is None:
        shard_cap = H.suggest_shard_cap(domain, positions, n_shards,
                                        align=align)
    counts = (cell_counts(domain, positions)
              if (compact and max_active is None)
              or (layout == "sfc" and pair_cap is None) else None)
    if compact and max_active is None:
        max_active = H.suggest_shard_max_active(domain, positions, n_shards,
                                                align=align, counts=counts)
    if layout == "sfc" and pair_cap is None:
        pair_cap = shard_pair_cap(
            max(shard_sfc_pairs(domain, counts, n_shards)), align)
    return shard_cap, max_active, pair_cap


# --------------------------------------------------------------------------
# elastic shrink: survive a lost shard
# --------------------------------------------------------------------------

# re-exported: a caller catching a lost shard need not know the injection
# registry
from ..testing.chaos import ShardLost  # noqa: E402,F401


def surviving_shard_count(domain: Domain, n_shards: int,
                          lost: int = 1) -> int:
    """The shard count to rebuild at after ``lost`` shards die: the largest
    divisor of ``nz`` at most ``n_shards - lost`` (>= 1, so a plan can
    always shrink to the bit-identical single-shard fallback)."""
    target = max(1, int(n_shards) - int(lost))
    for n in range(target, 0, -1):
        if domain.nz % n == 0:
            return n
    return 1


def elastic_shrink(plan, state=None, lost: int = 1):
    """A twin of ``plan`` rebuilt at the surviving shard count
    (``InteractionPlan.execute_checked`` calls it when a
    :class:`ShardLost` surfaces). The slabs are re-cut at
    :func:`surviving_shard_count` shards and the mesh is dropped: the
    survivor runs its shards stacked on the plan's device. Every per-shard
    bound (``shard_cap``; ``max_active`` when compacted; ``pair_cap`` when
    ``layout="sfc"``, since fewer slabs each hold more pairs) is
    re-measured from ``state``'s positions when given, else scaled by the
    load ratio. Shrinking to one shard is the inner plan bit for bit, its
    ``max_active`` and ``pair_cap`` measured over the whole grid (JAX keeps
    the per-shard bounds there)."""
    from ..core.api import suggest_max_active, suggest_pair_cap
    if not plan.n_shards or plan.n_shards <= 1:
        return plan
    ns = surviving_shard_count(plan.domain, plan.n_shards, lost)
    pos = state.positions if state is not None else None
    ratio = plan.n_shards / ns
    sfc = plan.layout == "sfc"

    def scaled(bound: int, most: Optional[int] = None) -> int:
        # fewer shards: each slab holds at least old_load * old / new
        grown = -(-int(bound * ratio + 0.999) // 8) * 8
        return grown if most is None else min(grown, most)

    if ns <= 1:
        dom = plan.domain
        max_active, pair_cap = plan.max_active, plan.pair_cap
        if pos is not None:
            if plan.compact:
                max_active = suggest_max_active(dom, pos, plan.strategy)
            if sfc:
                pair_cap = suggest_pair_cap(dom, pos)
        else:
            if plan.compact:
                max_active = scaled(max_active, dom.nz * dom.ny)
            if sfc:
                pair_cap = scaled(pair_cap, sfc_n_clusters(dom) * 27)
        return dataclasses.replace(plan, n_shards=1, shard_cap=None,
                                   max_active=max_active, pair_cap=pair_cap,
                                   mesh=None, box=None)
    if pos is not None:
        shard_cap, max_active, pair_cap = halo_bounds(
            plan.domain, pos, ns, layout=plan.layout, compact=plan.compact)
        max_active = max_active if plan.compact else plan.max_active
        pair_cap = pair_cap if sfc else plan.pair_cap
    else:
        shard_cap = scaled(plan.shard_cap)
        max_active, pair_cap = plan.max_active, plan.pair_cap
        if plan.compact:
            max_active = scaled(max_active, plan.domain.nz * plan.domain.ny)
        if sfc:
            pair_cap = scaled(pair_cap, sfc_n_clusters(
                slab_domain(plan.domain, ns)) * 27)
    return dataclasses.replace(plan, n_shards=ns, shard_cap=shard_cap,
                               max_active=max_active, pair_cap=pair_cap,
                               mesh=None, box=None)


def halo_grown_bounds(plan, state, align: int = 8
                      ) -> Tuple[int, Optional[int]]:
    """-> ``(shard_cap, max_active)`` covering ``state``, growing only the
    bound(s) that overflowed (the replan contract)."""
    pos = state.positions
    counts = cell_counts(plan.domain, pos, state.valid)   # one binning pass
    shard_cap = plan.shard_cap
    loads = H.shard_loads(plan.domain, pos, plan.n_shards, counts=counts)
    if int(loads.max()) > shard_cap:
        grow = -(-(shard_cap + 1) // align) * align       # aligned, > cap
        shard_cap = max(H.suggest_shard_cap(plan.domain, pos, plan.n_shards,
                                            align=align), grow)
    max_active = plan.max_active
    if plan.compact:
        n_act = int(shard_pencil_active(plan.domain, counts,
                                        plan.n_shards).max())
        if n_act > max_active:
            max_active = max(
                H.suggest_shard_max_active(plan.domain, pos, plan.n_shards,
                                           align=align, counts=counts),
                n_act)
    return shard_cap, max_active
