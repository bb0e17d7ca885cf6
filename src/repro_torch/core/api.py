"""Plan/execute interaction API (port of ``repro.core.api``).

    state = ParticleState(positions)
    p = plan(domain, kernel, positions=positions, strategy="xpencil")
    forces, potential = p.execute(state)
    forces, potential = p.execute_batch(ParticleState(stacked))  # (B, N, 3)

Strategies: ``par_part``, ``cell_dense``, ``xpencil``, ``allin`` and the
``naive_n2`` oracle; ``"auto"`` (the default) picks the one the
``core.traffic`` cost model gives the fewest HBM bytes per interaction,
``"autotune"`` times candidates on the positions (``core.autotune``). The
``"cuda"`` backend runs ``xpencil`` (dense, compacted, packed), ``allin``
(dense only) and ``cell_dense`` in the SFC cluster layout
(``layout="sfc"``), as the JAX package's ``"pallas"`` backend does;
``"reference"`` runs every strategy. ``backend="halo"`` splits the grid
into Z-slabs, one per shard, and runs the plan's schedule on each slab on
``halo_inner`` (``repro_torch.dist.engine``): stacked on the plan's device
when ``mesh`` is None, one slab per rank of a ``DeviceMesh`` otherwise.

``plan`` runs on the CUDA device unless the caller passes ``device="cpu"``;
with no visible card it raises instead of falling back. On the CPU the
``"cuda"`` backend's kernel wrappers run their plain PyTorch versions,
because the tensors they are given lie on the CPU.

The backend registry maps ``(backend, strategy, layout)`` to one normalized
signature ``(plan, layout_data, states) -> (forces (B, N, 3), pot (B, N))``
over stacked systems, where
the layout data is a ``CellBins`` ("dense"), a ``PackedRows`` ("packed")
or an ``SfcClusters`` ("sfc"). It is the port's own registry: the JAX
package's registry is never touched. This module registers the
``"reference"`` backends; ``repro_torch.kernels`` registers the ``"cuda"``
ones.

Every static bound (``m_c``, ``max_active``, ``row_cap``, ``pair_cap``,
``shard_cap``) follows one replan contract, stated on
:meth:`InteractionPlan.replan`; the ``allin`` sub-box ``box`` follows
``m_c``. ``plan.trajectory`` runs MD on
the plan (``repro_torch.traj``), whose circuit breaker and degradation
ladder (``plan_health``, ``degradation_ladder``) live here.

Every backend takes layout data with a leading system axis: ``execute`` is
the batch of one, run through :meth:`InteractionPlan.execute_batch`'s body
and squeezed. The ``"cuda"`` backends launch each kernel once for the whole
batch; the ``"reference"`` backends, plain PyTorch, run system by system.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

# obs.trace and obs.metrics import nothing of the library: no cycle
from ..obs import metrics as _obs_metrics
from ..obs.trace import (event as _obs_event, trace as _obs_trace,
                         tracing_enabled as _tracing_enabled)

from . import strategies as S
from . import traffic
from ._device import resolve_device
from .binning import (CellBins, PackedRows, SfcClusters, bin_particles,
                      build_sfc_clusters, cell_counts, dense_to_particles,
                      full_pencil_occupancy, pack_rows, packed_to_particles,
                      padded_row_counts, pencil_counts, pencil_occupancy,
                      sfc_n_clusters, sfc_pair_count, sfc_to_particles,
                      subbox_counts, subbox_occupancy, system)
from .domain import Domain, slab_domain
from .interactions import PairKernel, make_lennard_jones

STRATEGY_NAMES = ("par_part", "cell_dense", "xpencil", "allin")
CELL_SCHEDULES = ("cell_dense", "xpencil", "allin")   # have compact=True
LAYOUT_NAMES = ("dense", "packed", "sfc")

# --------------------------------------------------------------------------
# input
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ParticleState:
    """Positions plus optional per-particle fields and a ``valid`` mask.

    ``fields`` maps names to (N,) tensors binned alongside x/y/z. ``valid``
    is an optional (N,) bool mask marking padding rows (False): they are
    excluded from binning and interact with nothing, so executing a padded
    state gives the real rows the same bits as the unpadded state. For
    :meth:`InteractionPlan.execute_batch`, B systems stack on a leading
    axis: positions (B, N, 3), fields and ``valid`` (B, N).
    """

    positions: torch.Tensor                              # (N, 3)
    fields: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    valid: Optional[torch.Tensor] = None                 # (N,) bool

    @property
    def n(self) -> int:
        return self.positions.shape[0]

    def tensors(self) -> Dict[str, torch.Tensor]:
        out = {"positions": self.positions, **self.fields}
        if self.valid is not None:
            out["valid"] = self.valid
        return out


# --------------------------------------------------------------------------
# backend registry
# --------------------------------------------------------------------------

_BACKENDS: Dict[Tuple[str, str, str], Callable] = {}

# (backend, strategy, layout) triples that honour ``plan.compact``
_COMPACT_OK: set = set()

# (backend, strategy, layout) -> the CUDA sources (``kernels/csrc/``) its
# path launches on the card, binning included
_SOURCES: Dict[Tuple[str, str, str], Tuple[str, ...]] = {}


def register_backend(backend: str, strategy: str, compact: bool = False,
                     layout: str = "dense", sources: Tuple[str, ...] = ()):
    """Register an implementation under ``(backend, strategy, layout)``;
    ``compact=True`` declares that it also honours ``plan.compact``
    (occupancy-compacted iteration); ``sources`` names the CUDA sources
    its path launches on the card, which a plan's executor loads when it
    is built (a source left out loads at its first launch)."""
    if layout not in LAYOUT_NAMES:
        raise ValueError(f"unknown layout {layout!r}; have {LAYOUT_NAMES}")

    def deco(fn: Callable) -> Callable:
        _BACKENDS[(backend, strategy, layout)] = fn
        _SOURCES[(backend, strategy, layout)] = tuple(sources)
        if compact:
            _COMPACT_OK.add((backend, strategy, layout))
        return fn
    return deco


def _register_cuda(backend: str) -> None:
    if backend == "cuda":
        import repro_torch.kernels  # noqa: F401  (registers on import)


def supports_compact(backend: str, strategy: str,
                     layout: str = "dense") -> bool:
    """True if ``(backend, strategy, layout)`` implements the compacted
    path."""
    _register_cuda(backend)
    return (backend, strategy, layout) in _COMPACT_OK


def supports_layout(backend: str, strategy: str, layout: str) -> bool:
    """True if ``(backend, strategy)`` implements the given layout."""
    _register_cuda(backend)
    return (backend, strategy, layout) in _BACKENDS


def get_backend(backend: str, strategy: str,
                layout: str = "dense") -> Callable:
    _register_cuda(backend)
    fn = _BACKENDS.get((backend, strategy, layout))
    if fn is None:
        raise ValueError(
            f"no backend {backend!r} for strategy {strategy!r} with layout "
            f"{layout!r}; registered: {sorted(_BACKENDS)}")
    return fn


def backend_matrix() -> Dict[str, Tuple[str, ...]]:
    """backend name -> strategies it implements, in any layout."""
    _register_cuda("cuda")
    out: Dict[str, list] = {}
    for b, s, _layout in sorted(_BACKENDS):
        if s not in out.setdefault(b, []):
            out[b].append(s)
    return {b: tuple(s) for b, s in out.items()}


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InteractionPlan:
    """All static choices for a cutoff interaction, made once. Hashable."""

    domain: Domain
    kernel: PairKernel
    m_c: int
    strategy: str = "xpencil"
    backend: str = "cuda"
    batch_size: int = 64              # units per chunk of the plain versions
    device: torch.device = torch.device("cuda")
    compact: bool = False             # occupancy-compacted path
    max_active: Optional[int] = None  # static active-unit bound
    layout: str = "dense"             # dense | packed | sfc
    row_cap: Optional[int] = None     # static packed-row bound
    box: Optional[Tuple[int, int, int]] = None   # allin sub-box (bx, by, bz)
    pair_cap: Optional[int] = None    # static sfc pair-list bound
    # -- halo execution (backend="halo"; repro_torch.dist.engine) ---------
    halo_inner: str = "cuda"          # per-shard backend
    n_shards: Optional[int] = None    # Z-slabs
    shard_axis: str = "halo"          # the mesh dimension to shard along
    shard_cap: Optional[int] = None   # static per-shard capacity
    mesh: Optional[object] = None     # 1-D DeviceMesh; None = stacked shards

    def __post_init__(self):
        if self.strategy not in ("naive_n2", *STRATEGY_NAMES):
            raise ValueError(f"unknown strategy {self.strategy!r}; have "
                             f"{list(STRATEGY_NAMES)} + ['naive_n2']")
        if self.backend == "halo":
            if self.strategy not in CELL_SCHEDULES:
                raise ValueError(
                    f"backend='halo' needs a cell schedule, got "
                    f"{self.strategy!r} (the Z-slab decomposition has no "
                    "meaning for particle-parallel or O(N^2) sweeps)")
            if self.halo_inner == "halo":
                raise ValueError("halo_inner must be a concrete per-shard "
                                 "backend ('reference'/'cuda'), not "
                                 "'halo' itself")
            if not self.n_shards or self.n_shards < 1:
                raise ValueError(
                    "backend='halo' needs n_shards >= 1 "
                    "(plan(..., backend='halo') derives one from the "
                    "visible devices)")
            if self.domain.nz % self.n_shards:
                raise ValueError(
                    f"nz={self.domain.nz} not divisible by "
                    f"n_shards={self.n_shards}")
            if self.n_shards > 1 and (not self.shard_cap
                                      or self.shard_cap < 1):
                raise ValueError(
                    "a multi-shard halo plan needs a positive static "
                    "shard_cap (plan(..., positions=...) measures one)")
            if self.compact and self.strategy == "allin":
                raise ValueError(
                    "backend='halo' supports compact=True for the pencil "
                    "schedules (xpencil/cell_dense) only: the All-in-SM "
                    "sub-box occupancy is not defined per slab")
        if self.inner_backend == "cuda" and self.kernel.cuda is None:
            raise ValueError(
                f"pair kernel {self.kernel.name!r} has no CUDA form; use "
                "backend='reference'")
        if self.strategy == "allin" and self.box is None:
            # halo plans tile the slab each shard runs on
            bdom = self.domain
            if self.backend == "halo" and self.n_shards:
                bdom = slab_domain(self.domain, self.n_shards)
            object.__setattr__(self, "box", _allin_box(bdom, self.m_c))
        if self.compact:
            if self.strategy not in CELL_SCHEDULES:
                raise ValueError(
                    f"compact=True is not defined for {self.strategy!r} "
                    "(only the cell schedules have empty work units to skip)")
            if not self.max_active or self.max_active < 1:
                raise ValueError(
                    "compact=True needs a positive static max_active bound "
                    "(plan(..., positions=...) measures one)")
        if self.layout not in LAYOUT_NAMES:
            raise ValueError(
                f"unknown layout {self.layout!r}; have {LAYOUT_NAMES}")
        if self.layout == "packed":
            if self.strategy not in S.PACKED_STRATEGIES:
                raise ValueError(
                    f'layout="packed" is not defined for {self.strategy!r}; '
                    f"packed strategies: {sorted(S.PACKED_STRATEGIES)}")
            if not self.row_cap or self.row_cap < 1:
                raise ValueError(
                    'layout="packed" needs a positive static row_cap bound '
                    "(plan(..., positions=...) measures one)")
        if self.layout == "sfc":
            if self.strategy not in S.SFC_STRATEGIES:
                raise ValueError(
                    f'layout="sfc" is not defined for '
                    f"{self.strategy!r}; sfc strategies: "
                    f"{sorted(S.SFC_STRATEGIES)}")
            if not self.pair_cap or self.pair_cap < 1:
                raise ValueError(
                    'layout="sfc" needs a positive static pair_cap bound '
                    "(plan(..., positions=...) measures one)")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def inner_backend(self) -> str:
        """The backend that runs the schedule: ``halo_inner`` for a halo
        plan, else ``backend``."""
        return self.halo_inner if self.backend == "halo" else self.backend

    @property
    def _multi_shard(self) -> bool:
        return self.backend == "halo" and (self.n_shards or 1) > 1

    def execute(self, state: ParticleState
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (forces (N, 3), per-particle potential (N,)). Total potential
        energy is ``0.5 * potential.sum()`` (each pair counted twice). Runs
        the cached executor of (plan, field names), built on first use
        (:func:`recompile_count`), and counts a dispatch."""
        self._check_state(state, batched=False)
        _count_dispatch(self)
        names = tuple(sorted(state.fields))
        if not _tracing_enabled():       # the disabled path opens no span
            return _executor(self, names).single(state)
        with _obs_trace("plan.execute", backend=self.backend,
                        strategy=self.strategy, layout=self.layout,
                        n=int(state.positions.shape[0])):
            return _executor(self, names).single(state)

    __call__ = execute

    def execute_batch(self, states: ParticleState
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched hot path (port of JAX's ``execute_batch``).

        ``states`` holds B independent systems stacked on a leading axis:
        positions ``(B, N, 3)``, each field ``(B, N)``, ``valid`` ``(B,
        N)``, all sharing this plan's domain and static bounds, each bound
        holding per system (``max_active`` units, ``row_cap`` slots a row,
        ``pair_cap`` codes, each system's). Returns ``(forces (B, N, 3),
        potential (B, N))``, bit-identical to ``execute`` on each system.

        On ``"cuda"`` one chain of launches covers the batch, its length
        independent of B: kernel A scans the B * n_cells counts once, and
        each force kernel and the pack kernel launch once. The
        ``"reference"`` schedules, plain PyTorch, and the ``naive_n2``
        oracle run system by system. Counts a dispatch, as ``execute``."""
        self._check_state(states, batched=True)
        _count_dispatch(self)
        names = tuple(sorted(states.fields))
        if not _tracing_enabled():       # the disabled path opens no span
            return _batch_executor(self, names).batch(states)
        with _obs_trace("plan.execute_batch", backend=self.backend,
                        strategy=self.strategy, layout=self.layout,
                        batch=int(states.positions.shape[0])):
            return _batch_executor(self, names).batch(states)

    def _check_state(self, state: ParticleState, batched: bool) -> None:
        pos = state.positions
        want = ("(B, N, 3) with B >= 1" if batched
                else "(N, 3) (stacked systems go to execute_batch)")
        if pos.dim() != 2 + batched or pos.shape[-1] != 3 or (
                batched and pos.shape[0] < 1):
            raise ValueError(f"state.positions must be {want}, got "
                             f"{tuple(pos.shape)}")
        for name, t in state.tensors().items():
            if name != "positions" and tuple(t.shape) != tuple(pos.shape[:-1]):
                raise ValueError(
                    f"state.{name} has shape {tuple(t.shape)}, the positions "
                    f"{tuple(pos.shape)}: want {tuple(pos.shape[:-1])}")
            if t.device != self.device:
                raise ValueError(
                    f"state.{name} is on {t.device}, the plan runs on "
                    f"{self.device}; move the state first")
        if self.strategy == "naive_n2" and state.valid is not None:
            raise ValueError(
                "naive_n2 bypasses binning and cannot mask padded "
                "(valid=) rows; use a cell schedule")

    def bin(self, state: ParticleState) -> CellBins:
        """The state's bins; stacked states give stacked bins."""
        return bin_particles(self.domain, state.positions, state.fields,
                             m_c=self.m_c, valid=state.valid)

    def pack(self, bins: CellBins) -> PackedRows:
        return pack_rows(self.domain, bins, row_cap=self.row_cap)

    def clusters(self, bins: CellBins) -> SfcClusters:
        return build_sfc_clusters(self.domain, bins, pair_cap=self.pair_cap)

    def traffic_report(self, avg_ppc: float) -> traffic.TrafficReport:
        return traffic.model(self.domain, self.m_c, avg_ppc)[self.strategy]

    # -- the replan contract -------------------------------------------------

    def check_overflow(self, state: ParticleState) -> bool:
        """True if some static bound of this plan no longer covers these
        positions, so results computed anyway would drop interactions.
        Padding rows (``state.valid`` False) are excluded. See
        :meth:`replan` for the contract."""
        return self.overflow_class(state) is not None

    def overflow_class(self, state: ParticleState) -> Optional[str]:
        """Which static bound these positions breach, ``"m_c"``,
        ``"row_cap"``, ``"pair_cap"``, ``"shard_cap"`` or ``"max_active"``
        (a multi-shard plan's per-shard loads, pair lists and active
        pencils reduced by max over shards), ``"injected"`` (a verdict
        forced at the ``core.binning`` fault point,
        ``repro_torch.testing.chaos``), or None when every bound holds. One binning pass; waits for the device."""
        with _obs_trace("plan.overflow_check", strategy=self.strategy,
                        layout=self.layout) as sp:
            oc = self._overflow_class(state)
            sp.set(result=oc or "ok")
        return oc

    def _overflow_class(self, state: ParticleState) -> Optional[str]:
        from ..testing import chaos
        if chaos.forced_overflow("core.binning"):
            return "injected"
        counts = cell_counts(self.domain, state.positions, state.valid)
        if int(counts.max()) > self.m_c:
            return "m_c"
        if self.layout == "packed":
            if int(padded_row_counts(self.domain, counts).max()) > \
                    self.row_cap:
                return "row_cap"
        if self.layout == "sfc" and not self._multi_shard:
            # a multi-shard plan checks pair_cap per shard (slab-local
            # cluster orders) in halo_overflow_class below
            if sfc_pair_count(self.domain, counts=counts) > self.pair_cap:
                return "pair_cap"
        if self._multi_shard:
            from ..dist.engine import halo_overflow_class
            return halo_overflow_class(self, counts)
        if self.compact:
            if active_unit_count(self.domain, state.positions, self.strategy,
                                 box=self.box, counts=counts) > \
                    self.max_active:
                return "max_active"
        return None

    def replan(self, state: ParticleState, slack: float = 1.5,
               align: int = 8) -> "InteractionPlan":
        """A new plan whose static bounds cover ``state``.

        **The replan contract.** Every static bound follows one pattern:
        measure with slack, round up to ``align``, detect overflow, grow
        only what overflowed. The bounds and their probes:

        * ``m_c``: max particles per cell (``suggest_m_c``),
        * ``max_active``: active work units (pencils, or ``allin``
          sub-boxes) of a compacted plan (``suggest_max_active``),
        * ``row_cap``: particles per padded pencil row of a
          ``layout="packed"`` plan (``suggest_row_cap``),
        * ``pair_cap``: length of the compressed cluster-pair list of a
          ``layout="sfc"`` plan (``suggest_pair_cap``; per shard for a
          multi-shard plan, ``dist.engine.shard_sfc_pairs``),
        * ``shard_cap``: per-shard particle load of a multi-shard halo plan
          (``dist.halo.suggest_shard_cap``), whose ``max_active`` covers
          the busiest shard's active pencils.

        An exceeded bound makes results silently drop interactions, so
        ``check_overflow`` detects it from one binning pass, and this method
        grows only the bound that overflowed, re-measured with slack and
        strictly past its old value. Derived statics follow their inputs:
        the ``allin`` sub-box is recomputed whenever ``m_c`` changes, and a
        compacted ``allin`` plan re-measures ``max_active`` against the new
        tiling. ``row_cap`` and ``pair_cap`` depend only on the positions,
        so they never move when ``m_c`` does. Padding rows (``state.valid``
        False) are excluded from every measure."""
        counts = cell_counts(self.domain, state.positions, state.valid)
        m_c = self.m_c
        mx_cell = int(counts.max())
        if mx_cell > self.m_c:
            measured = -(-max(1, int(mx_cell * slack + 0.999)) // align
                         ) * align
            grow = -(-(self.m_c + 1) // align) * align   # aligned, > m_c
            m_c = max(measured, grow)
        box = self.box if m_c == self.m_c else None
        row_cap = self.row_cap
        if self.layout == "packed":
            mx_row = int(padded_row_counts(self.domain, counts).max())
            if mx_row > row_cap:
                grow = -(-(row_cap + 1) // align) * align
                row_cap = max(suggest_row_cap(self.domain, state.positions,
                                              align=align, counts=counts),
                              grow)
        pair_cap = self.pair_cap
        if self.layout == "sfc":
            if self._multi_shard:
                # per shard: each slab has its own cluster order, so the
                # busiest shard's pair list sets the cap
                from ..dist.engine import shard_pair_cap, shard_sfc_pairs
                n_pairs = max(shard_sfc_pairs(self.domain, counts,
                                              self.n_shards))
                suggested = shard_pair_cap(n_pairs, align)
            else:
                n_pairs = sfc_pair_count(self.domain, counts=counts)
                suggested = suggest_pair_cap(self.domain, align=align,
                                             counts=counts)
            if n_pairs > pair_cap:
                grow = -(-(pair_cap + 1) // align) * align
                pair_cap = max(suggested, grow, n_pairs)
        max_active = self.max_active
        shard_cap = self.shard_cap
        if self._multi_shard:
            # per-shard load against shard_cap, per-shard active pencils
            # against max_active, each grown only when exceeded
            from ..dist.engine import halo_grown_bounds
            shard_cap, max_active = halo_grown_bounds(self, state,
                                                      align=align)
        elif self.compact:
            if self.strategy == "allin" and box is None:
                # fix the new tiling first: the active-sub-box bound must be
                # measured against the grid that will run
                box = _allin_box(self.domain, m_c)
            n_act = active_unit_count(self.domain, state.positions,
                                      self.strategy, box=box, counts=counts)
            if n_act > max_active or box != self.box:
                max_active = max(suggest_max_active(
                    self.domain, state.positions, self.strategy, box=box,
                    align=align, counts=counts), n_act)
        grown = dataclasses.replace(self, m_c=m_c, box=box,
                                    max_active=max_active, row_cap=row_cap,
                                    pair_cap=pair_cap, shard_cap=shard_cap)
        if grown != self:                # no-op replans are not replans
            _count_replan(self)
            _obs_event("plan.replan", strategy=self.strategy,
                       layout=self.layout, m_c=grown.m_c, m_c_was=self.m_c,
                       row_cap=grown.row_cap, pair_cap=grown.pair_cap,
                       max_active=grown.max_active,
                       shard_cap=grown.shard_cap)
        return grown

    def trajectory(self, state, n_steps: int, dt: float, *,
                   integrator: str = "velocity_verlet",
                   skin: Optional[float] = None, **opts):
        """Run ``n_steps`` of bin -> force -> integrate simulation with
        Verlet-skin neighbor reuse, invariant monitors, checkpoint/rollback
        and deterministic resume. Returns a
        :class:`repro_torch.traj.TrajectoryResult`.

        ``state`` is an ``MDState``, a ``ParticleState`` (+ optional
        ``velocities=``) or a raw ``(N, 3)`` positions tensor. ``skin`` is
        the Verlet margin (default: a quarter cutoff; ``0`` = re-bin every
        step, bit-identical to a per-step :meth:`execute` loop). Forwarded
        options (``checkpoint_dir``, ``checkpoint_every``, ``segment_len``,
        ``energy_budget``, ``mass``, ``gamma``/``kT`` for the langevin
        integrator, ...): see :func:`repro_torch.traj.engine.run_trajectory`,
        where the contract lives. Requires a cell schedule (``cell_dense``
        / ``xpencil`` / ``allin``)."""
        from ..traj.engine import run_trajectory
        return run_trajectory(self, state, n_steps, dt,
                              integrator=integrator, skin=skin, **opts)

    def execute_checked(self, state: ParticleState, *,
                        max_replans: int = 4,
                        max_retries: Optional[int] = None,
                        sleep=None
                        ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                   "ExecutionReport"]:
        """Guarded execute. -> ``((forces, potential), report)``: the
        :class:`ExecutionReport` carries the overflow class, the non-finite
        output count and the out-of-domain particle count (one host read),
        and the degradation-ladder / circuit-breaker trajectory;
        ``report.plan`` is the plan to keep using (replans applied).

        Injected faults (``core.dispatch``: delay, error, nonfinite;
        ``core.binning``: overflow) and non-finite outputs are retried,
        stepping down :func:`degradation_ladder` through the breaker, and
        the worst case is ``status="failed"`` with zero outputs. Nothing is
        caught: a real exception (a CUDA error, a failed nvcc build)
        propagates, where JAX's ``execute_checked`` counts it as a
        failure."""
        return _execute_checked(self, state, max_replans=max_replans,
                                max_retries=max_retries, sleep=sleep)

    def execute_or_replan(self, state: ParticleState
                          ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                     "InteractionPlan"]:
        """Overflow-safe execute: replans while a bound is exceeded, then
        executes. -> ``((forces, potential), plan)``, ``plan`` is ``self``
        when every bound held."""
        p: InteractionPlan = self
        while p.check_overflow(state):
            p = p.replan(state)
        return p.execute(state), p

    def distribute(self, mesh=None, *, n_shards: Optional[int] = None,
                   shard_axis: Optional[str] = None,
                   positions: Optional[torch.Tensor] = None,
                   shard_cap: Optional[int] = None,
                   halo_inner: Optional[str] = None) -> "InteractionPlan":
        """A halo twin of this plan: the same schedule and static bounds,
        run over Z-slabs (``repro_torch.dist.engine``).

        Args:
          mesh: a 1-D ``DeviceMesh`` holding the shard axis (one slab per
            rank); None stacks every shard on this plan's device.
          n_shards: Z-slabs (must divide ``nz``); defaults to the mesh's
            shard-axis size, else the largest ``nz`` divisor that fits the
            visible devices (``dist.engine.default_n_shards``).
          shard_axis: mesh dimension to shard along (default ``"halo"``, or
            the mesh's first dimension when a mesh is given).
          positions: representative positions to measure the static
            ``shard_cap`` (and, compacted, the per-shard ``max_active``)
            from; required unless ``shard_cap`` is given.
          shard_cap: explicit static per-shard particle capacity.
          halo_inner: per-shard backend; defaults to this plan's backend.
        """
        from ..dist import engine as dist_engine
        names = (() if mesh is None
                 else dist_engine.mesh_axis_names(mesh))
        axis = shard_axis or (names[0] if mesh is not None
                              else self.shard_axis)
        if mesh is not None and axis not in names:
            raise ValueError(
                f"mesh has axes {names}, no {axis!r} shard axis")
        n_shards = dist_engine.shard_count(self.domain, mesh, axis, n_shards,
                                           self.device)
        inner = halo_inner or self.inner_backend
        max_active = self.max_active
        if n_shards > 1:
            if shard_cap is None and positions is None:
                raise ValueError(
                    "distribute() needs either shard_cap or positions "
                    "(to measure the per-shard capacity)")
            if positions is not None:
                # the per-shard shard_cap and (compacted) max_active; the
                # whole grid's pair_cap stays, as in the JAX package
                shard_cap, max_active, _ = dist_engine.halo_bounds(
                    self.domain, positions, n_shards, compact=self.compact,
                    shard_cap=shard_cap,
                    max_active=None if self.compact else max_active)
        box = None if self.strategy == "allin" else self.box
        return dataclasses.replace(
            self, backend="halo", halo_inner=inner, n_shards=n_shards,
            shard_axis=axis, shard_cap=shard_cap, mesh=mesh, box=box,
            max_active=max_active)


def plan(domain: Domain, kernel: Optional[PairKernel] = None, *,
         positions: Optional[torch.Tensor] = None, m_c: Optional[int] = None,
         strategy: str = "auto", backend: str = "cuda",
         batch_size: int = 64, device=None, compact: bool = False,
         max_active: Optional[int] = None, layout: str = "dense",
         row_cap: Optional[int] = None,
         box: Optional[Tuple[int, int, int]] = None,
         pair_cap: Optional[int] = None,
         m_c_slack: float = 1.5, halo_inner: str = "cuda",
         n_shards: Optional[int] = None, shard_axis: str = "halo",
         shard_cap: Optional[int] = None, mesh=None) -> InteractionPlan:
    """Build an :class:`InteractionPlan`.

    Every bound taken or measured here (``m_c``, ``max_active``,
    ``row_cap``, ``pair_cap``, ``shard_cap``) obeys the replan contract of
    :meth:`InteractionPlan.replan`.

    Args:
      domain: the cell grid.
      kernel: pair kernel (default Lennard-Jones).
      positions: representative positions; required when a bound is None,
        and for ``strategy="auto"`` (the fill ratio) and ``"autotune"``.
      m_c: static max-particles-per-cell bound; measured from ``positions``
        with slack ``m_c_slack`` and rounded up to a multiple of 8 when
        omitted.
      strategy: ``"par_part"``, ``"cell_dense"``, ``"xpencil"``, ``"allin"``
        or the ``"naive_n2"`` oracle; ``"auto"`` picks the strategy with
        the fewest modelled HBM bytes per interaction
        (:func:`choose_strategy`, ``core.traffic``); ``"autotune"`` times
        candidate plans on ``positions`` and returns the fastest
        (``core.autotune.tune``; winners persist in an on-disk cache).
        With ``compact=True``, ``"auto"`` chooses among the cell
        schedules; with ``layout="packed"`` or ``"sfc"``, among the
        strategies that have that layout. Where the pick has no path on
        ``backend`` (``compact=True`` picks ``allin``, which ``"cuda"``
        runs dense only), the plan raises: nothing else is chosen.
      backend: ``"cuda"`` (hand-written kernels, for ``xpencil``,
        ``allin`` and ``cell_dense`` with ``layout="sfc"``; their plain
        PyTorch versions on CPU tensors), ``"reference"`` (plain PyTorch,
        every strategy) or ``"halo"`` (Z-slab execution of a cell schedule,
        each slab on ``halo_inner``; ``repro_torch.dist.engine``). With
        ``strategy="autotune"``, ``"all"`` tunes over the platform default
        set (``"reference"`` and, on the card, ``"cuda"``), and so does
        ``"halo"``, whose shard counts join the tuner's sweep.
      device: ``None`` means the CUDA device, and raises when none is
        visible; ``"cpu"`` runs on the CPU.
      compact: occupancy-compacted execution: only the work units that
        hold particles are visited ((z, y) pencils: kernel C, or kernel D
        over active rows; ``allin`` sub-boxes on the reference backend).
      max_active: static active-unit bound for ``compact=True``; measured
        from ``positions`` with slack when omitted.
      layout: ``"dense"`` (every cell owns ``m_c`` slots), ``"packed"``
        (CSR pencil rows under ``row_cap``, ``xpencil`` only, kernel D) or
        ``"sfc"`` (cells in Morton order grouped into clusters of 4, and
        only the (cluster, stencil slot) pairs that hold particles on both
        sides, under ``pair_cap``; ``cell_dense`` only, kernel F). Packed
        composes with ``compact``, which sfc accepts and ignores (its pair
        list is already the compaction); per-particle results equal the
        dense layout's.
      row_cap: static particles-per-packed-row bound for
        ``layout="packed"``; measured from ``positions`` with slack when
        omitted.
      box: ``allin`` sub-box (bx, by, bz); sized from a block's shared
        memory (``strategies.subbox_dims``) when omitted.
      pair_cap: static compressed-pair-list bound for ``layout="sfc"``;
        measured from ``positions`` with slack when omitted.
      m_c_slack: the slack of the measured ``m_c`` (and, with
        ``"autotune"``, of its slacked ``m_c`` candidate).
      halo_inner: per-shard backend of ``backend="halo"`` (``"cuda"`` or
        ``"reference"``).
      n_shards: Z-slabs of ``backend="halo"`` (must divide ``nz``); the
        mesh's shard-axis size when a mesh is given, else the largest
        divisor of ``nz`` that fits the visible devices (1 on one card or
        on the CPU: the bit-identical single-shard fallback). Any count
        runs without a mesh: the shards stack on ``device``.
      shard_axis / mesh: a 1-D ``torch.distributed.device_mesh.DeviceMesh``
        whose ``shard_axis`` dimension carries one slab per rank, every
        rank passing the same state; None stacks the shards on one device.
      shard_cap: static per-shard particle capacity of ``backend="halo"``;
        measured from ``positions`` with slack when omitted.

    ``strategy="autotune"`` explores the compacted, packed and sfc
    candidates itself and ignores ``compact``, ``max_active``, ``layout``,
    ``row_cap`` and ``pair_cap``; the caller's ``batch_size`` and ``box``
    join its sweep as candidates.
    """
    device = resolve_device(device)
    kernel = kernel or make_lennard_jones()
    if strategy == "autotune":
        from . import autotune
        if positions is None:
            raise ValueError('strategy="autotune" needs positions (the '
                             "tuner times real executions)")
        # the tuner owns the shard-count axis: tune the platform default
        # backends and let halo twins join the sweep
        backends = None if backend in ("all", "halo") else (backend,)
        batch_sizes = tuple(dict.fromkeys(
            (batch_size, *autotune.DEFAULT_BATCH_SIZES)))
        return autotune.tune(domain, kernel, positions, m_c=m_c,
                             backends=backends, batch_sizes=batch_sizes,
                             box=box, m_c_slack=m_c_slack,
                             device=device).plan
    if m_c is None:
        if positions is None:
            raise ValueError("plan() needs either m_c or positions "
                             "(to measure the M_C bound)")
        from .engine import suggest_m_c
        m_c = suggest_m_c(domain, positions, slack=m_c_slack)
    if strategy == "auto":
        if positions is None:
            raise ValueError('strategy="auto" needs positions (the cost '
                             "model is parameterized by the fill ratio)")
        # compact=True narrows the choice to the schedules that have a
        # compacted path somewhere, layout="packed"/"sfc" to those that
        # have the layout, as in the JAX package
        among = CELL_SCHEDULES if compact else None
        if backend == "halo":
            among = (("cell_dense", "xpencil") if compact
                     else CELL_SCHEDULES)
        if layout == "packed":
            among = tuple(S.PACKED_STRATEGIES)
        if layout == "sfc":
            among = tuple(S.SFC_STRATEGIES)
        strategy = choose_strategy(domain, m_c,
                                   positions.shape[0] / domain.n_cells,
                                   among=among)
    inner_backend = halo_inner if backend == "halo" else backend
    multi_shard = False
    if backend == "halo":
        from ..dist import engine as dist_engine
        names = () if mesh is None else dist_engine.mesh_axis_names(mesh)
        if mesh is not None and shard_axis not in names:
            raise ValueError(
                f"mesh has axes {names}, no {shard_axis!r} shard axis: "
                "pass shard_axis=<one of them> (or use "
                "plan.distribute(mesh), which defaults to the mesh's first "
                "axis)")
        n_shards = dist_engine.shard_count(domain, mesh, shard_axis,
                                           n_shards, device)
        multi_shard = n_shards > 1
        if multi_shard and shard_cap is None and positions is None:
            raise ValueError("backend='halo' needs either shard_cap or "
                             "positions (to measure the per-shard "
                             "capacity)")
    if layout == "packed" and strategy in S.PACKED_STRATEGIES and \
            row_cap is None:
        if positions is None:
            raise ValueError('layout="packed" needs either row_cap or '
                             "positions (to measure the packed-row bound)")
        row_cap = suggest_row_cap(domain, positions)
    if layout == "sfc" and strategy in S.SFC_STRATEGIES and pair_cap is None:
        if positions is None:
            raise ValueError('layout="sfc" needs either pair_cap or '
                             "positions (to measure the pair-list bound)")
        if not multi_shard:             # a halo plan's: per shard, below
            pair_cap = suggest_pair_cap(domain, positions)
    if compact and strategy in CELL_SCHEDULES:
        if not supports_compact(inner_backend, strategy, layout):
            raise ValueError(f"backend {inner_backend!r} has no compacted "
                             f"path for strategy {strategy!r} (layout "
                             f"{layout!r})")
        if max_active is None:
            if positions is None:
                raise ValueError("compact=True needs either max_active or "
                                 "positions (to measure the active-unit "
                                 "bound)")
            if not multi_shard:         # a halo plan's: per shard, below
                mbox = box
                if strategy == "allin" and mbox is None:
                    mbox = _allin_box(domain, m_c)
                max_active = suggest_max_active(domain, positions, strategy,
                                                box=mbox)
    if multi_shard and positions is not None:
        # the busiest shard's load, active pencils and pair list (each slab
        # has its own cluster order), not the whole grid's
        shard_cap, max_active, pair_cap = dist_engine.halo_bounds(
            domain, positions, n_shards,
            layout=layout if strategy in S.SFC_STRATEGIES else "dense",
            compact=compact, shard_cap=shard_cap, max_active=max_active,
            pair_cap=pair_cap)
    p = InteractionPlan(domain=domain, kernel=kernel, m_c=m_c,
                        strategy=strategy, backend=backend,
                        batch_size=batch_size, device=device,
                        compact=compact, max_active=max_active,
                        layout=layout, row_cap=row_cap, box=box,
                        pair_cap=pair_cap, halo_inner=halo_inner,
                        n_shards=n_shards, shard_axis=shard_axis,
                        shard_cap=shard_cap, mesh=mesh)
    if strategy != "naive_n2":
        # fail at plan time (a halo plan: the per-shard backend)
        get_backend(inner_backend, strategy, layout)
    return p


def choose_strategy(domain: Domain, m_c: int, avg_ppc: float,
                    among: Optional[Tuple[str, ...]] = None,
                    subbox: Optional[Tuple[int, int, int]] = None) -> str:
    """``strategy="auto"``: minimize modelled HBM bytes per interaction.

    The paper's Fig. 7 argument as a decision rule — the schedule that moves
    the fewest global-memory bytes per interaction wins in the memory-bound
    regime the paper targets. Ties break toward the paper's X-pencil.
    ``among`` restricts the choice (e.g. to the compact-capable schedules).
    ``subbox`` is the ``allin`` sub-box the model assumes (default: the
    port's shared-memory sizing, ``strategies.subbox_dims``).
    """
    reports = traffic.model(domain, m_c, max(avg_ppc, 1e-3), subbox=subbox)
    order = {"xpencil": 0, "allin": 1, "cell_dense": 2, "par_part": 3}
    pool = [r for r in reports.values() if among is None or r.strategy in among]
    return min(pool,
               key=lambda r: (r.hbm_bytes_per_interaction,
                              order[r.strategy])).strategy


# --------------------------------------------------------------------------
# static-bound probes (one-off, outside the hot path; they wait for the
# device)
# --------------------------------------------------------------------------

def _allin_box(domain: Domain, m_c: int) -> Tuple[int, int, int]:
    """Shared-memory-budget sub-box, shrunk to divisors of the grid."""
    return S.shrink_to_divisors(domain, S.subbox_dims(domain, m_c))


def _unit_box(domain: Domain,
              box: Optional[Tuple[int, int, int]]) -> Tuple[int, int, int]:
    """The sub-box tiling the allin units are counted on; the box of
    ``m_c`` 1 when none is given, as in the JAX package."""
    return S.shrink_to_divisors(domain, box or _allin_box(domain, 1))


def active_unit_count(domain: Domain, positions: torch.Tensor,
                      strategy: str = "xpencil",
                      box: Optional[Tuple[int, int, int]] = None,
                      counts: Optional[torch.Tensor] = None) -> int:
    """Number of work units holding at least one particle: (z, y) pencils
    (``xpencil``/``cell_dense``) or sub-boxes of the given tiling
    (``allin``). Pass precomputed per-cell ``counts`` to skip the binning
    pass."""
    if counts is None:
        counts = cell_counts(domain, positions)
    if strategy == "allin":
        units = subbox_counts(domain, counts, _unit_box(domain, box))
    else:
        units = pencil_counts(domain, counts)
    return int((units > 0).sum())


def n_units(domain: Domain, strategy: str = "xpencil",
            box: Optional[Tuple[int, int, int]] = None) -> int:
    """Total work units of a schedule (denominator of the fill fraction)."""
    if strategy == "allin":
        bx, by, bz = _unit_box(domain, box)
        return (domain.nx // bx) * (domain.ny // by) * (domain.nz // bz)
    return domain.nz * domain.ny


def suggest_max_active(domain: Domain, positions: torch.Tensor,
                       strategy: str = "xpencil",
                       box: Optional[Tuple[int, int, int]] = None,
                       slack: float = 1.25, align: int = 8,
                       counts: Optional[torch.Tensor] = None) -> int:
    """Static ``max_active`` bound: active units with slack, rounded up to
    ``align``, clipped to the total unit count."""
    n_act = active_unit_count(domain, positions, strategy, box=box,
                              counts=counts)
    bound = max(1, int(n_act * slack + 0.999))
    bound = -(-bound // align) * align
    return min(bound, n_units(domain, strategy, box=box))


def suggest_row_cap(domain: Domain, positions: torch.Tensor,
                    slack: float = 1.25, align: int = 8,
                    counts: Optional[torch.Tensor] = None) -> int:
    """Static ``row_cap`` bound for ``layout="packed"``: the fullest padded
    pencil row (``binning.padded_row_counts``) with slack, rounded up to
    ``align``."""
    if counts is None:
        counts = cell_counts(domain, positions)
    mx = int(padded_row_counts(domain, counts).max())
    cap = max(1, int(mx * slack + 0.999))
    return -(-cap // align) * align


def suggest_pair_cap(domain: Domain, positions: Optional[torch.Tensor] = None,
                     slack: float = 1.25, align: int = 8,
                     counts: Optional[torch.Tensor] = None) -> int:
    """Static ``pair_cap`` bound for ``layout="sfc"``: the compressed
    cluster-pair list length (``binning.sfc_pair_count``) with slack,
    rounded up to ``align``, clipped to the all-pairs total ``n_clusters *
    27`` but never below the measured length."""
    n_pairs = sfc_pair_count(domain, positions, counts=counts)
    cap = max(1, int(n_pairs * slack + 0.999))
    cap = -(-cap // align) * align
    return max(min(cap, sfc_n_clusters(domain) * 27), n_pairs)


# --------------------------------------------------------------------------
# steady-state counters and the executor cache
# --------------------------------------------------------------------------
#
# Three counters in the port's metrics registry (``repro_torch.obs``),
# labelled by (backend, strategy, layout): dispatches (``execute`` and
# ``execute_batch`` calls), executor builds ("recompiles") and replans
# (``replan`` calls that grew a bound, the trajectory's mid-run replans
# too). The functions below read their totals over every label set.
#
# An executor is what ``execute``/``execute_batch`` take from the LRU for
# one (plan, sorted field names). Building it resolves the plan's backend
# function, loads the kernel libraries its path launches on the card
# (the sources its backend's registration names; nvcc builds them on
# first use) and stages the plan's constant device tensors (the SFC cluster and slot tables). Torch
# traces nothing, so a build is the port's recompile: a new plan, a new
# field structure, or an evicted executor that is rebuilt. JAX's counter
# also moves for a new shape of the same structure (``jit`` retraces);
# the port's does not, since nothing it caches depends on the shape.
# Eviction costs host time only: a rebuilt executor runs the same
# launches on the same inputs, so its results are bit-identical.

DISPATCH_TOTAL = "repro_torch_dispatch_total"
RECOMPILE_TOTAL = "repro_torch_recompile_total"
REPLAN_TOTAL = "repro_torch_replan_total"


def _plan_counter(name: str, p: "InteractionPlan") -> _obs_metrics.Counter:
    return _obs_metrics.registry.counter(name, backend=p.backend,
                                         strategy=p.strategy,
                                         layout=p.layout)


def dispatch_count() -> int:
    """``execute`` and ``execute_batch`` calls so far."""
    return int(_obs_metrics.registry.total(DISPATCH_TOTAL))


def recompile_count() -> int:
    """Executor builds so far (see the note above): moves only for a new
    plan, a new field structure or an evicted executor being rebuilt,
    and for a trajectory's executor built the same way."""
    return int(_obs_metrics.registry.total(RECOMPILE_TOTAL))


def replan_count() -> int:
    """Replans so far: ``plan.replan`` calls that grew a bound, and the
    trajectory engine's mid-run replans."""
    return int(_obs_metrics.registry.total(REPLAN_TOTAL))


def reset_counters() -> None:
    """Zero every steady-state counter of the port's registry in one call:
    dispatch, recompile, replan and the autotuner's ``timing_run_count``
    (``obs.registry.reset()``). The executor caches are untouched."""
    _obs_metrics.registry.reset()


def _count_dispatch(p: "InteractionPlan") -> None:
    _plan_counter(DISPATCH_TOTAL, p).inc()


def _count_recompile(p: "InteractionPlan") -> None:
    _plan_counter(RECOMPILE_TOTAL, p).inc()


def _count_replan(p: "InteractionPlan") -> None:
    _plan_counter(REPLAN_TOTAL, p).inc()


class _Executor:
    """The cached runner of one (plan, field names); see the note above. A
    single-shard halo plan runs its inner backend directly; a multi-shard
    one runs ``dist.engine.halo_impl``."""

    def __init__(self, p: "InteractionPlan", field_names: Tuple[str, ...]):
        _count_recompile(p)
        self.plan = p
        self.field_names = field_names
        self.backend = (None if p.strategy == "naive_n2"
                        else get_backend(p.inner_backend, p.strategy,
                                         p.layout))
        self.halo = None
        dom = p.domain
        if p._multi_shard:
            from ..dist.engine import GHOST_EXCHANGE_TOTAL, halo_impl
            self.halo = halo_impl(p, field_names)
            _obs_metrics.registry.counter(
                GHOST_EXCHANGE_TOTAL,
                n_shards=p.n_shards).inc(self.halo.n_value_planes)
            dom = self.halo.local_dom
        if p.layout == "sfc":
            from .binning import (DEFAULT_CSIZE, DEFAULT_CURVE,
                                  sfc_device_slot_tables, sfc_device_tables)
            sfc_device_tables(dom, DEFAULT_CSIZE, DEFAULT_CURVE, p.device)
            sfc_device_slot_tables(dom, p.m_c, DEFAULT_CSIZE, DEFAULT_CURVE,
                                   p.device)
        sources = (() if self.backend is None
                   else _SOURCES[(p.inner_backend, p.strategy, p.layout)])
        if sources and p.device.type == "cuda":
            from ..kernels import _build
            _build.load_all(sources)

    def forces(self, bins: CellBins, states: ParticleState
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The backend on given stacked bins: lay them out as the plan's
        layout asks, then run it."""
        p = self.plan
        if p.layout == "packed":
            return self.backend(p, p.pack(bins), states)
        if p.layout == "sfc":
            return self.backend(p, p.clusters(bins), states)
        return self.backend(p, bins, states)

    def batch(self, states: ParticleState
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stacked systems: bin them, then :meth:`forces`; the
        ``naive_n2`` oracle runs system by system."""
        if self.backend is None:
            outs = [self.single(system(states, b))
                    for b in range(states.positions.shape[0])]
            return tuple(torch.stack(o) for o in zip(*outs))
        if self.halo is not None:
            return self.halo(states)
        return self.forces(self.plan.bin(states), states)

    def single(self, state: ParticleState
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One system: the batch of one, squeezed."""
        if self.backend is None:
            fx, fy, fz, pot = S.naive_n2(self.plan.domain, state.positions,
                                         self.plan.kernel)
            return torch.stack([fx, fy, fz], dim=-1), pot
        forces, pot = self.batch(ParticleState(
            state.positions[None], {k: v[None] for k, v in
                                    state.fields.items()},
            None if state.valid is None else state.valid[None]))
        return forces[0], pot[0]


_CacheInfo = collections.namedtuple(
    "CacheInfo", ["hits", "misses", "maxsize", "currsize"])


class _LRU:
    """A resizable least-recently-used cache with ``functools.lru_cache``'s
    ``cache_info()`` / ``cache_clear()`` surface. Bounded because the
    autotuner builds throwaway candidate plans by the dozen."""

    def __init__(self, maxsize: int, build: Callable):
        self._build = build
        self._maxsize = maxsize
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self._hits = 0
        self._misses = 0

    def __call__(self, *key):
        if key in self._data:
            self._hits += 1
            self._data.move_to_end(key)
            return self._data[key]
        self._misses += 1
        value = self._build(*key)
        self._data[key] = value
        self._evict()
        return value

    def _evict(self) -> None:
        while len(self._data) > self._maxsize:
            self._data.popitem(last=False)

    def resize(self, maxsize: int) -> None:
        """Change the capacity; excess (least recent) entries are evicted
        at once."""
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self._maxsize = maxsize
        self._evict()

    def cache_info(self) -> _CacheInfo:
        return _CacheInfo(self._hits, self._misses, self._maxsize,
                          len(self._data))

    def cache_clear(self) -> None:
        self._data.clear()
        self._hits = 0
        self._misses = 0


_executor = _LRU(128, _Executor)
_batch_executor = _LRU(32, _Executor)


def clear_executor_cache() -> None:
    """Drop every cached executor (single and batched)."""
    _executor.cache_clear()
    _batch_executor.cache_clear()


def set_executor_cache_size(single: Optional[int] = None,
                            batch: Optional[int] = None) -> None:
    """Resize the executor LRUs (excess entries evicted at once). Eviction
    costs a rebuild on next use, never a different result."""
    if single is not None:
        _executor.resize(single)
    if batch is not None:
        _batch_executor.resize(batch)


def executor_cache_info() -> Dict[str, _CacheInfo]:
    """``{"single": CacheInfo, "batch": CacheInfo}`` (hits, misses,
    maxsize, currsize)."""
    return {"single": _executor.cache_info(),
            "batch": _batch_executor.cache_info()}


# --------------------------------------------------------------------------
# circuit breaker and degradation ladder
# --------------------------------------------------------------------------
#
# Port of the JAX package's breaker. _FAILURE_THRESHOLD consecutive
# failures step one rung DOWN the degradation ladder (packed/sfc -> dense
# layout, then compact -> not; on the CPU the ladder starts with cuda ->
# reference backend, as JAX's starts with pallas -> reference);
# _RECOVERY_THRESHOLD consecutive clean runs step one rung back UP. Every
# rung computes the same physics. The port catches no exception, so a
# failure here is an injected fault or an invariant breach the trajectory
# engine's monitors report (``repro_torch.traj``), never a kernel that
# raised: a CUDA error or a failed build propagates to the caller. A plan
# on the card never steps onto the plain PyTorch schedules: past its last
# kernel rung, a failing trajectory ends ``"failed"``.

_FAILURE_THRESHOLD = 3     # consecutive failures to trip one rung down
_RECOVERY_THRESHOLD = 8    # consecutive clean runs to climb one rung up


@dataclasses.dataclass
class PlanHealth:
    """Per-plan circuit-breaker state. ``level`` indexes into
    :func:`degradation_ladder`; 0 = healthy."""

    level: int = 0
    consec_failures: int = 0
    consec_clean: int = 0
    trips: int = 0             # lifetime rung-down transitions
    recoveries: int = 0        # lifetime rung-up transitions

    def note_failure(self, n_rungs: int) -> bool:
        """Record one failure; True if the breaker tripped a rung down
        (hysteresis: the failure streak resets on the trip)."""
        self.consec_clean = 0
        self.consec_failures += 1
        if (self.consec_failures >= _FAILURE_THRESHOLD
                and self.level < n_rungs - 1):
            self.level += 1
            self.trips += 1
            self.consec_failures = 0
            return True
        return False

    def note_success(self) -> bool:
        """Record one clean run; True if the breaker recovered a rung up
        (after _RECOVERY_THRESHOLD consecutive clean runs)."""
        self.consec_failures = 0
        self.consec_clean += 1
        if self.level > 0 and self.consec_clean >= _RECOVERY_THRESHOLD:
            self.level -= 1
            self.recoveries += 1
            self.consec_clean = 0
            return True
        return False


def _health_key(p: InteractionPlan) -> Tuple:
    """Breaker identity: the plan minus its grown/derived bounds, so a
    replan (grown ``m_c``/``row_cap``/...) or an elastic shard shrink keeps
    the same breaker state."""
    return (p.domain, p.kernel, p.strategy, p.backend, p.halo_inner,
            p.layout, p.compact, p.batch_size, p.device)


_health: Dict[Tuple, PlanHealth] = {}


def plan_health(p: InteractionPlan) -> PlanHealth:
    """The live circuit-breaker state for a plan (created healthy on first
    access)."""
    return _health.setdefault(_health_key(p), PlanHealth())


def reset_health() -> None:
    """Forget every plan's breaker state (test bookkeeping)."""
    _health.clear()


def degradation_ladder(p: InteractionPlan) -> Tuple[InteractionPlan, ...]:
    """The rungs a failing plan steps down: the plan itself, then backend
    cuda -> reference (CPU plans only, where ``"cuda"`` runs the plain
    versions anyway; a halo plan steps its ``halo_inner``), then layout
    packed/sfc -> dense where the backend has it, then compact -> not.
    Rung 0 is always ``p``; a plan on the card keeps its backend on every
    rung, so a breach never moves it off the kernels (a halo plan keeps
    its shards and steps its inner plan down the same ladder)."""
    rungs = [p]
    q = p
    if q.inner_backend == "cuda" and q.device.type != "cuda":
        q = dataclasses.replace(
            q, **{"halo_inner" if q.backend == "halo" else "backend":
                  "reference"})
        rungs.append(q)
    if (q.layout in ("packed", "sfc")
            and supports_layout(q.inner_backend, q.strategy, "dense")):
        q = dataclasses.replace(q, layout="dense")
        rungs.append(q)
    if q.compact:
        q = dataclasses.replace(q, compact=False)
        rungs.append(q)
    return tuple(rungs)


def fallback_plan(p: InteractionPlan) -> InteractionPlan:
    """The most-degraded rung: dense and uncompacted, on the reference
    backend for a CPU plan and on the kernels for a plan on the card."""
    return degradation_ladder(p)[-1]


# --------------------------------------------------------------------------
# guarded execution: execute_checked and its report
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ExecutionReport:
    """What one :meth:`InteractionPlan.execute_checked` call observed.

    ``status`` is ``"ok"`` (healthy rung, clean), ``"degraded"`` (results
    from a lower ladder rung, the same physics) or ``"failed"`` (retries
    exhausted; forces and potential are zeros). ``plan`` is the plan to
    keep using, replans and elastic shard shrinks applied."""

    status: str = "ok"
    plan: Optional[InteractionPlan] = None
    overflow: Optional[str] = None     # bound class that overflowed
    replans: int = 0                   # bound-growth attempts this call
    retries: int = 0                   # extra execution attempts
    nonfinite: int = 0                 # non-finite output elements seen
    out_of_domain: int = 0             # valid particles outside the box
    faults: List[str] = dataclasses.field(default_factory=list)
    ladder_level: int = 0              # rung that produced the result
    backend: str = ""                  # backend of that rung
    layout: str = ""                   # layout of that rung
    breaker_trips: int = 0             # rung-down transitions this call
    recovered: bool = False            # rung-up transition this call
    shard_shrinks: int = 0             # elastic shard shrinks this call


def _output_check(forces: torch.Tensor, pot: torch.Tensor,
                  positions: torch.Tensor, valid: Optional[torch.Tensor],
                  box: Tuple[float, float, float]) -> Tuple[int, int]:
    """(non-finite force and potential elements, valid particles outside
    the box), padding rows excluded, read from the device with one host
    read, which also waits for the outputs. Works on one system or on
    stacked systems."""
    bad = (~torch.isfinite(forces)).sum(-1) + (~torch.isfinite(pot))
    ood = ((positions < 0.0).any(-1) | (positions[..., 0] > box[0])
           | (positions[..., 1] > box[1]) | (positions[..., 2] > box[2]))
    if valid is not None:
        bad = torch.where(valid, bad, torch.zeros_like(bad))
        ood = ood & valid
    counts = torch.stack([bad.sum(), ood.sum()]).tolist()
    return int(counts[0]), int(counts[1])


class _NonFiniteOutput(RuntimeError):
    """An execution produced non-finite forces or potential; the port
    never raises it, it is the fault ``execute_checked`` records (JAX's
    text)."""

    def __init__(self, count: int):
        super().__init__(f"{count} non-finite output element(s)")
        self.count = int(count)


def _execute_checked(base: InteractionPlan, state: ParticleState, *,
                     max_replans: int = 4,
                     max_retries: Optional[int] = None, sleep=None):
    with _obs_trace("plan.execute_checked", backend=base.backend,
                    strategy=base.strategy, layout=base.layout) as sp:
        out, report = _execute_checked_impl(
            base, state, max_replans=max_replans, max_retries=max_retries,
            sleep=sleep)
        sp.set(status=report.status, overflow=report.overflow or "none",
               replans=report.replans, retries=report.retries,
               ladder_level=report.ladder_level)
        return out, report


def _execute_checked_impl(base: InteractionPlan, state: ParticleState, *,
                          max_replans: int, max_retries: Optional[int],
                          sleep):
    from ..testing import chaos

    report = ExecutionReport(plan=base)
    p = base
    # 1. bounded replan loop: an injected overflow verdict with nothing to
    # grow must not storm (replan returns an equal plan; stop)
    for _ in range(max_replans):
        oc = p.overflow_class(state)
        if oc is None:
            break
        report.overflow = report.overflow or oc
        grown = p.replan(state)
        report.replans += 1
        if grown == p:
            break
        p = grown
    report.plan = p

    rungs = degradation_ladder(p)
    health = plan_health(p)
    level = min(health.level, len(rungs) - 1)
    if max_retries is None:
        max_retries = _FAILURE_THRESHOLD * len(rungs)
    attempts = 0
    while True:
        rung = rungs[level]
        if sleep is None:
            chaos.maybe_delay("core.dispatch")
        else:
            chaos.maybe_delay("core.dispatch", sleep=sleep)
        # JAX's except branches, taken for an injected fault or a
        # non-finite output; a real exception propagates
        fault = (chaos.injected_fault("dist.exchange") if rung._multi_shard
                 else None)
        if fault is None:
            fault = chaos.injected_fault("core.dispatch")
        if fault is None:
            f, u = rung.execute(state)
            f = chaos.corrupt("core.dispatch", f)
            bad, report.out_of_domain = _output_check(
                f, u, state.positions, state.valid, p.domain.box)
            if not bad:
                forces, pot = f, u
                break                              # clean execution
            report.nonfinite += bad
            fault = _NonFiniteOutput(bad)
        if isinstance(fault, chaos.ShardLost) and rung._multi_shard:
            # elastic shrink: rebuild at the surviving shard count and
            # re-execute; the replan contract re-measures the per-shard
            # bounds (dist.engine.elastic_shrink)
            from ..dist.engine import elastic_shrink
            report.faults.append(f"shard_loss:{fault}")
            p = elastic_shrink(p, state)
            report.plan = p
            report.shard_shrinks += 1
            _obs_event("plan.shard_shrink", n_shards=p.n_shards or 1,
                       fault=str(fault))
            rungs = degradation_ladder(p)
            health = plan_health(p)          # the same key: shrink-stable
            level = min(level, len(rungs) - 1)
        else:
            if isinstance(fault, chaos.ShardLost):
                # a single-shard plan: a plain failure (JAX's elif branch)
                report.faults.append(f"shard_loss:{fault}")
                detail = str(fault)
            else:
                report.faults.append(f"{type(fault).__name__}: {fault}")
                detail = type(fault).__name__
            if health.note_failure(len(rungs)):
                report.breaker_trips += 1
                level = health.level
                _obs_event("plan.degrade", level=level,
                           backend=rungs[level].backend,
                           layout=rungs[level].layout, fault=detail)
        attempts += 1
        report.retries = attempts
        if attempts > max_retries:
            report.status = "failed"
            report.ladder_level = level
            report.backend = rung.backend
            report.layout = rung.layout
            return (torch.zeros_like(state.positions),
                    state.positions.new_zeros(state.positions.shape[:-1])
                    ), report

    report.recovered = health.note_success()
    if report.recovered:
        _obs_event("plan.recover", level=level, backend=rungs[level].backend)
    report.ladder_level = level
    report.backend = rungs[level].backend
    report.layout = rungs[level].layout
    report.status = "ok" if level == 0 else "degraded"
    return (forces, pot), report


# --------------------------------------------------------------------------
# reference backend: the plain PyTorch schedules of core.strategies
# --------------------------------------------------------------------------

def _each_system(fn: Callable) -> Callable:
    """A reference backend over stacked systems: ``fn`` on each system's
    views of the layout data and state, in order, its results stacked. The
    schedules are plain PyTorch, so looping on the host is what they do."""
    @functools.wraps(fn)
    def run(p: InteractionPlan, data, states: ParticleState):
        outs = [fn(p, system(data, b), system(states, b))
                for b in range(states.positions.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    return run


@register_backend("reference", "par_part")
@_each_system
def _ref_par_part(p: InteractionPlan, bins: CellBins, state: ParticleState):
    fx, fy, fz, pot = S.par_part(p.domain, bins, state.positions, p.kernel,
                                 p.batch_size)
    return torch.stack([fx, fy, fz], dim=-1), pot


def _ref_cell_schedule(name: str) -> Callable:
    """Reference backend of a cell schedule: the dense sweep, or its
    occupancy-compacted variant when the plan asks for it."""
    dense_fn, sparse_fn = S.STRATEGIES[name], S.SPARSE_STRATEGIES[name]

    @_each_system
    def impl(p: InteractionPlan, bins: CellBins, state: ParticleState):
        kwargs = {"batch_size": p.batch_size}
        if name == "allin":
            kwargs["box"] = S.shrink_to_divisors(p.domain, p.box)
        if not p.compact:
            out = dense_fn(p.domain, bins, p.kernel, **kwargs)
        elif name == "allin":
            occ = subbox_occupancy(p.domain, bins.counts, kwargs["box"],
                                   p.max_active)
            out = sparse_fn(p.domain, bins, p.kernel, occ, **kwargs)
        else:
            occ = pencil_occupancy(p.domain, bins.counts, p.max_active)
            out = sparse_fn(p.domain, bins, p.kernel, occ, **kwargs)
        return dense_to_particles(p.domain, bins, *out)
    return impl


register_backend("reference", "cell_dense", compact=True)(
    _ref_cell_schedule("cell_dense"))
register_backend("reference", "xpencil", compact=True)(
    _ref_cell_schedule("xpencil"))
register_backend("reference", "allin", compact=True)(
    _ref_cell_schedule("allin"))


@register_backend("reference", "xpencil", compact=True, layout="packed")
@_each_system
def _ref_xpencil_packed(p: InteractionPlan, packed: PackedRows,
                        state: ParticleState):
    """Packed rows; active-row iteration when the plan is compacted, every
    row otherwise."""
    occ = (pencil_occupancy(p.domain, packed.counts, p.max_active)
           if p.compact else full_pencil_occupancy(p.domain, p.device))
    out = S.xpencil_packed(p.domain, packed, p.kernel, occ,
                           batch_size=p.batch_size)
    return packed_to_particles(p.domain, packed, *out)


@register_backend("reference", "cell_dense", compact=True, layout="sfc")
@_each_system
def _ref_cell_sfc(p: InteractionPlan, sfc: SfcClusters,
                  state: ParticleState):
    """SFC clusters; ``compact=True`` changes nothing: the pair list is
    already the occupancy compaction (empty neighbourhoods never enter
    ``codes``)."""
    out = S.cell_sfc(p.domain, sfc, p.kernel, batch_size=p.batch_size)
    return sfc_to_particles(p.domain, sfc, *out)
