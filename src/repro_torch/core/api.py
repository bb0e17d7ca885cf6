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
``"reference"`` runs every strategy.

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

Every static bound (``m_c``, ``max_active``, ``row_cap``, ``pair_cap``)
follows one replan contract, stated on :meth:`InteractionPlan.replan`; the
``allin`` sub-box ``box`` follows ``m_c``. ``plan.trajectory`` runs MD on
the plan (``repro_torch.traj``), whose circuit breaker and degradation
ladder (``plan_health``, ``degradation_ladder``) live here.

Every backend takes layout data with a leading system axis: ``execute`` is
the batch of one, run through :meth:`InteractionPlan.execute_batch`'s body
and squeezed. The ``"cuda"`` backends launch each kernel once for the whole
batch; the ``"reference"`` backends, plain PyTorch, run system by system.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from . import strategies as S
from . import traffic
from ._device import resolve_device
from .binning import (CellBins, PackedRows, SfcClusters, bin_particles,
                      build_sfc_clusters, cell_counts, dense_to_particles,
                      full_pencil_occupancy, pack_rows, packed_to_particles,
                      padded_row_counts, pencil_counts, pencil_occupancy,
                      sfc_n_clusters, sfc_pair_count, sfc_to_particles,
                      subbox_counts, subbox_occupancy, system)
from .domain import Domain
from .interactions import PairKernel, make_lennard_jones

STRATEGY_NAMES = ("par_part", "cell_dense", "xpencil", "allin")
CELL_SCHEDULES = ("cell_dense", "xpencil", "allin")   # have compact=True
LAYOUT_NAMES = ("dense", "packed", "sfc")

# Backends the JAX package has and this port does not yet, with the
# ROADMAP.md Queue 1 item that ports each. Asking for one raises; nothing
# runs instead.
_NOT_PORTED = {"halo": 11}


def _check_ported(backend: str) -> None:
    item = _NOT_PORTED.get(backend)
    if item is not None:
        raise ValueError(
            f"backend={backend!r} is not ported to repro_torch yet "
            f"(ROADMAP.md Queue 1 item {item})")


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


def register_backend(backend: str, strategy: str, compact: bool = False,
                     layout: str = "dense"):
    """Register an implementation under ``(backend, strategy, layout)``;
    ``compact=True`` declares that it also honours ``plan.compact``
    (occupancy-compacted iteration)."""
    if layout not in LAYOUT_NAMES:
        raise ValueError(f"unknown layout {layout!r}; have {LAYOUT_NAMES}")

    def deco(fn: Callable) -> Callable:
        _BACKENDS[(backend, strategy, layout)] = fn
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

    def __post_init__(self):
        _check_ported(self.backend)
        if self.strategy not in ("naive_n2", *STRATEGY_NAMES):
            raise ValueError(f"unknown strategy {self.strategy!r}; have "
                             f"{list(STRATEGY_NAMES)} + ['naive_n2']")
        if self.backend == "cuda" and self.kernel.cuda is None:
            raise ValueError(
                f"pair kernel {self.kernel.name!r} has no CUDA form; use "
                "backend='reference'")
        if self.strategy == "allin" and self.box is None:
            object.__setattr__(self, "box", _allin_box(self.domain, self.m_c))
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

    def execute(self, state: ParticleState
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (forces (N, 3), per-particle potential (N,)). Total potential
        energy is ``0.5 * potential.sum()`` (each pair counted twice)."""
        self._check_state(state, batched=False)
        if self.strategy == "naive_n2":
            fx, fy, fz, pot = S.naive_n2(self.domain, state.positions,
                                         self.kernel)
            return torch.stack([fx, fy, fz], dim=-1), pot
        forces, pot = self._execute_stacked(ParticleState(
            state.positions[None], {k: v[None] for k, v in
                                    state.fields.items()},
            None if state.valid is None else state.valid[None]))
        return forces[0], pot[0]

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
        oracle run system by system."""
        self._check_state(states, batched=True)
        if self.strategy == "naive_n2":
            outs = [self.execute(system(states, b))
                    for b in range(states.positions.shape[0])]
            return tuple(torch.stack(o) for o in zip(*outs))
        return self._execute_stacked(states)

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

    def _execute_stacked(self, states: ParticleState
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The body of ``execute`` and ``execute_batch``: bin, lay out and
        run the backend on systems stacked on a leading axis."""
        bins = self.bin(states)
        if self.layout == "packed":
            return get_backend(self.backend, self.strategy, "packed")(
                self, self.pack(bins), states)
        if self.layout == "sfc":
            return get_backend(self.backend, self.strategy, "sfc")(
                self, self.clusters(bins), states)
        return get_backend(self.backend, self.strategy)(self, bins, states)

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
        ``"row_cap"``, ``"pair_cap"`` or ``"max_active"`` (checked in that
        order), ``"injected"`` (a verdict forced at the ``core.binning``
        fault point, ``repro_torch.testing.chaos``), or None when every
        bound holds. One binning pass; waits for the device."""
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
        if self.layout == "sfc":
            if sfc_pair_count(self.domain, counts=counts) > self.pair_cap:
                return "pair_cap"
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
          ``layout="sfc"`` plan (``suggest_pair_cap``).

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
            n_pairs = sfc_pair_count(self.domain, counts=counts)
            if n_pairs > pair_cap:
                grow = -(-(pair_cap + 1) // align) * align
                pair_cap = max(suggest_pair_cap(self.domain, align=align,
                                                counts=counts), grow, n_pairs)
        max_active = self.max_active
        if self.compact:
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
        return dataclasses.replace(self, m_c=m_c, box=box,
                                   max_active=max_active, row_cap=row_cap,
                                   pair_cap=pair_cap)

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


def plan(domain: Domain, kernel: Optional[PairKernel] = None, *,
         positions: Optional[torch.Tensor] = None, m_c: Optional[int] = None,
         strategy: str = "auto", backend: str = "cuda",
         batch_size: int = 64, device=None, compact: bool = False,
         max_active: Optional[int] = None, layout: str = "dense",
         row_cap: Optional[int] = None,
         box: Optional[Tuple[int, int, int]] = None,
         pair_cap: Optional[int] = None,
         m_c_slack: float = 1.5) -> InteractionPlan:
    """Build an :class:`InteractionPlan`.

    Every bound taken or measured here (``m_c``, ``max_active``,
    ``row_cap``, ``pair_cap``) obeys the replan contract of
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
        PyTorch versions on CPU tensors) or ``"reference"`` (plain PyTorch,
        every strategy). With ``strategy="autotune"``, ``"all"`` tunes
        over the platform default set (``"reference"`` and, on the card,
        ``"cuda"``).
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

    ``strategy="autotune"`` explores the compacted, packed and sfc
    candidates itself and ignores ``compact``, ``max_active``, ``layout``,
    ``row_cap`` and ``pair_cap``; the caller's ``batch_size`` and ``box``
    join its sweep as candidates.
    """
    _check_ported(backend)
    device = resolve_device(device)
    kernel = kernel or make_lennard_jones()
    if strategy == "autotune":
        from . import autotune
        if positions is None:
            raise ValueError('strategy="autotune" needs positions (the '
                             "tuner times real executions)")
        backends = None if backend == "all" else (backend,)
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
        if layout == "packed":
            among = tuple(S.PACKED_STRATEGIES)
        if layout == "sfc":
            among = tuple(S.SFC_STRATEGIES)
        strategy = choose_strategy(domain, m_c,
                                   positions.shape[0] / domain.n_cells,
                                   among=among)
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
        pair_cap = suggest_pair_cap(domain, positions)
    if compact and strategy in CELL_SCHEDULES:
        if not supports_compact(backend, strategy, layout):
            raise ValueError(f"backend {backend!r} has no compacted path for "
                             f"strategy {strategy!r} (layout {layout!r})")
        if max_active is None:
            if positions is None:
                raise ValueError("compact=True needs either max_active or "
                                 "positions (to measure the active-unit "
                                 "bound)")
            mbox = box
            if strategy == "allin" and mbox is None:
                mbox = _allin_box(domain, m_c)
            max_active = suggest_max_active(domain, positions, strategy,
                                            box=mbox)
    p = InteractionPlan(domain=domain, kernel=kernel, m_c=m_c,
                        strategy=strategy, backend=backend,
                        batch_size=batch_size, device=device,
                        compact=compact, max_active=max_active,
                        layout=layout, row_cap=row_cap, box=box,
                        pair_cap=pair_cap)
    if strategy != "naive_n2":
        get_backend(backend, strategy, layout)        # fail at plan time
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
    replan (grown ``m_c``/``row_cap``/...) keeps the same breaker state."""
    return (p.domain, p.kernel, p.strategy, p.backend, p.layout, p.compact,
            p.batch_size, p.device)


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
    versions anyway), then layout packed/sfc -> dense where the backend
    has it, then compact -> not. Rung 0 is always ``p``; a plan on the card
    keeps its backend on every rung, so a breach never moves it off the
    kernels."""
    rungs = [p]
    q = p
    if q.backend == "cuda" and q.device.type != "cuda":
        q = dataclasses.replace(q, backend="reference")
        rungs.append(q)
    if (q.layout in ("packed", "sfc")
            and supports_layout(q.backend, q.strategy, "dense")):
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
