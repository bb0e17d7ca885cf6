"""Plan/execute interaction API (port of ``repro.core.api``).

    state = ParticleState(positions)
    p = plan(domain, kernel, positions=positions, strategy="xpencil")
    forces, potential = p.execute(state)

``plan`` runs on the CUDA device unless the caller passes ``device="cpu"``;
with no visible card it raises instead of falling back. On the CPU the
``"cuda"`` backend's kernel wrappers run their plain PyTorch versions,
because the tensors they are given lie on the CPU.

The backend registry maps ``(backend, strategy, layout)`` to one normalized
signature ``(plan, layout_data, state) -> (forces (N,3), pot (N,))``, where
the layout data is a ``CellBins`` ("dense") or a ``PackedRows``
("packed"). It is the port's own registry: the JAX package's registry is
never touched. This module registers the ``"reference"`` backends;
``repro_torch.kernels`` registers the ``"cuda"`` ones.

Every static bound (``m_c``, ``max_active``, ``row_cap``) follows one
replan contract, stated on :meth:`InteractionPlan.replan`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from . import strategies as S
from ._device import resolve_device
from .binning import (CellBins, PackedRows, bin_particles, cell_counts,
                      dense_to_particles, full_pencil_occupancy, pack_rows,
                      packed_to_particles, padded_row_counts, pencil_counts,
                      pencil_occupancy)
from .domain import Domain
from .interactions import PairKernel, make_lennard_jones

STRATEGY_NAMES = ("xpencil",)
LAYOUT_NAMES = ("dense", "packed")

# What the JAX package has and this port does not yet, with the ROADMAP.md
# Queue 1 item that ports it. Asking for one raises; nothing runs instead.
_NOT_PORTED = {
    "strategy": {"par_part": 2, "cell_dense": 2, "allin": 7, "auto": 8,
                 "autotune": 8},
    "backend": {"halo": 11},
    "layout": {"sfc": 6},
}


def _not_ported(option: str, value) -> ValueError:
    item = _NOT_PORTED[option][value]
    return ValueError(
        f"{option}={value!r} is not ported to repro_torch yet "
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
    state gives the real rows the same bits as the unpadded state.
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
    batch_size: int = 64              # pencils per chunk of the plain version
    device: torch.device = torch.device("cuda")
    compact: bool = False             # occupancy-compacted path
    max_active: Optional[int] = None  # static active-pencil bound
    layout: str = "dense"             # dense | packed
    row_cap: Optional[int] = None     # static packed-row bound

    def __post_init__(self):
        if self.strategy in _NOT_PORTED["strategy"]:
            raise _not_ported("strategy", self.strategy)
        if self.strategy not in ("naive_n2", *STRATEGY_NAMES):
            raise ValueError(f"unknown strategy {self.strategy!r}; have "
                             f"{list(STRATEGY_NAMES)} + ['naive_n2']")
        if self.backend in _NOT_PORTED["backend"]:
            raise _not_ported("backend", self.backend)
        if self.backend == "cuda" and self.kernel.cuda is None:
            raise ValueError(
                f"pair kernel {self.kernel.name!r} has no CUDA form; use "
                "backend='reference'")
        if self.compact:
            if self.strategy not in STRATEGY_NAMES:
                raise ValueError(
                    f"compact=True is not defined for {self.strategy!r} "
                    "(only the cell schedules have empty work units to skip)")
            if not self.max_active or self.max_active < 1:
                raise ValueError(
                    "compact=True needs a positive static max_active bound "
                    "(plan(..., positions=...) measures one)")
        if self.layout in _NOT_PORTED["layout"]:
            raise _not_ported("layout", self.layout)
        if self.layout not in LAYOUT_NAMES:
            raise ValueError(
                f"unknown layout {self.layout!r}; have {LAYOUT_NAMES}")
        if self.layout == "packed":
            if self.strategy not in STRATEGY_NAMES:
                raise ValueError(
                    f'layout="packed" is not defined for {self.strategy!r}; '
                    f"packed strategies: {list(STRATEGY_NAMES)}")
            if not self.row_cap or self.row_cap < 1:
                raise ValueError(
                    'layout="packed" needs a positive static row_cap bound '
                    "(plan(..., positions=...) measures one)")
        object.__setattr__(self, "device", resolve_device(self.device))

    def execute(self, state: ParticleState
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (forces (N, 3), per-particle potential (N,)). Total potential
        energy is ``0.5 * potential.sum()`` (each pair counted twice)."""
        for name, t in state.tensors().items():
            if t.device != self.device:
                raise ValueError(
                    f"state.{name} is on {t.device}, the plan runs on "
                    f"{self.device}; move the state first")
        if self.strategy == "naive_n2":
            if state.valid is not None:
                raise ValueError(
                    "naive_n2 bypasses binning and cannot mask padded "
                    "(valid=) rows; use a cell schedule")
            fx, fy, fz, pot = S.naive_n2(self.domain, state.positions,
                                         self.kernel)
            return torch.stack([fx, fy, fz], dim=-1), pot
        bins = self.bin(state)
        if self.layout == "packed":
            return get_backend(self.backend, self.strategy, "packed")(
                self, self.pack(bins), state)
        return get_backend(self.backend, self.strategy)(self, bins, state)

    __call__ = execute

    def bin(self, state: ParticleState) -> CellBins:
        return bin_particles(self.domain, state.positions, state.fields,
                             m_c=self.m_c, valid=state.valid)

    def pack(self, bins: CellBins) -> PackedRows:
        return pack_rows(self.domain, bins, row_cap=self.row_cap)

    # -- the replan contract -------------------------------------------------

    def check_overflow(self, state: ParticleState) -> bool:
        """True if some static bound of this plan no longer covers these
        positions, so results computed anyway would drop interactions.
        Padding rows (``state.valid`` False) are excluded. See
        :meth:`replan` for the contract."""
        return self.overflow_class(state) is not None

    def overflow_class(self, state: ParticleState) -> Optional[str]:
        """Which static bound these positions breach, ``"m_c"``,
        ``"row_cap"`` or ``"max_active"`` (checked in that order), or None
        when every bound holds. One binning pass; waits for the device."""
        counts = cell_counts(self.domain, state.positions, state.valid)
        if int(counts.max()) > self.m_c:
            return "m_c"
        if self.layout == "packed":
            if int(padded_row_counts(self.domain, counts).max()) > \
                    self.row_cap:
                return "row_cap"
        if self.compact:
            if active_unit_count(self.domain, state.positions, self.strategy,
                                 counts=counts) > self.max_active:
                return "max_active"
        return None

    def replan(self, state: ParticleState, slack: float = 1.5,
               align: int = 8) -> "InteractionPlan":
        """A new plan whose static bounds cover ``state``.

        **The replan contract.** Every static bound follows one pattern:
        measure with slack, round up to ``align``, detect overflow, grow
        only what overflowed. The bounds and their probes:

        * ``m_c``: max particles per cell (``suggest_m_c``),
        * ``max_active``: active pencils of a compacted plan
          (``suggest_max_active``),
        * ``row_cap``: particles per padded pencil row of a
          ``layout="packed"`` plan (``suggest_row_cap``).

        An exceeded bound makes results silently drop interactions, so
        ``check_overflow`` detects it from one binning pass, and this method
        grows only the bound that overflowed, re-measured with slack and
        strictly past its old value. ``row_cap`` and ``max_active`` depend
        only on the positions, so they never move when ``m_c`` does.
        Padding rows (``state.valid`` False) are excluded from every
        measure."""
        counts = cell_counts(self.domain, state.positions, state.valid)
        m_c = self.m_c
        mx_cell = int(counts.max())
        if mx_cell > self.m_c:
            measured = -(-max(1, int(mx_cell * slack + 0.999)) // align
                         ) * align
            grow = -(-(self.m_c + 1) // align) * align   # aligned, > m_c
            m_c = max(measured, grow)
        row_cap = self.row_cap
        if self.layout == "packed":
            mx_row = int(padded_row_counts(self.domain, counts).max())
            if mx_row > row_cap:
                grow = -(-(row_cap + 1) // align) * align
                row_cap = max(suggest_row_cap(self.domain, state.positions,
                                              align=align, counts=counts),
                              grow)
        max_active = self.max_active
        if self.compact:
            n_act = active_unit_count(self.domain, state.positions,
                                      self.strategy, counts=counts)
            if n_act > max_active:
                max_active = max(suggest_max_active(
                    self.domain, state.positions, self.strategy, align=align,
                    counts=counts), n_act)
        return dataclasses.replace(self, m_c=m_c, max_active=max_active,
                                   row_cap=row_cap)

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
         strategy: str = "xpencil", backend: str = "cuda",
         batch_size: int = 64, device=None, compact: bool = False,
         max_active: Optional[int] = None, layout: str = "dense",
         row_cap: Optional[int] = None) -> InteractionPlan:
    """Build an :class:`InteractionPlan`.

    Every bound taken or measured here (``m_c``, ``max_active``,
    ``row_cap``) obeys the replan contract of :meth:`InteractionPlan.replan`.

    Args:
      domain: the cell grid.
      kernel: pair kernel (default Lennard-Jones).
      positions: representative positions; required when a bound is None.
      m_c: static max-particles-per-cell bound; measured from ``positions``
        with slack and rounded up to a multiple of 8 when omitted.
      strategy: ``"xpencil"`` or the ``"naive_n2"`` oracle.
      backend: ``"cuda"`` (hand-written kernels; their plain PyTorch
        versions on CPU tensors) or ``"reference"`` (plain PyTorch).
      device: ``None`` means the CUDA device, and raises when none is
        visible; ``"cpu"`` runs on the CPU.
      compact: occupancy-compacted execution: only the (z, y) pencils that
        hold particles are visited (kernel C, or kernel D over active rows).
      max_active: static active-pencil bound for ``compact=True``; measured
        from ``positions`` with slack when omitted.
      layout: ``"dense"`` (every cell owns ``m_c`` slots) or ``"packed"``
        (CSR pencil rows under ``row_cap``, kernel D). Composes with
        ``compact``; per-particle results equal the dense layout's.
      row_cap: static particles-per-packed-row bound for
        ``layout="packed"``; measured from ``positions`` with slack when
        omitted.
    """
    device = resolve_device(device)
    kernel = kernel or make_lennard_jones()
    if m_c is None:
        if positions is None:
            raise ValueError("plan() needs either m_c or positions "
                             "(to measure the M_C bound)")
        from .engine import suggest_m_c
        m_c = suggest_m_c(domain, positions)
    if layout == "packed" and strategy in STRATEGY_NAMES and row_cap is None:
        if positions is None:
            raise ValueError('layout="packed" needs either row_cap or '
                             "positions (to measure the packed-row bound)")
        row_cap = suggest_row_cap(domain, positions)
    if compact and strategy in STRATEGY_NAMES:
        if not supports_compact(backend, strategy, layout):
            raise ValueError(f"backend {backend!r} has no compacted path for "
                             f"strategy {strategy!r} (layout {layout!r})")
        if max_active is None:
            if positions is None:
                raise ValueError("compact=True needs either max_active or "
                                 "positions (to measure the active-pencil "
                                 "bound)")
            max_active = suggest_max_active(domain, positions, strategy)
    p = InteractionPlan(domain=domain, kernel=kernel, m_c=m_c,
                        strategy=strategy, backend=backend,
                        batch_size=batch_size, device=device,
                        compact=compact, max_active=max_active,
                        layout=layout, row_cap=row_cap)
    if strategy != "naive_n2":
        get_backend(backend, strategy, layout)        # fail at plan time
    return p


# --------------------------------------------------------------------------
# static-bound probes (one-off, outside the hot path; they wait for the
# device)
# --------------------------------------------------------------------------

def active_unit_count(domain: Domain, positions: torch.Tensor,
                      strategy: str = "xpencil",
                      counts: Optional[torch.Tensor] = None) -> int:
    """Number of (z, y) pencils holding at least one particle. Pass
    precomputed per-cell ``counts`` to skip the binning pass. The sub-box
    units of ``allin`` are not ported."""
    if strategy == "allin":
        raise _not_ported("strategy", "allin")
    if counts is None:
        counts = cell_counts(domain, positions)
    return int((pencil_counts(domain, counts) > 0).sum())


def n_units(domain: Domain, strategy: str = "xpencil") -> int:
    """Total pencils of a schedule (denominator of the fill fraction)."""
    if strategy == "allin":
        raise _not_ported("strategy", "allin")
    return domain.nz * domain.ny


def suggest_max_active(domain: Domain, positions: torch.Tensor,
                       strategy: str = "xpencil", slack: float = 1.25,
                       align: int = 8,
                       counts: Optional[torch.Tensor] = None) -> int:
    """Static ``max_active`` bound: active pencils with slack, rounded up to
    ``align``, clipped to the total pencil count."""
    n_act = active_unit_count(domain, positions, strategy, counts=counts)
    bound = max(1, int(n_act * slack + 0.999))
    bound = -(-bound // align) * align
    return min(bound, n_units(domain, strategy))


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


# --------------------------------------------------------------------------
# reference backend: the plain PyTorch schedules of core.strategies
# --------------------------------------------------------------------------

@register_backend("reference", "xpencil", compact=True)
def _ref_xpencil(p: InteractionPlan, bins: CellBins, state: ParticleState):
    if p.compact:
        occ = pencil_occupancy(p.domain, bins.counts, p.max_active)
        out = S.xpencil_sparse(p.domain, bins, p.kernel, occ,
                               batch_size=p.batch_size)
    else:
        out = S.xpencil(p.domain, bins, p.kernel, batch_size=p.batch_size)
    return dense_to_particles(p.domain, bins, *out)


@register_backend("reference", "xpencil", compact=True, layout="packed")
def _ref_xpencil_packed(p: InteractionPlan, packed: PackedRows,
                        state: ParticleState):
    """Packed rows; active-row iteration when the plan is compacted, every
    row otherwise."""
    occ = (pencil_occupancy(p.domain, packed.counts, p.max_active)
           if p.compact else full_pencil_occupancy(p.domain, p.device))
    out = S.xpencil_packed(p.domain, packed, p.kernel, occ,
                           batch_size=p.batch_size)
    return packed_to_particles(p.domain, packed, *out)
