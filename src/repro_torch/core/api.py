"""Plan/execute interaction API (minimal port of ``repro.core.api``).

    state = ParticleState(positions)
    p = plan(domain, kernel, positions=positions, strategy="xpencil")
    forces, potential = p.execute(state)

``plan`` runs on the CUDA device unless the caller passes ``device="cpu"``;
with no visible card it raises instead of falling back. On the CPU the
``"cuda"`` backend's kernel wrappers run their plain PyTorch versions,
because the tensors they are given lie on the CPU.

The backend registry maps ``(backend, strategy, layout)`` to one normalized
signature ``(plan, bins, state) -> (forces (N,3), pot (N,))``. It is the
port's own registry: the JAX package's registry is never touched. This slice
registers ``("reference", "xpencil", "dense")`` here and
``("cuda", "xpencil", "dense")`` in ``repro_torch.kernels``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from . import strategies as S
from .binning import CellBins, bin_particles, dense_to_particles
from .domain import Domain
from .interactions import PairKernel, make_lennard_jones

STRATEGY_NAMES = ("xpencil",)

# What the JAX package has and this port does not yet, with the ROADMAP.md
# Queue 1 item that ports it. Asking for one raises; nothing runs instead.
_NOT_PORTED = {
    "strategy": {"par_part": 2, "cell_dense": 2, "allin": 7, "auto": 8,
                 "autotune": 8},
    "backend": {"halo": 11},
    "layout": {"packed": 5, "sfc": 6},
    "compact": {True: 4},
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


def register_backend(backend: str, strategy: str, layout: str = "dense"):
    """Register an implementation under ``(backend, strategy, layout)``."""

    def deco(fn: Callable) -> Callable:
        _BACKENDS[(backend, strategy, layout)] = fn
        return fn
    return deco


def get_backend(backend: str, strategy: str,
                layout: str = "dense") -> Callable:
    if backend == "cuda":
        import repro_torch.kernels  # noqa: F401  (registers on import)
    fn = _BACKENDS.get((backend, strategy, layout))
    if fn is None:
        raise ValueError(
            f"no backend {backend!r} for strategy {strategy!r} with layout "
            f"{layout!r}; registered: {sorted(_BACKENDS)}")
    return fn


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


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
        object.__setattr__(self, "device", _resolve_device(self.device))

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
        return get_backend(self.backend, self.strategy)(self, bins, state)

    __call__ = execute

    def bin(self, state: ParticleState) -> CellBins:
        return bin_particles(self.domain, state.positions, state.fields,
                             m_c=self.m_c, valid=state.valid)


def plan(domain: Domain, kernel: Optional[PairKernel] = None, *,
         positions: Optional[torch.Tensor] = None, m_c: Optional[int] = None,
         strategy: str = "xpencil", backend: str = "cuda",
         batch_size: int = 64, device=None, compact: bool = False,
         layout: str = "dense") -> InteractionPlan:
    """Build an :class:`InteractionPlan`.

    Args:
      domain: the cell grid.
      kernel: pair kernel (default Lennard-Jones).
      positions: representative positions; required when ``m_c`` is None.
      m_c: static max-particles-per-cell bound; measured from ``positions``
        with slack and rounded up to a multiple of 8 when omitted.
      strategy: ``"xpencil"`` or the ``"naive_n2"`` oracle.
      backend: ``"cuda"`` (hand-written kernels; their plain PyTorch
        versions on CPU tensors) or ``"reference"`` (plain PyTorch).
      device: ``None`` means the CUDA device, and raises when none is
        visible; ``"cpu"`` runs on the CPU.
      compact, layout: kept for the JAX package's signature; only the
        defaults are ported.
    """
    if device is None:
        device = "cuda"
    if compact:
        raise _not_ported("compact", True)
    if layout != "dense":
        if layout in _NOT_PORTED["layout"]:
            raise _not_ported("layout", layout)
        raise ValueError(f"unknown layout {layout!r}")
    kernel = kernel or make_lennard_jones()
    if m_c is None:
        if positions is None:
            raise ValueError("plan() needs either m_c or positions "
                             "(to measure the M_C bound)")
        from .engine import suggest_m_c
        m_c = suggest_m_c(domain, positions)
    p = InteractionPlan(domain=domain, kernel=kernel, m_c=m_c,
                        strategy=strategy, backend=backend,
                        batch_size=batch_size, device=device)
    if strategy != "naive_n2":
        get_backend(backend, strategy)        # fail at plan time
    return p


# --------------------------------------------------------------------------
# reference backend: the plain PyTorch schedules of core.strategies
# --------------------------------------------------------------------------

@register_backend("reference", "xpencil")
def _ref_xpencil(p: InteractionPlan, bins: CellBins, state: ParticleState):
    out = S.xpencil(p.domain, bins, p.kernel, batch_size=p.batch_size)
    return dense_to_particles(p.domain, bins, *out)
