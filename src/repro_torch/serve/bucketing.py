"""Shape-class bucketing (port of ``repro.serve.bucketing``).

An incoming request carries an arbitrary ``(N, domain, kernel, fields)``.
Each is normalized onto a :class:`ShapeClass`:

* ``n_cap``: N rounded **up** to a power of two, floored at ``MIN_N_CAP``
  so tiny requests share one class. Rows past the real N are padding:
  positions zero, fields zero, ``ParticleState.valid`` False. Binning
  gives them weight 0, so padded execution is bit-identical to unpadded.
* the domain grid (cells and box): binning shapes depend on it.
* the kernel identity digest (``autotune._kernel_id``), value-based, so
  two kernels that share a name but differ in FLOPs or parameters never
  share a class (or its cached executor).
* the sorted field names: the executor cache is keyed by them.

Batches are padded the same way on the leading axis: B live requests are
stacked and topped up to ``quantize_batch(B)`` systems that are padding
throughout, so a class sees a handful of ``(B_cap, n_cap)`` shapes. A
system that is all padding bins to nothing and its kernel sees no pair.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.api import ParticleState
from ..core.autotune import _kernel_id
from ..core.domain import Domain
from ..core.interactions import PairKernel

__all__ = ["MIN_N_CAP", "ShapeClass", "classify", "pad_state",
           "quantize_batch", "quantize_n", "stack_states", "split_batch"]

# Smallest particle cap a class may quantize to: the long tail of tiny
# requests (N = 3, 7, 12, ...) shares ONE class, whose padding costs less
# than another class's plan and executor.
MIN_N_CAP = 64


def _next_pow2(n: int) -> int:
    if n < 1:
        raise ValueError(f"need a positive size, got {n}")
    return 1 << (n - 1).bit_length()


def quantize_n(n: int, min_cap: int = MIN_N_CAP) -> int:
    """Particle cap for a request of N rows: the next power of two, floored
    at ``min_cap``, so padding stays below 2x."""
    return max(int(min_cap), _next_pow2(int(n)))


def quantize_batch(b: int, max_batch: int) -> int:
    """Batch slots for b live requests: the next power of two, capped at
    ``max_batch``."""
    if b < 1:
        raise ValueError(f"need a positive batch, got {b}")
    return min(_next_pow2(int(b)), int(max_batch))


@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """The bucketing key. Two requests in one class share one padded shape,
    one plan and one executor."""

    domain: Domain
    kernel_id: str
    n_cap: int
    field_names: Tuple[str, ...]

    def label(self) -> str:
        nx, ny, nz = self.domain.ncells
        fields = ",".join(self.field_names) or "-"
        return f"{nx}x{ny}x{nz}/n{self.n_cap}/{self.kernel_id}/{fields}"


def classify(domain: Domain, kernel: PairKernel, n: int,
             field_names: Sequence[str],
             min_cap: int = MIN_N_CAP) -> ShapeClass:
    """The ShapeClass a request of ``n`` particles lands in."""
    return ShapeClass(domain=domain, kernel_id=_kernel_id(kernel),
                      n_cap=quantize_n(n, min_cap),
                      field_names=tuple(sorted(field_names)))


def pad_state(state: ParticleState, n_cap: int) -> ParticleState:
    """One request's state padded to ``n_cap`` rows of masked zeros, on the
    state's device. Zero positions are safe only because the mask keeps
    them out of binning. Real rows keep their values bit for bit; an
    existing ``valid`` mask is honoured and extended."""
    n = state.positions.shape[0]
    if n > n_cap:
        raise ValueError(f"state has {n} rows, class cap is {n_cap}")
    if n == n_cap and state.valid is not None:
        return state
    pad = n_cap - n
    base_valid = (state.valid if state.valid is not None else
                  torch.ones((n,), dtype=torch.bool,
                             device=state.positions.device))
    pad_rows = torch.nn.functional.pad
    return ParticleState(
        positions=pad_rows(state.positions, (0, 0, 0, pad)),
        fields={k: pad_rows(v, (0, pad)) for k, v in state.fields.items()},
        valid=pad_rows(base_valid, (0, pad)))          # pads with False


def stack_states(states: Sequence[ParticleState], n_cap: int,
                 b_cap: Optional[int] = None,
                 device=None) -> ParticleState:
    """The padded batch of ``execute_batch``: positions ``(B_cap, n_cap,
    3)``, fields and ``valid`` ``(B_cap, n_cap)``; systems past the live
    requests are padding throughout (an all-False ``valid``).

    The batch is filled where the requests lie and then moved to
    ``device`` (default: where they lie) in one copy a tensor, not one a
    request."""
    if not states:
        raise ValueError("cannot stack an empty batch")
    b_cap = len(states) if b_cap is None else int(b_cap)
    if b_cap < len(states):
        raise ValueError(f"{len(states)} states exceed batch cap {b_cap}")
    names = {tuple(sorted(s.fields)) for s in states}
    if len(names) != 1:
        raise ValueError(f"mixed field sets in one batch: {sorted(names)}")
    first = states[0]
    src = first.positions.device
    pos = first.positions.new_zeros((b_cap, n_cap, 3))
    fields = {k: v.new_zeros((b_cap, n_cap)) for k, v in first.fields.items()}
    valid = torch.zeros((b_cap, n_cap), dtype=torch.bool, device=src)
    for i, s in enumerate(states):
        n = s.positions.shape[0]
        if n > n_cap:
            raise ValueError(f"state has {n} rows, class cap is {n_cap}")
        pos[i, :n] = s.positions
        for k, v in s.fields.items():
            fields[k][i, :n] = v
        valid[i, :n] = True if s.valid is None else s.valid
    out = ParticleState(pos, fields, valid)
    if device is None or torch.device(device) == src:
        return out
    return ParticleState(pos.to(device),
                         {k: v.to(device) for k, v in fields.items()},
                         valid.to(device))


def split_batch(forces: torch.Tensor, potential: torch.Tensor,
                sizes: Sequence[int]
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``execute_batch`` outputs back into per-request results, each
    trimmed to its request's true N (padding rows and systems dropped)."""
    return [(forces[i, :n], potential[i, :n]) for i, n in enumerate(sizes)]
