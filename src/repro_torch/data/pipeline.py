"""Deterministic synthetic token pipeline (port of ``repro.data.pipeline``).

The properties JAX's pipeline promises hold here too: deterministic under
restart (the cursor lives in the checkpoint), each data-parallel host
reads only its slice, and any step is addressable in O(1) with no I/O,
which is what makes the bitwise restart test possible. The batch of
(``stream_id``, ``step``, ``host_index``) comes from a ``torch.Generator``
seeded by a counter-based hash of those three numbers (splitmix64), so no
state carries from one step to the next.

The port does not reproduce ``jax.random``'s threefry bits: tests that
compare the two packages feed both the same numpy batch. The tokens are
drawn on a CPU generator and then copied to the batch's device, so the
stream is the same on every device: a run started on the card and resumed
on the CPU (or the other way round) trains on the same tokens. Loss curves on this data are meaningless
language-wise but exactly reproducible.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import torch

from ..core._device import resolve_device

Tensor = torch.Tensor
_MASK = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    stream_id: int = 0


@dataclasses.dataclass
class DataState:
    """Checkpointable cursor."""
    step: int = 0

    def to_dict(self):
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]))


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def _stream_seed(stream_id: int, step: int, host_index: int) -> int:
    """The generator seed of one host's slice of one step."""
    return _splitmix64(_splitmix64(_splitmix64(stream_id) ^ step)
                       ^ host_index)


def batch_at(cfg: DataConfig, step: int, host_index: int = 0,
             n_hosts: int = 1, device=None) -> Tuple[Tensor, Tensor]:
    """(tokens, labels), int32 (B / n_hosts, seq_len) on ``device``
    (default: the CUDA card), for this host's slice of global step
    ``step``; labels are the tokens shifted by one."""
    if n_hosts < 1 or cfg.global_batch % n_hosts:
        raise ValueError(f"global_batch {cfg.global_batch} does not split "
                         f"over {n_hosts} hosts")
    dev = resolve_device(device)
    gen = torch.Generator()
    gen.manual_seed(_stream_seed(cfg.stream_id, step, host_index))
    toks = torch.randint(0, cfg.vocab_size,
                         (cfg.global_batch // n_hosts, cfg.seq_len + 1),
                         generator=gen, dtype=torch.int32).to(dev)
    return toks[:, :-1], toks[:, 1:]


class Pipeline:
    """Stateful iterator facade over ``batch_at`` with a checkpointable
    cursor."""

    def __init__(self, cfg: DataConfig, state: DataState | None = None,
                 host_index: int = 0, n_hosts: int = 1, device=None):
        self.cfg = cfg
        self.state = state or DataState()
        self.host_index = host_index
        self.n_hosts = n_hosts
        self.device = resolve_device(device)

    def __iter__(self) -> Iterator[Tuple[Tensor, Tensor]]:
        return self

    def __next__(self):
        b = batch_at(self.cfg, self.state.step, self.host_index,
                     self.n_hosts, self.device)
        self.state.step += 1
        return b
