"""Measured autotuner (port of ``repro.core.autotune``): pick schedules by
stopwatch, not by model.

The paper's central finding is that the winning schedule (X-pencil vs
All-in-SM vs Par-Part) depends on hardware and fill ratio in ways an
analytical model cannot fully predict — its own Fig. 6/7 results had to be
*measured* on three GPUs. ``strategy="auto"`` trusts the ``core.traffic``
HBM-bytes model alone; ``strategy="autotune"`` (this module) uses the model
only to *prune* the candidate space, then times the survivors with the
warm-up-excluded stopwatch of ``core.timing`` and returns the empirically
fastest plan.

    result = tune(domain, kernel, positions)        # enumerate -> prune ->
    forces, pot = result.plan.execute(state)        #   time -> pick winner

or through the front door::

    p = plan(domain, kernel, positions=pos, strategy="autotune")

Winners persist in an on-disk JSON cache keyed by (platform and device
name, device count, grid shape, m_c, ppc bucket, occupancy bucket, kernel
identity, backends, candidate-space digest), so re-tuning the same regime
costs one dict lookup and zero timing runs. Point
``REPRO_TORCH_AUTOTUNE_CACHE`` at a directory to relocate the cache
(default ``~/.cache/repro_torch_autotune``); delete the file to
invalidate. The JAX package's tuner keeps its own cache: neither reads the
other's entries.

Errors are not caught. A ``"cuda"`` candidate that its kernel would refuse
(``m_c`` past kernels B/C's ``MAX_M_C``, a packed ``row_cap`` past kernel
D's ``MAX_ROW_CAP``, a kernel E halo block or a kernel F warp past a
block's shared memory, a pair kernel without a CUDA form) is dropped
before timing; any error while a kept candidate is built or timed
propagates, and so does a failing audit of a pruned candidate or a cache
file that does not parse.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import os
import pathlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from . import strategies as S
from . import traffic
from .api import (CELL_SCHEDULES, InteractionPlan, ParticleState,
                  STRATEGY_NAMES, _allin_box, active_unit_count, n_units,
                  suggest_max_active, suggest_pair_cap, suggest_row_cap,
                  supports_compact, supports_layout)
from .binning import (DEFAULT_CSIZE, cell_counts, padded_row_counts,
                      sfc_pair_count, shard_pencil_active, shard_slab_counts)
from .domain import Domain, slab_domain
from .interactions import PairKernel, make_lennard_jones
from .timing import time_fn
from ..obs import metrics as _obs_metrics
from ..obs.trace import event as _obs_event, trace as _obs_trace

# Bump when the candidate space or cache schema changes: stale entries from
# an older tuner are skipped (and overwritten), not misread.
# v1: the JAX package's v5 space (dense, compact, packed and sfc axes) with
#     the "cuda" backend, without the halo shard-count axis.
# v2: the halo shard-count axis (Candidate.n_shards/shard_cap); the key's
#     device count is the tuner's (1 on the CPU), as JAX's.
CACHE_VERSION = 2

_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_CACHE_FILE = "autotune_cache.json"

DEFAULT_BATCH_SIZES = (32, 64, 128)
DEFAULT_TOP_K = 8

# Re-tune accounting: one bump per candidate actually timed with the
# stopwatch (cache hits bump nothing), in the port's metrics registry.
TIMING_RUNS_TOTAL = "repro_torch_autotune_timing_runs_total"
CACHE_TOTAL = "repro_torch_autotune_cache_total"


def timing_run_count() -> int:
    """Stopwatch candidate timings so far (0 across pure cache hits)."""
    return int(_obs_metrics.registry.total(TIMING_RUNS_TOTAL))


def reset_timing_runs() -> None:
    _obs_metrics.registry.reset(TIMING_RUNS_TOTAL)


# --------------------------------------------------------------------------
# candidates
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the tuning space — exactly the static knobs of a plan."""

    strategy: str
    backend: str
    batch_size: int
    m_c: int
    box: Optional[Tuple[int, int, int]] = None   # allin sub-box
    compact: bool = False                        # occupancy-compacted path
    max_active: Optional[int] = None             # static active-unit bound
    n_shards: Optional[int] = None               # halo Z-slabs (None = 1)
    shard_cap: Optional[int] = None              # halo per-shard capacity
    layout: str = "dense"                        # layout: dense|packed|sfc
    row_cap: Optional[int] = None                # static packed-row bound
    pair_cap: Optional[int] = None               # static sfc pair-list bound

    @property
    def distributed(self) -> bool:
        return bool(self.n_shards) and self.n_shards > 1

    def plan(self, domain: Domain, kernel: PairKernel,
             device=None) -> InteractionPlan:
        if self.distributed:
            # the candidate's backend is the per-shard backend; the allin
            # slab tiling is recomputed by the plan for this shard count
            return InteractionPlan(
                domain=domain, kernel=kernel, m_c=self.m_c,
                strategy=self.strategy, backend="halo",
                halo_inner=self.backend, batch_size=self.batch_size,
                device=device, box=None, compact=self.compact,
                max_active=self.max_active, layout=self.layout,
                row_cap=self.row_cap, pair_cap=self.pair_cap,
                n_shards=self.n_shards, shard_cap=self.shard_cap)
        return InteractionPlan(domain=domain, kernel=kernel, m_c=self.m_c,
                               strategy=self.strategy, backend=self.backend,
                               batch_size=self.batch_size, device=device,
                               box=self.box, compact=self.compact,
                               max_active=self.max_active,
                               layout=self.layout, row_cap=self.row_cap,
                               pair_cap=self.pair_cap)

    def to_json(self) -> dict:
        return {"strategy": self.strategy, "backend": self.backend,
                "batch_size": self.batch_size, "m_c": self.m_c,
                "box": list(self.box) if self.box else None,
                "compact": self.compact, "max_active": self.max_active,
                "n_shards": self.n_shards, "shard_cap": self.shard_cap,
                "layout": self.layout, "row_cap": self.row_cap,
                "pair_cap": self.pair_cap}

    @classmethod
    def from_json(cls, d: dict) -> "Candidate":
        def opt(key):
            return int(d[key]) if d.get(key) else None
        return cls(strategy=d["strategy"], backend=d["backend"],
                   batch_size=int(d["batch_size"]), m_c=int(d["m_c"]),
                   box=tuple(d["box"]) if d.get("box") else None,
                   compact=bool(d.get("compact", False)),
                   max_active=opt("max_active"), n_shards=opt("n_shards"),
                   shard_cap=opt("shard_cap"),
                   layout=d.get("layout", "dense"), row_cap=opt("row_cap"),
                   pair_cap=opt("pair_cap"))


def enumerate_candidates(domain: Domain, m_c_choices: Sequence[int], *,
                         backends: Sequence[str] = ("reference",),
                         batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
                         strategies: Sequence[str] = STRATEGY_NAMES,
                         extra_allin_boxes: Sequence[Tuple[int, int, int]]
                         = ()) -> List[Candidate]:
    """The candidate space: (strategy, backend, batch_size, m_c, allin box).

    Only (backend, strategy) pairs registered in the dense layout survive
    — the tuner can never return an unimplemented combination
    (``naive_n2`` is the one registry-free strategy: the executor
    special-cases it, so it is emitted whenever explicitly requested, once
    per ``m_c``). ``batch_size`` is a reference-schedule knob (the CUDA
    kernels ignore it), so ``"cuda"`` candidates are emitted once per
    remaining axis, pinned to ``min(batch_sizes)``, so the candidate space
    — and the cache key derived from it — does not depend on the order
    callers list batch sizes in.
    """
    out: List[Candidate] = []
    canon_bs = min(batch_sizes)
    for backend in backends:
        for strategy in strategies:
            if strategy == "naive_n2":
                if backend != backends[0]:
                    continue
                bss: Sequence[int] = (canon_bs,)
            else:
                if not supports_layout(backend, strategy, "dense"):
                    continue
                bss = batch_sizes if backend == "reference" else (canon_bs,)
            for m_c in dict.fromkeys(m_c_choices):
                boxes: Iterable[Optional[Tuple[int, int, int]]] = (None,)
                if strategy == "allin":
                    boxes = _allin_boxes(domain, m_c, extra_allin_boxes)
                for box in boxes:
                    for bs in dict.fromkeys(bss):
                        out.append(Candidate(strategy, backend, bs, m_c, box))
    return out


def _allin_boxes(domain: Domain, m_c: int,
                 extra: Sequence[Tuple[int, int, int]] = ()
                 ) -> List[Tuple[int, int, int]]:
    """Shared-memory-budget sub-box plus a small-box alternative (more
    parallelism, less reuse — the trade the paper's §5.1 occupancy
    discussion is about); user-supplied boxes are shrunk to valid grid
    divisors and appended."""
    boxes = [_allin_box(domain, m_c),
             S.shrink_to_divisors(domain, (2, 2, 2))]
    boxes += [S.shrink_to_divisors(domain, tuple(b)) for b in extra]
    return list(dict.fromkeys(boxes))


def _cost(domain: Domain, avg_ppc: float, c: Candidate,
          fill_for=None) -> float:
    fill = fill_for(c) if (fill_for is not None and c.compact) else 1.0
    return traffic.candidate_cost(domain, c.m_c, avg_ppc, c.strategy,
                                  subbox=c.box, compact=c.compact,
                                  fill=fill, layout=c.layout)


def _audit_pruned(domain: Domain, counts: torch.Tensor,
                  pruned: Sequence[Candidate], avg_ppc: float,
                  fill_for) -> None:
    """Model-vs-measured audit of every prune decision (``obs.audit``).

    Records the "model drift" gauge for each pruned candidate — the exact
    modelled cost that pruned it vs the measured bytes/interaction from the
    real occupancy — so a wrong prune is visible in the registry instead of
    lost. Deduplicated on the model's own inputs (batch-size and backend
    variants share one score). An audit that fails fails the tune."""
    from ..obs.audit import audit_candidate
    seen = set()
    for c in pruned:
        key = (c.strategy, c.layout, c.compact, c.m_c, c.box)
        if key in seen:
            continue
        seen.add(key)
        audit_candidate(domain, strategy=c.strategy, m_c=c.m_c,
                        layout=c.layout, compact=c.compact, subbox=c.box,
                        counts=counts,
                        modelled=_cost(domain, avg_ppc, c, fill_for))


def compact_twins(domain: Domain, positions: torch.Tensor,
                  candidates: Sequence[Candidate], *, slack: float = 1.25,
                  align: int = 8) -> List[Candidate]:
    """The dense-vs-compact candidate axis: for every candidate whose
    (backend, strategy) implements the occupancy-compacted path, a twin
    with ``compact=True`` and a ``max_active`` bound measured from
    ``positions`` (the same slack-plus-alignment contract as ``m_c``)."""
    twins: List[Candidate] = []
    bounds: Dict[Tuple, int] = {}
    for c in candidates:
        if c.compact or not supports_compact(c.backend, c.strategy):
            continue
        key = ("box", c.box) if c.strategy == "allin" else ("pencil",)
        if key not in bounds:
            bounds[key] = suggest_max_active(
                domain, positions, c.strategy, box=c.box,
                slack=slack, align=align)
        twins.append(dataclasses.replace(c, compact=True,
                                         max_active=bounds[key]))
    return list(dict.fromkeys(twins))


def packed_twins(domain: Domain, positions: torch.Tensor,
                 candidates: Sequence[Candidate], *, slack: float = 1.25,
                 align: int = 8) -> List[Candidate]:
    """The dense-vs-packed layout axis: for every candidate whose
    (backend, strategy) implements the packed-row layout, a twin with
    ``layout="packed"`` and a ``row_cap`` bound measured from
    ``positions`` (the same slack-plus-alignment contract as ``m_c``).
    Applied after :func:`compact_twins`, so compacted candidates get
    packed twins too — the two axes compose."""
    twins: List[Candidate] = []
    bound: Optional[int] = None
    for c in candidates:
        if (c.layout != "dense"
                or not supports_layout(c.backend, c.strategy, "packed")):
            continue
        if c.compact and not supports_compact(c.backend, c.strategy,
                                              "packed"):
            continue
        if bound is None:
            bound = suggest_row_cap(domain, positions, slack=slack,
                                    align=align)
        twins.append(dataclasses.replace(c, layout="packed", row_cap=bound))
    return list(dict.fromkeys(twins))


def sfc_twins(domain: Domain, positions: torch.Tensor,
              candidates: Sequence[Candidate], *, slack: float = 1.25,
              align: int = 8) -> List[Candidate]:
    """The SFC cluster-layout axis: for every candidate whose
    (backend, strategy) implements the compressed cluster-pair list, a
    twin with ``layout="sfc"`` and a ``pair_cap`` bound measured from
    ``positions`` (the same slack-plus-alignment contract as ``m_c`` /
    ``row_cap``). Only dense candidates get a twin: the pair list *is* the
    compaction, so a compact twin would be redundant.

    As in the JAX package, a twin needs a dense ``(backend,
    "cell_dense")`` candidate to start from. ``"cuda"`` runs
    ``cell_dense`` only in the sfc layout, so it has no such candidate,
    and kernel F is tuned only through ``"reference"``."""
    twins: List[Candidate] = []
    bound: Optional[int] = None
    for c in candidates:
        if (c.layout != "dense" or c.compact or c.distributed
                or not supports_layout(c.backend, c.strategy, "sfc")):
            continue
        if bound is None:
            bound = suggest_pair_cap(domain, positions, slack=slack,
                                     align=align)
        twins.append(dataclasses.replace(c, layout="sfc", pair_cap=bound))
    return list(dict.fromkeys(twins))


def halo_twins(domain: Domain, positions: torch.Tensor,
               candidates: Sequence[Candidate],
               shard_counts: Sequence[int], *,
               cap_slack: float = 1.3, align: int = 8) -> List[Candidate]:
    """The shard-count candidate axis: for every cell-schedule candidate, a
    distributed twin per viable shard count, ``backend="halo"`` with the
    candidate's backend as the per-shard inner, a ``shard_cap`` measured
    from ``positions`` (the ``m_c`` contract again), and compacted twins
    re-bounded to the busiest shard's active pencils. Shard counts that do
    not divide ``nz`` are skipped. A twin stacks its shards on the plan's
    device (``mesh=None``), so unlike JAX's no count is limited by the
    visible devices: the JAX package's twins with every count's devices
    present."""
    from ..dist.halo import suggest_shard_cap, suggest_shard_max_active
    twins: List[Candidate] = []
    caps: Dict[int, int] = {}
    bounds: Dict[int, int] = {}
    for ns in dict.fromkeys(shard_counts):
        if ns < 2 or domain.nz % ns:
            continue
        caps[ns] = suggest_shard_cap(domain, positions, ns,
                                     slack=cap_slack, align=align)
        for c in candidates:
            if c.distributed or c.strategy not in CELL_SCHEDULES:
                continue
            if c.compact and c.strategy == "allin":
                continue                 # no per-slab sub-box occupancy
            max_active = c.max_active
            if c.compact:
                if ns not in bounds:
                    bounds[ns] = suggest_shard_max_active(
                        domain, positions, ns, align=align)
                max_active = bounds[ns]
            twins.append(dataclasses.replace(
                c, n_shards=ns, shard_cap=caps[ns], box=None,
                max_active=max_active))
    return list(dict.fromkeys(twins))


def prune_candidates(domain: Domain, avg_ppc: float,
                     candidates: Sequence[Candidate],
                     top_k: int = DEFAULT_TOP_K,
                     fill_for=None
                     ) -> Tuple[List[Candidate], List[Candidate]]:
    """Model-guided pruning to ``top_k`` candidates. -> (kept, pruned).

    The ``traffic.candidate_cost`` ranking orders candidates *within* each
    strategy, and strategies are then drained round-robin (cheapest
    strategy first). The model therefore shapes the field but can never
    eliminate a whole strategy by itself — its cost is identical across
    batch-size variants, so a straight global sort would fill ``top_k``
    with duplicates of its favourite schedule and the stopwatch would
    never get to contradict it (the exact failure this tuner exists for).
    Dense and compacted variants of a strategy form separate round-robin
    queues for the same reason, and so do packed- and sfc-layout variants
    (whose gather/expand overhead the byte model does not see) and halo
    variants per shard count, whose exchange the model does not see at
    all.

    ``fill_for``: optional ``Candidate -> fill fraction`` hook used to
    score compacted candidates (measured occupancy; default 1.0).
    """
    def order_key(c: Candidate):
        return (_cost(domain, avg_ppc, c, fill_for), c.backend,
                c.batch_size, c.m_c, c.box or (), c.compact,
                c.n_shards or 1, c.layout)

    by_strategy: Dict[Tuple[str, bool, int, str], List[Candidate]] = {}
    for c in sorted(candidates, key=order_key):
        by_strategy.setdefault(
            (c.strategy, c.compact, c.n_shards or 1, c.layout),
            []).append(c)
    queues = sorted(by_strategy.values(),
                    key=lambda q: order_key(q[0]))
    interleaved = [c for round_ in itertools.zip_longest(*queues)
                   for c in round_ if c is not None]
    k = max(1, int(top_k))
    return interleaved[:k], interleaved[k:]


def kernel_refuses(c: Candidate, kernel: PairKernel,
                   domain: Domain) -> Optional[str]:
    """Why the ``"cuda"`` kernel of candidate ``c`` would refuse it, by the
    wrappers' own limits, or None when it runs (and for every
    ``"reference"`` candidate, which has no such limit)."""
    if c.backend != "cuda" or c.strategy == "naive_n2":
        return None
    from ..kernels._common import MAX_SMEM
    from ..kernels.allin import halo_bytes
    from ..kernels.sfc import sfc_warp_smem_bytes
    from ..kernels.xpencil import MAX_M_C, MAX_ROW_CAP
    if kernel.cuda is None:
        return f"pair kernel {kernel.name!r} has no CUDA form"
    if c.strategy == "xpencil" and c.layout == "packed":
        if c.row_cap > MAX_ROW_CAP:
            return f"row_cap {c.row_cap} > kernel D's {MAX_ROW_CAP}"
    elif c.strategy == "xpencil":
        if c.m_c > MAX_M_C:
            return f"m_c {c.m_c} > kernels B/C's {MAX_M_C}"
    elif c.strategy == "allin":
        # a distributed twin tiles the slab each shard runs on
        bdom = slab_domain(domain, c.n_shards) if c.distributed else domain
        smem = halo_bytes(c.box or _allin_box(bdom, c.m_c), c.m_c)
        if smem > MAX_SMEM:
            return (f"kernel E's halo block of {c.box} at m_c {c.m_c} takes "
                    f"{smem} B of shared memory > {MAX_SMEM}")
    elif c.strategy == "cell_dense" and c.layout == "sfc":
        smem = sfc_warp_smem_bytes(DEFAULT_CSIZE, c.m_c)
        if smem > MAX_SMEM:
            return (f"kernel F's warp at m_c {c.m_c} takes {smem} B of "
                    f"shared memory > {MAX_SMEM}")
    return None


# --------------------------------------------------------------------------
# on-disk cache
# --------------------------------------------------------------------------

def cache_dir() -> pathlib.Path:
    env = os.environ.get(_CACHE_ENV)
    if env:
        return pathlib.Path(env)
    xdg = os.environ.get("XDG_CACHE_HOME",
                         os.path.join(os.path.expanduser("~"), ".cache"))
    return pathlib.Path(xdg) / "repro_torch_autotune"


def cache_path() -> pathlib.Path:
    return cache_dir() / _CACHE_FILE


def ppc_bucket(avg_ppc: float) -> str:
    """Log2 fill-ratio bucket: nearby fill ratios share a tuning decision
    (the paper's regimes — 1, 10, 100 ppc — land in distinct buckets)."""
    return f"2^{round(math.log2(max(avg_ppc, 0.125)))}"


def occupancy_bucket(fill: float) -> str:
    """Log2 active-pencil-fill bucket for the cache key.

    Mean ppc alone cannot distinguish a uniform gas from a tight blob with
    the same particle count — but those two regimes have different winners
    (compact wins the blob, dense the gas). Bucketing the measured fill
    fraction keeps their cached decisions separate while nearby fills
    share one."""
    return f"occ2^{round(math.log2(min(max(fill, 1.0 / 4096.0), 1.0)))}"


def _kernel_id(kernel: PairKernel) -> str:
    """Stable kernel identity for the disk cache: name plus a digest of the
    value-based identity tuple ``(name, flops, static_params)`` (PairKernel's
    own hash contract), so two kernels sharing a name but differing in FLOPs
    or parameters never share a cached winner. ``hash()`` itself is unusable
    here — Python randomizes string hashes per process."""
    ident = repr((kernel.name, kernel.flops, kernel.static_params))
    return f"{kernel.name}-{hashlib.sha1(ident.encode()).hexdigest()[:10]}"


def platform_of(device: torch.device) -> str:
    """The cache key's platform: ``"cuda:<device name>"`` on a card (a
    winner timed on one card model must not answer for another), else
    ``"cpu"``."""
    if device.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(device)
    return "cpu"


def cache_key(platform: str, domain: Domain, m_c: int, avg_ppc: float,
              kernel: PairKernel, backends: Sequence[str],
              pencil_fill: float = 1.0,
              device_count: Optional[int] = None) -> str:
    """The visible device count is part of the key, as in the JAX
    package (default ``torch.cuda.device_count()``)."""
    if device_count is None:
        device_count = torch.cuda.device_count()
    return "|".join([
        platform,
        f"dev{device_count}",
        "x".join(str(n) for n in domain.ncells),
        f"mc{m_c}",
        f"ppc{ppc_bucket(avg_ppc)}",
        occupancy_bucket(pencil_fill),
        _kernel_id(kernel),
        "+".join(sorted(backends)),
    ])


def _space_id(candidates: Sequence[Candidate]) -> str:
    """Order-independent digest of a candidate space."""
    blob = "\n".join(sorted(json.dumps(c.to_json(), sort_keys=True)
                            for c in candidates))
    return hashlib.sha1(blob.encode()).hexdigest()[:10]


class _NamesFile:
    """Re-raises a ``ValueError`` from inside the block as one that names
    ``path``; nothing is swallowed."""

    def __init__(self, path: pathlib.Path):
        self.path = path

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and issubclass(exc_type, ValueError):
            raise ValueError(
                f"autotune cache file {self.path} does not parse ({exc}); "
                "delete it to re-tune") from exc
        return False


def _load_cache(path: pathlib.Path) -> dict:
    """The cache file's entries; ``{}`` when there is no file. The file is
    only ever replaced whole (:func:`_store_cache`), so one that does not
    parse was edited from outside, and raises."""
    if not path.exists():
        return {}
    with _NamesFile(path):
        data = json.loads(path.read_text())
        if not isinstance(data, dict):
            raise ValueError(f"a {type(data).__name__}, not an object")
    return data


def _store_cache(path: pathlib.Path, key: str, entry: dict) -> None:
    """Merge one entry into the cache file.

    The tmp file is per-process and the final ``os.replace`` is atomic, so
    readers never see a truncated JSON. Two processes storing
    *concurrently* can still lose one another's new entry (last rename
    wins) — an acceptable cost for a cache whose entries are all
    re-derivable by re-tuning."""
    path.parent.mkdir(parents=True, exist_ok=True)
    data = _load_cache(path)
    data[key] = entry
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(data, indent=1, sort_keys=True))
    os.replace(tmp, path)


# --------------------------------------------------------------------------
# the tuner
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TuneResult:
    """Winner plan plus the evidence: what was timed, what was pruned."""

    plan: InteractionPlan
    candidate: Candidate
    timings: Dict[Candidate, float]          # measured mean seconds
    reps: Dict[Candidate, int]               # stopwatch reps per candidate
    pruned: Tuple[Candidate, ...]            # enumerated but never timed
    cache_hit: bool
    cache_file: str
    infeasible: Tuple[Candidate, ...] = ()   # refused by their kernel


def tune(domain: Domain, kernel: Optional[PairKernel] = None,
         positions: Optional[torch.Tensor] = None, *,
         m_c: Optional[int] = None,
         backends: Optional[Sequence[str]] = None,
         batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
         strategies: Sequence[str] = STRATEGY_NAMES,
         box: Optional[Tuple[int, int, int]] = None,
         candidates: Optional[Sequence[Candidate]] = None,
         m_c_slack: float = 1.5,
         include_compact: bool = True,
         include_packed: bool = True,
         include_sfc: bool = True,
         shard_counts: Optional[Sequence[int]] = None,
         top_k: int = DEFAULT_TOP_K,
         reps: Optional[int] = None, budget_s: float = 0.5,
         device=None, use_cache: bool = True) -> TuneResult:
    """Measure candidate schedules on ``positions`` and return the fastest.

    Enumerates (strategy, backend, batch_size, m_c, allin box) candidates
    and their compacted, packed, sfc and halo (shard-count) twins, drops those that overflow or
    that their kernel would refuse (:func:`kernel_refuses`), prunes to
    ``top_k`` with the traffic model, times each survivor with a
    warm-up-excluded stopwatch (``core.timing.time_fn``), and returns the
    empirically fastest :class:`InteractionPlan`. Winners persist in the
    JSON cache (``cache_path()``), so the same regime re-tunes for free.

    Args:
      positions: representative positions — required; the tuner times real
        executions and measures the bounds from them.
      m_c: pin the slot bound; by default both a tight (slack=1.0) and a
        slacked (``m_c_slack``, default 1.5) bound, rounded up to 8, are
        candidates.
      backends: backends to tune over; default ``("reference", "cuda")``
        when the positions lie on a CUDA device, ``("reference",)`` on the
        CPU (where ``"cuda"`` would time its plain versions).
      box: extra All-in-SM sub-box to try alongside the derived candidates
        (shrunk to grid divisors).
      candidates: explicit candidate list (overrides enumeration; no twins
        are added to an explicit list).
      include_compact / include_packed / include_sfc: add the compacted,
        packed-row and SFC-cluster twins (bounds measured from
        ``positions``) of every enumerated candidate whose (backend,
        strategy) implements that path.
      shard_counts: halo shard counts to sweep (every cell-schedule
        candidate gets a ``backend="halo"`` twin per viable count,
        :func:`halo_twins`). Default: the visible device count when above
        1, nothing on one device; ``()`` disables the axis.
      top_k: survivors after model pruning; raise it if you suspect the
        model is mis-ranking your regime.
      reps / budget_s: stopwatch controls (see ``time_fn``).
      device: the device the plans run on; default the positions'. Its
        visible device count (``dist.engine.visible_devices``) is the
        default shard axis and part of the cache key; halo twins stack
        their shards on ``device`` whatever the count.
      use_cache: disable to force re-measurement (the winner still
        overwrites the cache entry).
    """
    if positions is None:
        raise ValueError("tune() needs positions (it measures real "
                         "executions, not a model)")
    kernel = kernel or make_lennard_jones()
    device = positions.device if device is None else torch.device(device)
    if positions.device != device:
        raise ValueError(f"positions are on {positions.device}, the plans "
                         f"would run on {device}; move them first")
    platform = platform_of(device)
    from ..dist.engine import visible_devices
    device_count = visible_devices(device)
    if backends is None:
        backends = (("reference", "cuda") if device.type == "cuda"
                    else ("reference",))

    from .engine import suggest_m_c
    counts = cell_counts(domain, positions)
    max_count = int(counts.max())
    if m_c is not None:
        m_c_choices = [m_c]
    else:
        m_c_choices = list(dict.fromkeys(
            [suggest_m_c(domain, positions, slack=1.0),
             suggest_m_c(domain, positions, slack=m_c_slack)]))
    key_m_c = min(m_c_choices)
    avg_ppc = positions.shape[0] / domain.n_cells

    # measured occupancy: how many work units are actually active. Keyed
    # per unit type (pencils; sub-boxes per tiling) and memoized — used to
    # score compacted candidates, reject too-small cached bounds, and
    # bucket the cache key (mean ppc alone cannot tell a blob from a gas).
    _occ: Dict[Tuple, Tuple[int, int]] = {}

    def occ_of(c: Candidate) -> Tuple[int, int]:     # (n_active, n_units)
        key_ = ("box", c.box) if c.strategy == "allin" else ("pencil",)
        if key_ not in _occ:
            _occ[key_] = (active_unit_count(domain, positions, c.strategy,
                                            box=c.box, counts=counts),
                          n_units(domain, c.strategy, box=c.box))
        return _occ[key_]

    def fill_for(c: Candidate) -> float:
        n_act, total = occ_of(c)
        return n_act / max(total, 1)

    # the measured packed-row maximum and pair-list length, memoized: the
    # row_cap and pair_cap analogues of max_count
    _caps: Dict[str, int] = {}

    def measured_cap(layout: str) -> int:
        if layout not in _caps:
            _caps[layout] = (int(padded_row_counts(domain, counts).max())
                             if layout == "packed"
                             else sfc_pair_count(domain, counts=counts))
        return _caps[layout]

    # measured per-shard maxima, memoized per shard count: the halo
    # counterparts of max_count / occ_of, all from the one binning pass
    _shard_measures: Dict[int, Tuple[int, int]] = {}

    def shard_measures(ns: int) -> Tuple[int, int]:
        if ns not in _shard_measures:
            _shard_measures[ns] = (
                int(shard_slab_counts(domain, counts, ns).max()),
                int(shard_pencil_active(domain, counts, ns).max()))
        return _shard_measures[ns]

    def active_safe(c: Candidate, strict: bool = True) -> bool:
        if c.layout != "dense":
            what = "row_cap" if c.layout == "packed" else "pair_cap"
            bound = getattr(c, what)
            if bound is None:
                if strict:
                    raise ValueError(
                        f"{c.layout} candidate {c} has no {what} bound "
                        f"(repro_torch.core.suggest_{what} measures one)")
                return False
            if bound < measured_cap(c.layout):
                return False
        if c.distributed:
            ns = c.n_shards
            if domain.nz % ns:
                return False
            if c.shard_cap is None:
                if strict:
                    raise ValueError(
                        f"halo candidate {c} has no shard_cap bound "
                        "(repro_torch.dist.halo.suggest_shard_cap measures "
                        "one)")
                return False
            load, act = shard_measures(ns)
            if c.shard_cap < load:
                return False
            if c.compact:
                return c.max_active is not None and c.max_active >= act
            return True
        if not c.compact:
            return True
        if c.max_active is None:
            if strict:             # caller-supplied candidate: loud error
                raise ValueError(
                    f"compact candidate {c} has no max_active bound "
                    "(repro_torch.core.suggest_max_active measures one)")
            return False           # malformed cache entry: just re-measure
        return c.max_active >= occ_of(c)[0]

    _occ[("pencil",)] = (active_unit_count(domain, positions, "xpencil",
                                           counts=counts),
                         n_units(domain, "xpencil"))
    pencil_fill = _occ[("pencil",)][0] / max(_occ[("pencil",)][1], 1)
    key = cache_key(platform, domain, key_m_c, avg_ppc, kernel, backends,
                    pencil_fill=pencil_fill, device_count=device_count)
    cfile = cache_path()

    # build the requested candidate space first (cheap — no timing): the
    # cache is only consulted *within* it, so a restricted call
    # (strategies=..., candidates=..., pinned m_c) can never be answered
    # with a cached winner from outside its space
    if candidates is None:
        candidates = enumerate_candidates(
            domain, m_c_choices, backends=backends, batch_sizes=batch_sizes,
            strategies=strategies,
            extra_allin_boxes=(box,) if box is not None else ())
        if include_compact:
            candidates = list(candidates) + compact_twins(
                domain, positions, candidates)
        if include_packed:
            candidates = list(candidates) + packed_twins(
                domain, positions, candidates)
        if include_sfc:
            candidates = list(candidates) + sfc_twins(
                domain, positions, candidates)
        if shard_counts is None:
            # the default shard axis: the full device count, when there is
            # more than one device
            shard_counts = (device_count,) if device_count > 1 else ()
        if shard_counts:
            candidates = list(candidates) + halo_twins(
                domain, positions, candidates, shard_counts)
    candidates = [c for c in candidates
                  if c.m_c >= max_count and active_safe(c)]
    if not candidates:
        raise ValueError(
            f"no overflow-safe candidates: max cell count {max_count} "
            f"exceeds every candidate m_c")
    # what a kernel would refuse never reaches the stopwatch, so nothing in
    # the timing loop has to be caught
    refused = {c: kernel_refuses(c, kernel, domain) for c in candidates}
    infeasible = tuple(c for c in candidates if refused[c] is not None)
    candidates = [c for c in candidates if refused[c] is None]
    if not candidates:
        raise ValueError("no candidate fits its kernel: " + "; ".join(
            f"{c}: {refused[c]}" for c in infeasible))

    # the candidate space is part of the key: a restricted call (explicit
    # strategies/candidates/batch sizes) owns its own entry instead of
    # answering from — or clobbering — the unrestricted one
    key += f"|space{_space_id(candidates)}"

    if use_cache:
        entry = _load_cache(cfile).get(key)
        if entry and entry.get("version") == CACHE_VERSION:
            cand = Candidate.from_json(entry["candidate"])
            # trust the entry only if it is overflow-safe for *these*
            # positions (bucket collisions can cache a smaller bound —
            # for m_c *and* for a compacted max_active) and inside the
            # requested space — otherwise re-measure
            if (cand.m_c >= max_count and active_safe(cand, strict=False)
                    and cand in set(candidates)):
                _obs_metrics.registry.counter(CACHE_TOTAL,
                                              result="hit").inc()
                _obs_event("autotune.cache", result="hit",
                           strategy=cand.strategy, layout=cand.layout)
                return TuneResult(
                    plan=cand.plan(domain, kernel, device), candidate=cand,
                    timings={}, reps={}, pruned=(), cache_hit=True,
                    cache_file=str(cfile), infeasible=infeasible)
    _obs_metrics.registry.counter(CACHE_TOTAL, result="miss").inc()
    _obs_event("autotune.cache", result="miss", candidates=len(candidates))
    kept, pruned = prune_candidates(domain, avg_ppc, candidates,
                                    top_k=top_k, fill_for=fill_for)
    _audit_pruned(domain, counts, pruned, avg_ppc, fill_for)

    state = ParticleState(positions)
    timings: Dict[Candidate, float] = {}
    nreps: Dict[Candidate, int] = {}
    for cand in kept:
        p = cand.plan(domain, kernel, device)
        _obs_metrics.registry.counter(
            TIMING_RUNS_TOTAL, backend=cand.backend,
            strategy=cand.strategy, layout=cand.layout).inc()
        with _obs_trace("autotune.time", backend=cand.backend,
                        strategy=cand.strategy, layout=cand.layout,
                        compact=cand.compact,
                        modelled_bpi=_cost(domain, avg_ppc, cand,
                                           fill_for)) as sp:
            secs, r = time_fn(p.execute, state, reps=reps, budget_s=budget_s)
            sp.set(seconds_per_call=secs, reps=r)
        timings[cand] = secs
        nreps[cand] = r

    winner = min(timings, key=timings.get)
    _obs_event("autotune.winner", backend=winner.backend,
               strategy=winner.strategy, layout=winner.layout,
               compact=winner.compact,
               seconds_per_call=timings[winner])
    _store_cache(cfile, key, {
        "version": CACHE_VERSION,
        "candidate": winner.to_json(),
        "seconds": timings[winner],
        "platform": platform,
    })
    return TuneResult(plan=winner.plan(domain, kernel, device),
                      candidate=winner, timings=timings, reps=nreps,
                      pruned=tuple(pruned), cache_hit=False,
                      cache_file=str(cfile), infeasible=infeasible)
