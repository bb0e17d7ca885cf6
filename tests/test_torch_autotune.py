"""The port's measured autotuner (``core/autotune.py``), its stopwatch
(``core/timing.py``) and the core API it completes, against the JAX
package's.

* The JAX tuner's behaviours (``tests/test_autotune.py``), mirrored on the
  port's tuner, each with its cache in a ``tmp_path``.
* With the same inputs, the candidate space (``enumerate_candidates`` and
  the compact, packed and sfc twins) equals JAX's field by field, the
  ``allin`` boxes aside (the port sizes them for a block's shared
  memory), and ``prune_candidates`` keeps JAX's candidates in JAX's order.
* A tuned plan executes bit-equal to an explicit plan of its winner.
* What the port does differently: no error is caught. Candidates their
  kernel would refuse are dropped before timing; an error while timing, a
  failing audit and a cache file that does not parse raise.
* The core API: ``m_c_slack``, ``backend_matrix`` and ``__all__``.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
from repro.core import Domain as JDomain
from repro.core import autotune as jat
from repro.core import plan as j_plan
from repro_torch.convert import domain_from_jax
from repro_torch.core import (Domain, ParticleState, active_unit_count,
                              backend_matrix, make_high_flop,
                              make_lennard_jones, plan, suggest_m_c, time_fn,
                              tune)
import repro_torch.core as tcore
from repro_torch.core import autotune as at
from repro_torch.core.api import STRATEGY_NAMES, get_backend
from repro_torch.kernels.xpencil import MAX_M_C, MAX_ROW_CAP
from test_torch_sparse import blob

torch.set_num_threads(1)

# keep tuner runs cheap: 2 reps, tiny budget — correctness, not precision
FAST = dict(reps=2, budget_s=0.01)


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    return tmp_path


def _uniform(division=4, n=300, seed=0):
    jdom = JDomain.cubic(division, cutoff=1.0)
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * np.asarray(jdom.box)).astype(np.float32)
    return jdom, pos


def _case(division=4, n=300, seed=0):
    jdom, pos = _uniform(division, n, seed)
    return domain_from_jax(jdom), torch.from_numpy(pos)


def _blob_case(division=5, n=200, seed=0, sigma_frac=0.2):
    jdom, pos = blob(division, n, seed, sigma_frac=sigma_frac)
    return domain_from_jax(jdom), torch.from_numpy(pos)


# ---------------------------------------------------------------------------
# the winner is a real plan
# ---------------------------------------------------------------------------

def test_tune_returns_registered_overflow_safe_plan(cache_dir):
    dom, pos = _case()
    res = tune(dom, make_lennard_jones(), pos, top_k=4, **FAST)
    p = res.plan
    assert p.strategy in STRATEGY_NAMES
    assert p.device == torch.device("cpu")
    get_backend(p.backend, p.strategy, p.layout)     # registered, or raises
    assert not p.check_overflow(ParticleState(pos))
    # the winner really is the measured minimum among timed candidates
    assert res.timings[res.candidate] == min(res.timings.values())
    forces, pot = p.execute(ParticleState(pos))
    assert forces.shape == (pos.shape[0], 3)


def test_tune_requires_positions():
    with pytest.raises(ValueError, match="positions"):
        tune(Domain.cubic(3))
    with pytest.raises(ValueError, match="autotune"):
        plan(Domain.cubic(3), m_c=8, strategy="autotune", device="cpu")


def test_pinned_m_c_below_occupancy_is_rejected(cache_dir):
    dom, pos = _case(3, 400)
    with pytest.raises(ValueError, match="overflow-safe"):
        tune(dom, make_lennard_jones(), pos, m_c=1, **FAST)


# ---------------------------------------------------------------------------
# disk cache
# ---------------------------------------------------------------------------

def test_cache_round_trips_through_disk(cache_dir, monkeypatch):
    dom, pos = _case()
    res1 = tune(dom, make_lennard_jones(), pos, top_k=4, **FAST)
    assert not res1.cache_hit and res1.timings

    cfile = pathlib.Path(res1.cache_file)
    assert cfile.exists() and cfile.parent == cache_dir
    data = json.loads(cfile.read_text())
    [(key, entry)] = data.items()
    assert key.startswith("cpu|dev")
    assert entry["version"] == at.CACHE_VERSION == 2
    assert entry["candidate"]["strategy"] == res1.candidate.strategy
    assert not list(cache_dir.glob("*.tmp"))

    # second call: zero timing runs — a stopwatch call would blow up here
    def bomb(*a, **k):
        raise AssertionError("cache hit must not time anything")
    monkeypatch.setattr(at, "time_fn", bomb)
    before = at.timing_run_count()
    res2 = tune(dom, make_lennard_jones(), pos, top_k=4, **FAST)
    assert res2.cache_hit and not res2.timings
    assert res2.plan == res1.plan
    assert at.timing_run_count() == before


def test_plan_autotune_front_door_reuses_cache(cache_dir, monkeypatch):
    dom, pos = _case(3, 60)
    p1 = plan(dom, make_lennard_jones(), positions=pos, strategy="autotune",
              device="cpu")

    def bomb(*a, **k):
        raise AssertionError("cached plan() must not time anything")
    monkeypatch.setattr(at, "time_fn", bomb)
    p2 = plan(dom, make_lennard_jones(), positions=pos, strategy="autotune",
              device="cpu")
    assert p2 == p1
    assert p1.strategy in STRATEGY_NAMES
    # the default backend="cuda" tunes over the cuda backend alone
    assert p1.backend == "cuda"


def test_cache_hit_respects_restricted_candidate_space(cache_dir):
    """A cached winner from an unrestricted run must not answer a call
    that explicitly excludes it."""
    dom, pos = _case()
    res1 = tune(dom, make_lennard_jones(), pos, **FAST)
    other = [s for s in STRATEGY_NAMES if s != res1.candidate.strategy]
    res2 = tune(dom, make_lennard_jones(), pos, strategies=tuple(other),
                **FAST)
    assert not res2.cache_hit                  # space changed: re-measured
    assert res2.candidate.strategy != res1.candidate.strategy
    # the restricted run got its own entry: the unrestricted regime still
    # hits its original winner, unclobbered
    res3 = tune(dom, make_lennard_jones(), pos, **FAST)
    assert res3.cache_hit and res3.plan == res1.plan


def test_cache_entry_ignored_when_bound_overflows(cache_dir):
    """A bucket collision must never hand back an overflow-unsafe plan."""
    dom, pos = _case(3, 120)
    res1 = tune(dom, make_lennard_jones(), pos, top_k=2, **FAST)
    cfile = pathlib.Path(res1.cache_file)
    data = json.loads(cfile.read_text())
    [key] = data
    data[key]["candidate"]["m_c"] = 0
    cfile.write_text(json.dumps(data))
    res2 = tune(dom, make_lennard_jones(), pos, top_k=2, **FAST)
    assert not res2.cache_hit                   # re-measured, not trusted
    assert not res2.plan.check_overflow(ParticleState(pos))


def test_cache_key_separates_same_name_kernels(cache_dir):
    dom = Domain.cubic(4)
    k_small = make_high_flop(extra_terms=5)
    k_big = make_high_flop(extra_terms=200)
    assert k_small.name == k_big.name and k_small != k_big
    key_small = at.cache_key("cpu", dom, 16, 1.0, k_small, ("reference",))
    key_big = at.cache_key("cpu", dom, 16, 1.0, k_big, ("reference",))
    assert key_small != key_big


def test_cache_key_separates_regimes():
    dom = Domain.cubic(4)
    kern = make_lennard_jones()
    k1 = at.cache_key("cpu", dom, 16, 1.0, kern, ("reference",))
    assert k1 != at.cache_key("cuda:NVIDIA H100 80GB HBM3", dom, 16, 1.0,
                              kern, ("reference",))
    assert k1 != at.cache_key("cpu", dom, 32, 1.0, kern, ("reference",))
    assert k1 != at.cache_key("cpu", dom, 16, 100.0, kern, ("reference",))
    assert k1 != at.cache_key("cpu", Domain.cubic(8), 16, 1.0, kern,
                              ("reference",))
    assert k1 != at.cache_key("cpu", dom, 16, 1.0, kern, ("reference",),
                              device_count=4)
    assert at.ppc_bucket(9.0) == at.ppc_bucket(10.0)
    assert at.ppc_bucket(1.0) != at.ppc_bucket(10.0)
    assert at.platform_of(torch.device("cpu")) == "cpu"


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------

def test_pruning_never_drops_measured_winner_on_seeded_case(cache_dir):
    """Time the *whole* candidate space, then check the default model
    pruning would have kept the measured winner in the field."""
    dom, pos = _case(4, 300)
    m_c = suggest_m_c(dom, pos)
    cands = at.enumerate_candidates(dom, [m_c], backends=("reference",),
                                    batch_sizes=(64, 128))
    full = tune(dom, make_lennard_jones(), pos, candidates=cands,
                top_k=len(cands), use_cache=False, **FAST)
    assert len(full.timings) == len(cands) and not full.pruned
    kept, pruned = at.prune_candidates(
        dom, pos.shape[0] / dom.n_cells, cands, top_k=at.DEFAULT_TOP_K)
    assert full.candidate in kept
    assert set(kept) | set(pruned) == set(cands)


def test_prune_is_deterministic_and_ranked():
    dom, pos = _case(4, 300)
    m_c = suggest_m_c(dom, pos)
    cands = at.enumerate_candidates(dom, [m_c, 2 * m_c])
    ppc = pos.shape[0] / dom.n_cells
    kept1, _ = at.prune_candidates(dom, ppc, cands, top_k=5)
    kept2, _ = at.prune_candidates(dom, ppc, cands, top_k=5)
    assert kept1 == kept2 and len(kept1) == 5


def test_prune_cannot_eliminate_a_whole_strategy():
    dom, pos = _case(4, 300)
    m_c = suggest_m_c(dom, pos)
    cands = at.enumerate_candidates(dom, [m_c])
    ppc = pos.shape[0] / dom.n_cells
    kept, _ = at.prune_candidates(dom, ppc, cands, top_k=at.DEFAULT_TOP_K)
    assert {c.strategy for c in kept} == {c.strategy for c in cands}


def test_enumerate_naive_n2_when_requested(cache_dir):
    dom = Domain.cubic(3)
    cands = at.enumerate_candidates(dom, [8], strategies=("naive_n2",))
    assert cands and all(c.strategy == "naive_n2" for c in cands)
    pos = torch.from_numpy(_uniform(3, 50)[1])
    res = tune(dom, make_lennard_jones(), pos, candidates=cands,
               use_cache=False, **FAST)
    assert res.candidate.strategy == "naive_n2"


def test_enumerate_only_registered_pairs():
    dom = Domain.cubic(4)
    cands = at.enumerate_candidates(dom, [16], backends=("reference", "cuda"))
    for c in cands:
        get_backend(c.backend, c.strategy)      # must not raise
    # cuda runs the paper's two proposed schedules in the dense layout
    assert {c.strategy for c in cands if c.backend == "cuda"} == {
        "xpencil", "allin"}


# ---------------------------------------------------------------------------
# dense-vs-compact candidate axis
# ---------------------------------------------------------------------------

def test_compact_twins_cover_compactable_strategies():
    dom, pos = _blob_case()
    cands = at.enumerate_candidates(dom, [16], backends=("reference",),
                                    batch_sizes=(64,))
    twins = at.compact_twins(dom, pos, cands)
    assert twins and all(c.compact and c.max_active for c in twins)
    assert {c.strategy for c in twins} == {"xpencil", "cell_dense", "allin"}
    for c in twins:
        assert at.Candidate.from_json(c.to_json()) == c


def test_tune_times_compact_candidates_and_winner_executes(cache_dir):
    dom, pos = _blob_case()
    res = tune(dom, make_lennard_jones(), pos, **FAST)
    assert [c for c in res.timings if c.compact]
    f, _ = res.plan.execute(ParticleState(pos))
    f_ref, _ = plan(dom, make_lennard_jones(), positions=pos,
                    strategy="xpencil", device="cpu").execute(
                        ParticleState(pos))
    np.testing.assert_allclose(f.numpy(), f_ref.numpy(), rtol=3e-4,
                               atol=3e-4)


def test_cache_key_includes_occupancy_bucket():
    dom = Domain.cubic(6)
    kern = make_lennard_jones()
    k_dense = at.cache_key("cpu", dom, 16, 1.0, kern, ("reference",),
                           pencil_fill=1.0)
    k_sparse = at.cache_key("cpu", dom, 16, 1.0, kern, ("reference",),
                            pencil_fill=0.05)
    assert k_dense != k_sparse
    assert at.occupancy_bucket(0.9) == at.occupancy_bucket(1.0)
    assert at.occupancy_bucket(0.05) != at.occupancy_bucket(1.0)


def test_cached_compact_winner_with_stale_bound_is_rejected(cache_dir):
    dom, pos = _blob_case()
    res1 = tune(dom, make_lennard_jones(), pos, **FAST)
    cfile = pathlib.Path(res1.cache_file)
    data = json.loads(cfile.read_text())
    [key] = data
    data[key]["candidate"].update(compact=True, max_active=1,
                                  strategy="xpencil", backend="reference")
    cfile.write_text(json.dumps(data))
    res2 = tune(dom, make_lennard_jones(), pos, **FAST)
    assert not res2.cache_hit
    if res2.candidate.compact:
        assert res2.candidate.max_active >= active_unit_count(
            dom, pos, res2.candidate.strategy, box=res2.candidate.box)


# ---------------------------------------------------------------------------
# the candidate space and the pruning order against JAX's
# ---------------------------------------------------------------------------

def _fields(c, backend_map=None):
    d = c.to_json()
    if backend_map:
        d["backend"] = backend_map.get(d["backend"], d["backend"])
    return d


def _spaces(jdom, pos, backends, m_c_choices, box=None):
    dom = domain_from_jax(jdom)
    tpos, jpos = torch.from_numpy(pos), jnp.asarray(pos)
    jbackends = tuple("pallas" if b == "cuda" else b for b in backends)
    extra = (box,) if box else ()
    mine = at.enumerate_candidates(dom, m_c_choices, backends=backends,
                                   extra_allin_boxes=extra)
    theirs = jat.enumerate_candidates(jdom, m_c_choices, backends=jbackends,
                                      extra_allin_boxes=extra)
    for t_twins, j_twins in ((at.compact_twins, jat.compact_twins),
                             (at.packed_twins, jat.packed_twins),
                             (at.sfc_twins, jat.sfc_twins)):
        mine = mine + t_twins(dom, tpos, mine)
        theirs = theirs + j_twins(jdom, jpos, theirs)
    return dom, mine, theirs


def _allin_aside(cands, backend_map=None):
    return [_fields(c, backend_map) for c in cands
            if c.strategy != "allin"]


@pytest.mark.parametrize("scene", ["uniform", "blob"])
@pytest.mark.parametrize("backends", [("reference",), ("reference", "cuda")],
                         ids=["reference", "reference+cuda"])
def test_candidate_space_equals_jax(scene, backends):
    """Field by field, in order, with ``"cuda"`` in the place of JAX's
    ``"pallas"``. JAX's space holds no Pallas sfc candidate (``"pallas"``
    has no dense ``cell_dense`` to twin), so the port's holds no ``"cuda"``
    sfc candidate either: kernel F is tuned through ``"reference"`` only."""
    jdom, pos = (_uniform(6, 400, seed=3) if scene == "uniform"
                 else blob(6, 300, seed=3, sigma_frac=0.1))
    dom, mine, theirs = _spaces(jdom, pos, backends, [8, 16],
                                box=(3, 3, 3))
    assert _allin_aside(mine) == _allin_aside(theirs, {"pallas": "cuda"})
    assert not [c for c in mine if c.backend == "cuda" and c.layout == "sfc"]
    assert [c for c in mine if c.layout == "sfc"]
    # allin: the port's own box for each m_c, then (2, 2, 2) and the
    # caller's, shrunk to divisors; every other field as JAX's
    from repro_torch.core import strategies as S
    from repro_torch.core.api import _allin_box
    for m_c in (8, 16):
        want = list(dict.fromkeys([_allin_box(dom, m_c),
                                   S.shrink_to_divisors(dom, (2, 2, 2)),
                                   S.shrink_to_divisors(dom, (3, 3, 3))]))
        assert at._allin_boxes(dom, m_c, [(3, 3, 3)]) == want
        got = [c.box for c in mine if c.strategy == "allin" and c.m_c == m_c
               and not c.compact and c.backend == "reference"
               and c.batch_size == 32]
        assert got == want

    def boxless(cands, backend_map=None):
        return {json.dumps(dict(_fields(c, backend_map), box=None,
                                max_active=None), sort_keys=True)
                for c in cands if c.strategy == "allin"}
    assert boxless(mine) == boxless(theirs, {"pallas": "cuda"})


@pytest.mark.parametrize("top_k", [1, 5, 8, 40])
def test_prune_keeps_jax_candidates_in_jax_order(top_k):
    """One explicit candidate list, the same fill for compacted candidates:
    the same kept list, in the same order, and the same pruned list."""
    jdom, pos = blob(6, 300, seed=5, sigma_frac=0.1)
    dom, mine, theirs = _spaces(jdom, pos, ("reference", "cuda"), [8, 16])
    # the JAX candidates with the port's allin boxes: one list for both
    jlist = [jat.Candidate(**{k: (tuple(v) if k == "box" and v else v)
                              for k, v in _fields(c, {"cuda": "pallas"})
                              .items()}) for c in mine]

    def fill_of(c):
        return 0.5 if c.strategy == "allin" else 0.75

    ppc = pos.shape[0] / dom.n_cells
    kept, pruned = at.prune_candidates(dom, ppc, mine, top_k=top_k,
                                       fill_for=fill_of)
    jkept, jpruned = jat.prune_candidates(jdom, ppc, jlist, top_k=top_k,
                                          fill_for=fill_of)
    assert [_fields(c) for c in kept] == \
        [_fields(c, {"pallas": "cuda"}) for c in jkept]
    assert [_fields(c) for c in pruned] == \
        [_fields(c, {"pallas": "cuda"}) for c in jpruned]


# ---------------------------------------------------------------------------
# results: the tuned plan is its explicit plan
# ---------------------------------------------------------------------------

def test_tuned_plan_executes_bit_equal_to_its_explicit_plan(cache_dir):
    dom, pos = _blob_case()
    state = ParticleState(pos)
    res = tune(dom, make_lennard_jones(), pos, m_c=suggest_m_c(dom, pos),
               backends=("reference", "cuda"), batch_sizes=(64,), top_k=100,
               **FAST)
    assert not res.pruned
    c = res.candidate
    explicit = plan(dom, positions=pos, device="cpu", strategy=c.strategy,
                    backend=c.backend, m_c=c.m_c, batch_size=c.batch_size,
                    box=c.box, compact=c.compact, max_active=c.max_active,
                    layout=c.layout, row_cap=c.row_cap, pair_cap=c.pair_cap)
    for a, b in zip(res.plan.execute(state), explicit.execute(state)):
        assert torch.equal(a, b)
    # dense = compact = packed = allin, bitwise, on every timed candidate
    # of the X-pencil and All-in-SM families
    want = plan(dom, positions=pos, device="cpu", strategy="xpencil",
                m_c=c.m_c).execute(state)
    family = [t for t in res.timings if t.strategy in ("xpencil", "allin")
              and t.m_c == c.m_c]
    assert {(t.strategy, t.layout, t.compact) for t in family} >= {
        ("xpencil", "dense", False), ("xpencil", "dense", True),
        ("xpencil", "packed", False), ("allin", "dense", False)}
    for t in family:
        for a, b in zip(t.plan(dom, make_lennard_jones(), "cpu")
                        .execute(state), want):
            assert torch.equal(a, b), t


def test_second_tune_is_a_cache_hit_with_no_timing_run(cache_dir):
    dom, pos = _case(5, 250, seed=2)
    at.reset_timing_runs()
    res1 = tune(dom, None, pos, **FAST)
    assert at.timing_run_count() == len(res1.timings) > 0
    res2 = tune(dom, None, pos, **FAST)
    assert res2.cache_hit and res2.candidate == res1.candidate
    assert at.timing_run_count() == len(res1.timings)
    from repro_torch import obs
    snap = obs.snapshot()[at.CACHE_TOTAL]
    assert snap['{result="hit"}'] >= 1 and snap['{result="miss"}'] >= 1


# ---------------------------------------------------------------------------
# nothing is caught
# ---------------------------------------------------------------------------

def test_infeasible_candidates_are_dropped_before_timing(cache_dir,
                                                         monkeypatch):
    dom, pos = _case(4, 200, seed=1)
    m_c = suggest_m_c(dom, pos)
    ok = at.Candidate("xpencil", "cuda", 32, m_c)
    refused = [
        at.Candidate("xpencil", "cuda", 32, MAX_M_C + 6),           # B
        at.Candidate("xpencil", "cuda", 32, MAX_M_C + 6, compact=True,
                     max_active=16),                                 # C
        at.Candidate("xpencil", "cuda", 32, m_c, layout="packed",
                     row_cap=MAX_ROW_CAP + 8),                       # D
        at.Candidate("allin", "cuda", 32, 600, box=(1, 1, 1)),       # E
        at.Candidate("cell_dense", "cuda", 32, 4000, layout="sfc",
                     pair_cap=4096),                                 # F
    ]
    assert all(at.kernel_refuses(c, make_lennard_jones(), dom)
               for c in refused)
    # the limits are the kernels': the reference backend and a kernel E
    # halo block that just fits pass
    for c in (at.Candidate("xpencil", "reference", 32, MAX_M_C + 6),
              at.Candidate("allin", "cuda", 32, 538, box=(1, 1, 1))):
        assert at.kernel_refuses(c, make_lennard_jones(), dom) is None
    timed = []
    real = at.time_fn

    def spy(fn, *args, **kw):
        timed.append(fn.__self__)
        return real(fn, *args, **kw)
    monkeypatch.setattr(at, "time_fn", spy)
    res = tune(dom, None, pos, candidates=[ok, *refused], top_k=10,
               use_cache=False, **FAST)
    assert set(res.infeasible) == set(refused)
    assert set(res.timings) == {ok} and len(timed) == 1
    mine = make_lennard_jones().__class__(
        "mine", lambda r2: r2, lambda r2: r2, flops=2)
    assert "no CUDA form" in at.kernel_refuses(ok, mine, dom)
    with pytest.raises(ValueError, match="no candidate fits its kernel"):
        tune(dom, None, pos, candidates=refused, use_cache=False, **FAST)


def test_an_error_while_timing_propagates(cache_dir, monkeypatch):
    dom, pos = _case(3, 100)

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(at, "time_fn", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tune(dom, None, pos, **FAST)
    assert not list(cache_dir.iterdir())            # nothing was stored


def test_a_failing_audit_fails_the_tune(cache_dir, monkeypatch):
    import repro_torch.obs.audit as audit
    dom, pos = _case(4, 200)

    def broken(*a, **k):
        raise ValueError("audit broke")
    monkeypatch.setattr(audit, "audit_candidate", broken)
    with pytest.raises(ValueError, match="audit broke"):
        tune(dom, None, pos, top_k=2, **FAST)


@pytest.mark.parametrize("text", ["{not json", "[1, 2]", ""])
def test_a_cache_file_that_does_not_parse_raises_with_its_path(cache_dir,
                                                               text):
    dom, pos = _case(3, 100)
    (cache_dir / "autotune_cache.json").write_text(text)
    with pytest.raises(ValueError, match=str(cache_dir /
                                             "autotune_cache.json")):
        tune(dom, None, pos, **FAST)


def test_shard_counts_above_one_raise_naming_item_11():
    """``shard_counts`` raised naming Queue 1 item 11 until the halo engine
    was ported; now the shard axis equals JAX's: the halo twins of the
    enumerated space, field by field and in order (JAX's with every
    count's devices present: the port's twins stack their shards)."""
    jdom, pos = _uniform(8, 500, seed=2)
    dom, mine, theirs = _spaces(jdom, pos, ("reference", "cuda"), [8, 16])
    t_twins = at.halo_twins(dom, torch.from_numpy(pos), mine, (2, 4, 8))
    j_twins = jat.halo_twins(jdom, jnp.asarray(pos), theirs, (2, 4, 8),
                             device_count=8)
    assert t_twins and {c.n_shards for c in t_twins} == {2, 4, 8}
    assert [_fields(c) for c in t_twins] == [
        _fields(c, {"pallas": "cuda"}) for c in j_twins]
    dom4, pos4 = _case(4, 100)
    with pytest.raises(ValueError, match="move them first"):
        tune(dom4, None, pos4.to("meta"), device="cpu")


def test_time_fn_gives_mean_seconds_and_reps():
    calls = []

    def fn(x):
        calls.append(x)
        return torch.ones(3) * x
    secs, reps = time_fn(fn, 2.0, reps=5)
    assert reps == 5 and len(calls) == 7 and secs >= 0.0
    secs, reps = time_fn(fn, 2.0, budget_s=1e-9)
    assert reps == 2


# ---------------------------------------------------------------------------
# the core API (ROADMAP Queue 3 fault 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slack", [1.0, 1.25, 1.5, 2.0])
def test_m_c_slack_gives_jax_m_c(slack):
    jdom, pos = blob(5, 300, seed=11, sigma_frac=0.1)
    dom = domain_from_jax(jdom)
    want = j_plan(jdom, positions=jnp.asarray(pos), strategy="xpencil",
                  m_c_slack=slack).m_c
    got = plan(dom, positions=torch.from_numpy(pos), strategy="xpencil",
               device="cpu", m_c_slack=slack)
    assert got.m_c == want
    assert plan(dom, positions=torch.from_numpy(pos), device="cpu",
                backend="reference", m_c_slack=slack).m_c == want


def test_backend_matrix_maps_cuda_to_what_jax_maps_pallas_to():
    mine, theirs = backend_matrix(), jcore.backend_matrix()
    assert set(mine["cuda"]) == set(theirs["pallas"])
    assert set(mine["reference"]) == set(theirs["reference"])
    assert set(mine) == {"cuda", "reference"}


# names of repro.core not yet in repro_torch.core, by the Queue 1 item that
# ports them: none (items 10 and 11 are ported)
NOT_YET = {11: set()}


def test_core_all_covers_jax_all_less_items_10_and_11():
    missing = set(jcore.__all__) - set(tcore.__all__)
    assert missing == set().union(*NOT_YET.values())
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
