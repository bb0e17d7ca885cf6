"""``InteractionPlan.execute_batch``: B systems stacked on a leading axis.

Within the port, on the CPU: the batch equals a loop of ``execute`` bit
for bit for every ``(backend, strategy, layout, compact)`` the port
registers (read from its registry), open and periodic, with and without a
field, with a ``(B, N)`` ``valid`` mask and a fully invalid system, and at
B = 1; batched binning, packing, occupancy and pair lists equal the
per-system ones; the ``"cuda"`` backend enters each kernel's plain version
once per batch, not B times; the stacked-state checks raise. Against JAX's
``execute_batch`` on the same numpy inputs: the reference backend for every
strategy and layout and JAX's Pallas dense X-pencil in interpret mode, each
system within the repo's scale-relative 3e-4 (``tests/test_dist.py``).
"""

import importlib
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import Domain as JDomain, ParticleState as JState
from repro.core import make_lennard_jones as j_lj, plan as j_plan
import repro_torch.kernels                      # registers "cuda"
from repro_torch.convert import domain_from_jax, kernel_from_jax
from repro_torch.core import (Domain, ParticleState, bin_particles,
                              build_sfc_clusters, pack_rows,
                              pencil_occupancy, plan, subbox_occupancy)
from repro_torch.core import api
from repro_torch.core.binning import system
from repro_torch.kernels import allin as AL
from repro_torch.kernels import pack as PK
from repro_torch.kernels import sfc as SF
from repro_torch.kernels import xpencil as XP
from repro_torch.kernels._common import MAX_SYSTEMS

# the module: the package exports the wrapper under the module's name
PS = importlib.import_module("repro_torch.kernels.prefix_sum")

torch.set_num_threads(1)

# every registered (backend, strategy, layout) with compact False, and with
# compact True where the registry says it honours it
REGISTERED = sorted([(*k, False) for k in api._BACKENDS]
                    + [(*k, True) for k in api._COMPACT_OK])


def _ids(case):
    backend, strategy, layout, compact = case
    return f"{backend}-{strategy}-{layout}" + ("-compact" if compact else "")


def _stacked(ncells, b, n, seed, periodic, field=False, mask=False):
    """(port Domain, ParticleState (B, N, 3)) from numpy: uniform
    positions; with ``mask``, a fifth of each system's rows are padding and
    system 1 (when B > 1) is padding throughout."""
    rng = np.random.default_rng(seed)
    box = np.asarray(ncells, np.float32)
    pos = (rng.uniform(0, 1, (b, n, 3)) * box).astype(np.float32)
    fields = ({"mass": rng.uniform(0.5, 2.0, (b, n)).astype(np.float32)}
              if field else {})
    valid = None
    if mask:
        valid = rng.uniform(0, 1, (b, n)) > 0.2
        if b > 1:
            valid[1] = False
    dom = Domain(box=tuple(float(v) for v in box), ncells=ncells, cutoff=1.0,
                 periodic=periodic)
    return dom, ParticleState(
        torch.from_numpy(pos), {k: torch.from_numpy(v)
                                for k, v in fields.items()},
        None if valid is None else torch.from_numpy(valid))


def _covering_plan(dom, states, **kw):
    """A plan whose bounds hold for every system (each grown through the
    replan contract until none overflows)."""
    each = [system(states, b) for b in range(states.positions.shape[0])]
    p = plan(dom, positions=each[0].positions, device="cpu", **kw)
    grown = True
    while grown:
        grown = False
        for st in each:
            while p.check_overflow(st):
                p, grown = p.replan(st), True
    return p


def _kwargs(case):
    backend, strategy, layout, compact = case
    return dict(backend=backend, strategy=strategy, layout=layout,
                compact=compact)


SCENES = {
    # ncells, B, N, periodic, field, mask
    "open": ((4, 3, 3), 3, 60, False, False, False),
    "periodic-thin-masked": ((4, 1, 3), 3, 30, True, True, True),
    "single": ((3, 3, 4), 1, 60, True, True, False),
}


# ---------------------------------------------------------------------------
# batched = looped, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("case", REGISTERED, ids=_ids)
def test_batch_equals_loop_bitwise(case, scene):
    ncells, b, n, periodic, field, mask = SCENES[scene]
    dom, states = _stacked(ncells, b, n, seed=len(scene), periodic=periodic,
                           field=field, mask=mask)
    p = _covering_plan(dom, states, **_kwargs(case))
    fb, ub = p.execute_batch(states)
    assert fb.shape == (b, n, 3) and ub.shape == (b, n)
    for i in range(b):
        f, u = p.execute(system(states, i))
        assert torch.equal(fb[i], f) and torch.equal(ub[i], u), i
    if mask and b > 1:                    # the fully invalid system is inert
        assert not bool(fb[1].any()) and not bool(ub[1].any())
        assert bool(fb[0].abs().sum() > 0)


def test_naive_oracle_loops_over_systems():
    dom, states = _stacked((3, 3, 3), 2, 40, seed=5, periodic=True)
    p = plan(dom, m_c=16, device="cpu", strategy="naive_n2")
    fb, ub = p.execute_batch(states)
    for i in range(2):
        f, u = p.execute(system(states, i))
        assert torch.equal(fb[i], f) and torch.equal(ub[i], u)


# ---------------------------------------------------------------------------
# the batched layout data, per system
# ---------------------------------------------------------------------------

def _assert_same(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}.{k}")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), what


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_batched_binning_equals_per_system(periodic):
    """slot_id, counts, offsets, particle_slot and every plane, the ghost
    ring of a 1-cell-thick periodic axis included; m_c 3 drops particles,
    whose slot is each system's own dump slot."""
    dom, states = _stacked((4, 1, 3), 4, 50, seed=7, periodic=periodic,
                           field=True, mask=True)
    bins = bin_particles(dom, states.positions, states.fields, m_c=3,
                         valid=states.valid)
    total = bins.slot_id[0].numel()
    assert bool((bins.particle_slot == total).any())        # some dropped
    for i in range(4):
        one = system(states, i)
        want = bin_particles(dom, one.positions, one.fields, m_c=3,
                             valid=one.valid)
        for name in ("planes", "slot_id", "counts", "offsets",
                     "particle_slot"):
            _assert_same(getattr(system(bins, i), name),
                         getattr(want, name), f"system {i} {name}")
    assert int(bins.counts[1].sum()) == 0 and bool((bins.slot_id[1] < 0).all())


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_batched_layouts_equal_per_system(periodic):
    """Packed rows, pencil and sub-box occupancy and the SFC pair list of
    stacked bins, each bound per system, against each system's own."""
    dom, states = _stacked((4, 3, 3), 3, 60, seed=8, periodic=periodic,
                           mask=True)
    bins = bin_particles(dom, states.positions, m_c=8, valid=states.valid)
    layouts = (
        (lambda bn: pack_rows(dom, bn, 20), "packed"),
        (lambda bn: pencil_occupancy(dom, bn.counts, 5), "pencils"),
        (lambda bn: subbox_occupancy(dom, bn.counts, (2, 3, 1), 4),
         "sub-boxes"),
        (lambda bn: build_sfc_clusters(dom, bn, 40), "sfc"))
    for make, what in layouts:
        batched = make(bins)
        for i in range(3):
            want = make(system(bins, i))
            for f in want.__dataclass_fields__:
                w = getattr(want, f)
                if isinstance(w, (torch.Tensor, dict)):
                    _assert_same(getattr(system(batched, i), f), w,
                                 f"{what} system {i} {f}")
    assert bool(pencil_occupancy(dom, bins.counts, 5).overflowed[0])


# ---------------------------------------------------------------------------
# one launch of each kernel per batch
# ---------------------------------------------------------------------------

PLAIN = {"xpencil": (XP, "xpencil_planes"),
         "xpencil_sparse": (XP, "xpencil_sparse_planes"),
         "xpencil_packed": (XP, "xpencil_packed_planes"),
         "allin": (AL, "allin_planes"), "sfc": (SF, "cell_sfc_tiles"),
         "pack": (PK, "pack_slots_plain"),
         "scan": (PS, "paper_prefix_sum")}


@pytest.mark.parametrize("case", [c for c in REGISTERED if c[0] == "cuda"],
                         ids=_ids)
def test_cuda_backend_enters_each_plain_version_once(case, monkeypatch):
    """On CPU tensors each kernel wrapper runs its plain version: once per
    execute_batch, whatever B, and kernel A's once, in the binning (the
    pack kernel's plain version scans its rows itself)."""
    calls = dict.fromkeys(PLAIN, 0)
    for name, (mod, attr) in PLAIN.items():
        def counted(*a, _fn=getattr(mod, attr), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    dom, states = _stacked((4, 3, 3), 4, 60, seed=9, periodic=True)
    p = _covering_plan(dom, states, **_kwargs(case))
    p.execute_batch(states)
    _, strategy, layout, compact = case
    kernel = {"allin": "allin", "cell_dense": "sfc"}.get(strategy)
    if strategy == "xpencil":
        kernel = {"packed": "xpencil_packed"}.get(
            layout, "xpencil_sparse" if compact else "xpencil")
    want = dict.fromkeys(PLAIN, 0)
    want[kernel] = 1
    want["scan"] = 1
    if layout == "packed":
        want["pack"] = 1
    assert calls == want


# ---------------------------------------------------------------------------
# the stacked-state checks
# ---------------------------------------------------------------------------

def test_stacked_state_errors():
    dom, states = _stacked((3, 3, 3), 2, 20, seed=10, periodic=False)
    p = plan(dom, m_c=16, device="cpu", strategy="xpencil")
    pos = states.positions
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        p.execute_batch(ParticleState(pos[0]))
    with pytest.raises(ValueError, match="execute_batch"):
        p.execute(states)
    with pytest.raises(ValueError, match="B >= 1"):
        p.execute_batch(ParticleState(pos[:0]))
    with pytest.raises(ValueError, match="state.mass has shape"):
        p.execute_batch(ParticleState(pos, {"mass": torch.ones(2, 21)}))
    with pytest.raises(ValueError, match="state.valid has shape"):
        p.execute_batch(ParticleState(pos, valid=torch.ones(20,
                                                            dtype=torch.bool)))
    with pytest.raises(ValueError, match="move the state"):
        p.execute_batch(ParticleState(pos.to("meta")))
    with pytest.raises(ValueError, match="naive_n2 bypasses binning"):
        plan(dom, m_c=16, device="cpu", strategy="naive_n2").execute_batch(
            ParticleState(pos, valid=torch.ones(2, 20, dtype=torch.bool)))
    # B x the slots of one system past the int32 slot index: 117 systems of
    # 66^3 * 64 slots each, one particle a system (one system fits)
    big = Domain.cubic(64, cutoff=1.0)
    one = ParticleState(torch.full((117, 1, 3), 10.0))
    with pytest.raises(ValueError, match="117 x 18399744 slots exceed"):
        plan(big, m_c=64, device="cpu", strategy="xpencil").execute_batch(one)


# ---------------------------------------------------------------------------
# kernel D's tile over a batch
# ---------------------------------------------------------------------------

XPENCIL_CU = (pathlib.Path(XP.__file__).resolve().parent / "csrc"
              / "xpencil.cu").read_text()


def test_packed_tile_policy_sees_the_batch_rows():
    """The entry point sizes D's tile on the batch's rows, as
    ``packed_tile_rows(row_cap, n_sys * n_rows)`` does in Python, and the
    grid's last axis is the system, so no tile spans two systems. At 64
    systems of 256 rows the batch takes full tiles where one system's rows
    alone would leave one pencil a tile."""
    entry = re.search(r'extern "C" int xpencil_packed_f32\((.*?)\n\}',
                      XPENCIL_CU, re.S).group(1)
    assert "tile_rows = packed_tile_rows(row_cap, n_sys * n_rows);" in \
        re.sub(r"\s+", " ", entry)
    launch = re.search(r"cudaError_t launch_packed\((.*?)\n\}", XPENCIL_CU,
                       re.S).group(1)
    assert ("const dim3 grid((n_rows + per_block - 1) / per_block, "
            "(per_block * row_cap + split - 1) / split, n_sys);"
            in re.sub(r"\s+", " ", launch))
    assert XP.packed_tile_rows(40, 256) == 1
    assert XP.packed_tile_rows(40, 64 * 256) == XP.MAX_TILE_ROWS


def test_system_limit_matches_the_cuda_sources():
    """The wrappers' MAX_SYSTEMS is the sources' kMaxSystems: the system is
    a grid y or z index, at most 65535."""
    csrc = pathlib.Path(XP.__file__).resolve().parent / "csrc"
    for name in ("pair.cuh", "pack.cu"):
        m = re.search(r"constexpr int kMaxSystems = (\d+);",
                      (csrc / name).read_text())
        assert m and int(m.group(1)) == MAX_SYSTEMS == 65535, name


def test_packed_tile_across_a_system_boundary_changes_no_plain_bit():
    """Tiles that do not divide a system's 9 rows (a tiling of the flat
    batch list would put one across two systems) give each system its own
    rows."""
    dom, states = _stacked((3, 3, 4), 3, 60, seed=11, periodic=True)
    bins = bin_particles(dom, states.positions, m_c=16)
    pk = pack_rows(dom, bins, 40)
    args = (pk.planes, pk.slot_id, pk.slot_cell, pk.cell_offsets, None)
    kw = dict(nx=3, ny=3, m_c=16, kernel=api.make_lennard_jones(),
              cutoff2=1.0)
    want = [XP.xpencil_packed_forces(*(system(pk, i).planes,
                                       system(pk, i).slot_id,
                                       system(pk, i).slot_cell,
                                       system(pk, i).cell_offsets, None),
                                     **kw) for i in range(3)]
    for r in (None, 0, 2, 4, 7, XP.MAX_TILE_ROWS):
        got = XP.xpencil_packed_forces(*args, tile_rows=r, **kw)
        for i in range(3):
            assert all(torch.equal(g[i], w) for g, w in zip(got, want[i]))


# ---------------------------------------------------------------------------
# against JAX's execute_batch
# ---------------------------------------------------------------------------

# every strategy and layout of the reference backend, the occupancy
# compaction once (the others equal their dense layouts bit for bit above),
# and JAX's Pallas kernel; each JAX case compiles its own vmapped executor
JAX_CASES = [  # strategy, layout, compact, backend
    ("par_part", "dense", False, "reference"),
    ("cell_dense", "dense", False, "reference"),
    ("xpencil", "dense", False, "reference"),
    ("xpencil", "dense", True, "reference"),
    ("allin", "dense", False, "reference"),
    ("xpencil", "packed", False, "reference"),
    ("cell_dense", "sfc", False, "reference"),
    ("xpencil", "dense", False, "pallas"),
]


@pytest.mark.parametrize("strategy,layout,compact,backend", JAX_CASES,
                         ids=["-".join(map(str, c)) for c in JAX_CASES])
def test_execute_batch_matches_jax(strategy, layout, compact, backend):
    """Periodic, a field, a (B, N) mask with a fully invalid system. The
    port's plan (on "cuda", the plain versions, for JAX's Pallas case) and
    JAX's take the same bounds; every system within scale-relative 3e-4,
    the padding rows of real systems and the invalid system included."""
    jdom = JDomain(box=(4.0, 3.0, 3.0), ncells=(4, 3, 3), cutoff=1.0,
                   periodic=True)
    jk = j_lj()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    _, states = _stacked((4, 3, 3), 3, 60, seed=12, periodic=True,
                         field=True, mask=True)
    port_backend = "cuda" if backend == "pallas" else "reference"
    p = _covering_plan(dom, states, kernel=kern, strategy=strategy,
                       layout=layout, compact=compact, backend=port_backend)
    jp = j_plan(jdom, jk, m_c=p.m_c, strategy=strategy, backend=backend,
                interpret=True if backend == "pallas" else None,
                compact=compact, max_active=p.max_active, layout=layout,
                row_cap=p.row_cap, pair_cap=p.pair_cap, box=p.box)
    jf, ju = jp.execute_batch(JState(
        jnp.asarray(states.positions.numpy()),
        {k: jnp.asarray(v.numpy()) for k, v in states.fields.items()},
        jnp.asarray(states.valid.numpy())))
    f, u = p.execute_batch(states)
    for i in range(3):
        for got, want in ((f[i], jf[i]), (u[i], ju[i])):
            want = np.asarray(want)
            scale = max(float(np.abs(want).max()), 1.0)
            np.testing.assert_allclose(got.numpy(), want, rtol=3e-4,
                                       atol=3e-4 * scale)
    assert not bool(f[1].any())
