"""The port's cost model (``core/traffic.py``) and ``strategy="auto"``
against the JAX package's.

The model is plain arithmetic, so its numbers must equal JAX's to 1e-12
relative wherever both are given the same ``allin`` sub-box:
``hbm_bytes_per_interaction`` (the one field a decision reads),
``reuse_factor``, ``padded_work_fraction`` and ``grid_steps``.
``staged_bytes_per_step`` is the port's own: the shared memory of the
port's kernel for each schedule, read from the kernel modules. Without a
sub-box the port sizes one for a block's shared memory, so
``choose_strategy`` is held against JAX's at JAX's sub-box, and
``plan(strategy="auto")`` at division 16, where both sizings leave
All-in-SM first.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import Domain as JDomain
from repro.core import choose_strategy as j_choose, plan as j_plan
from repro.core import strategies as JS
from repro.core import traffic as JT
from repro_torch.convert import domain_from_jax
from repro_torch.core import (Domain, choose_strategy, plan,
                              supports_compact)
from repro_torch.core import strategies as S
from repro_torch.core import traffic as T
from repro_torch.kernels.allin import halo_bytes
from repro_torch.kernels.sfc import sfc_warp_smem_bytes
from repro_torch.kernels.xpencil import (chunk_cells, packed_smem_bytes,
                                         packed_tile_rows, pencil_smem_bytes)
from test_torch_sparse import blob

torch.set_num_threads(1)

REL = 1e-12
DIVISIONS = [3, 5, 8, 16, 64]
M_CS = [8, 24, 40, 104]
PPCS = [0.5, 1.0, 4.0, 10.0, 100.0]
SHARED_FIELDS = ("hbm_bytes_per_interaction", "reuse_factor",
                 "padded_work_fraction", "grid_steps")


def _doms(division, periodic):
    jdom = JDomain.cubic(division, cutoff=1.0, periodic=periodic)
    return jdom, domain_from_jax(jdom)


def _same(got, want, what):
    for f in SHARED_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a == pytest.approx(b, rel=REL, abs=0.0), (what, f, a, b)
    assert got.strategy == want.strategy, what


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("division", DIVISIONS)
def test_model_equals_jax_at_the_same_subbox(division, periodic):
    jdom, dom = _doms(division, periodic)
    for m_c in M_CS:
        for box in {JS.subbox_dims(jdom, m_c), S.subbox_dims(dom, m_c)}:
            for ppc in PPCS:
                got = T.model(dom, m_c, ppc, subbox=box)
                want = JT.model(jdom, m_c, ppc, subbox=box)
                assert set(got) == set(want)
                for name in want:
                    _same(got[name], want[name], (m_c, box, ppc, name))


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("division", DIVISIONS)
def test_layout_reports_equal_jax(division, periodic):
    """compact, packed, packed + compact and sfc reports."""
    jdom, dom = _doms(division, periodic)
    for m_c in M_CS:
        box = JS.subbox_dims(jdom, m_c)
        for ppc in PPCS:
            got_m = T.model(dom, m_c, ppc, subbox=box)
            want_m = JT.model(jdom, m_c, ppc, subbox=box)
            for name in want_m:
                for fill in (0.0, 0.3, 1.0):
                    _same(T.compact_report(got_m[name], fill),
                          JT.compact_report(want_m[name], fill),
                          (m_c, ppc, name, "compact", fill))
                got_p = T.packed_report(got_m[name], m_c, ppc, dom)
                want_p = JT.packed_report(want_m[name], m_c, ppc)
                _same(got_p, want_p, (m_c, ppc, name, "packed"))
                _same(T.compact_report(got_p, 0.4),
                      JT.compact_report(want_p, 0.4),
                      (m_c, ppc, name, "packed+compact"))
            for csize in (None, 1, 4, 8):
                for fill in (0.0, 0.3, 1.0):
                    _same(T.sfc_report(dom, m_c, ppc, csize=csize,
                                       fill=fill),
                          JT.sfc_report(jdom, m_c, ppc, csize=csize,
                                        fill=fill),
                          (m_c, ppc, "sfc", csize, fill))


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("division", DIVISIONS)
def test_candidate_cost_equals_jax_on_every_branch(division, periodic):
    jdom, dom = _doms(division, periodic)
    for m_c in M_CS:
        box = JS.subbox_dims(jdom, m_c)
        for ppc in PPCS:
            for strategy in ("par_part", "cell_dense", "xpencil", "allin",
                             "naive_n2"):
                for layout in ("dense", "packed", "sfc"):
                    for compact, fill in ((False, 1.0), (True, 0.25),
                                          (True, 1.0)):
                        kw = dict(subbox=box, compact=compact, fill=fill,
                                  layout=layout)
                        got = T.candidate_cost(dom, m_c, ppc, strategy, **kw)
                        want = JT.candidate_cost(jdom, m_c, ppc, strategy,
                                                 **kw)
                        assert got == pytest.approx(want, rel=REL, abs=0.0), (
                            m_c, ppc, strategy, layout, compact)


@pytest.mark.parametrize("ncells,periodic", [
    ((64, 64, 64), False), ((16, 16, 16), True), ((5, 3, 8), False),
    ((12, 1, 2), True)])
def test_staged_bytes_are_the_port_kernels_shared_memory(ncells, periodic):
    dom = Domain(box=tuple(float(n) for n in ncells), ncells=ncells,
                 cutoff=1.0, periodic=periodic)
    nx, ny, nz = ncells
    for m_c in (8, 24, 40, 104):
        box = S.subbox_dims(dom, m_c)
        for ppc in (1.0, 4.0, 10.0):
            rep = T.model(dom, m_c, ppc)
            assert rep["allin"].staged_bytes_per_step == halo_bytes(box, m_c)
            assert rep["xpencil"].staged_bytes_per_step == \
                pencil_smem_bytes(chunk_cells(nx, m_c), m_c)
            cells = nx + 2 * periodic
            row_cap = -(-max(1, int(ppc * cells * 1.25 + 0.999)) // 8) * 8
            assert T.model_row_cap(dom, ppc) == row_cap
            packed = T.packed_report(rep["xpencil"], m_c, ppc, dom)
            assert packed.staged_bytes_per_step == packed_smem_bytes(
                packed_tile_rows(row_cap, nz * ny), row_cap)
            assert T.packed_report(
                rep["xpencil"], m_c, ppc, dom, row_cap=4000
            ).staged_bytes_per_step == packed_smem_bytes(
                packed_tile_rows(4000, nz * ny), 4000)
            for csize in (1, 4, 8):
                assert T.sfc_report(dom, m_c, ppc, csize=csize
                                    ).staged_bytes_per_step == \
                    sfc_warp_smem_bytes(csize, m_c)
            # no kernel of the port: the JAX package's formula
            assert rep["cell_dense"].staged_bytes_per_step == 2 * 16 * m_c
            assert rep["par_part"].staged_bytes_per_step == 0
    # the figure the docs quote: kernel E's block at m_c 24, box (4, 4, 4)
    assert T.model(dom, 24, 4.0, subbox=(4, 4, 4))[
        "allin"].staged_bytes_per_step == 82944


AMONGS = [None, ("cell_dense", "xpencil", "allin"), ("xpencil",),
          ("cell_dense",), ("par_part", "cell_dense"), ("xpencil", "allin"),
          ("par_part", "xpencil")]


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("division", DIVISIONS)
def test_choose_strategy_equals_jax_at_the_same_subbox(division, periodic):
    jdom, dom = _doms(division, periodic)
    for m_c in M_CS:
        box = JS.subbox_dims(jdom, m_c)
        for ppc in PPCS:
            for among in AMONGS:
                assert choose_strategy(dom, m_c, ppc, among=among,
                                       subbox=box) == \
                    j_choose(jdom, m_c, ppc, among=among), (m_c, ppc, among)


def test_auto_at_division_64_picks_allin_as_the_paper_regime_says():
    """The JAX model gives allin 1.9 B per interaction against xpencil's
    9.2 at division 64, m_c 24, 4 per cell. The port's shared-memory
    sub-box leaves allin first while it is at least (2, 2, 2), up to m_c
    227; from m_c 228 its thinner boxes stage more than the X-pencil's
    rows. The box stays bigger than (1, 1, 1) up to m_c 403, and kernel E
    takes the (1, 1, 1) box up to m_c 538."""
    jdom, dom = _doms(64, False)
    assert JT.model(jdom, 24, 4.0)["allin"].hbm_bytes_per_interaction < 2.0
    bpi = {k: r.hbm_bytes_per_interaction
           for k, r in T.model(dom, 24, 4.0).items()}
    assert min(bpi, key=bpi.get) == "allin"
    assert bpi["xpencil"] == pytest.approx(9.1666666666, rel=1e-9)
    assert choose_strategy(dom, 24, 4.0) == "allin"
    assert S.subbox_dims(dom, 227) == (2, 2, 2)
    assert choose_strategy(dom, 227, 4.0) == "allin"
    assert choose_strategy(dom, 228, 4.0) == "xpencil"
    assert S.subbox_dims(dom, 403) != (1, 1, 1)
    assert S.subbox_dims(dom, 404) == (1, 1, 1)
    assert halo_bytes((1, 1, 1), 538) <= S.SMEM_BUDGET_BYTES < \
        halo_bytes((1, 1, 1), 539)


def _scenes(division=16):
    jdom = JDomain.cubic(division, cutoff=1.0)
    rng = np.random.default_rng(7)
    for ppc in (1, 4, 10):
        n = ppc * jdom.n_cells
        uniform = (rng.random((n, 3)) * np.asarray(jdom.box)).astype(
            np.float32)
        yield f"uniform-ppc{ppc}", jdom, uniform
        yield f"blob-ppc{ppc}", jdom, blob(division, n, seed=ppc,
                                           sigma_frac=0.25)[1]


VARIANTS = [dict(), dict(compact=True), dict(layout="packed"),
            dict(layout="sfc")]


@pytest.mark.parametrize("name,jdom,pos", [
    pytest.param(*scene, id=scene[0]) for scene in _scenes()])
def test_plan_auto_picks_jax_strategy(name, jdom, pos):
    dom = domain_from_jax(jdom)
    tpos = torch.from_numpy(pos)
    for kw in VARIANTS:
        want = j_plan(jdom, positions=jnp.asarray(pos), strategy="auto",
                      backend="reference", **kw)
        got = plan(dom, positions=tpos, device="cpu", backend="reference",
                   **kw)
        assert got.strategy == want.strategy, (name, kw)
        assert got.m_c == want.m_c, (name, kw)
        assert got.traffic_report(pos.shape[0] / dom.n_cells).strategy == \
            got.strategy


def test_auto_compact_on_cuda_raises_at_plan_time():
    """``compact=True`` narrows the pick to the cell schedules; at division
    16 the model picks allin, which ``"cuda"`` runs dense only. The plan
    raises, as JAX's does on ``"pallas"``, instead of choosing another."""
    _, jdom, pos = next(_scenes())
    dom = domain_from_jax(jdom)
    tpos = torch.from_numpy(pos)
    assert not supports_compact("cuda", "allin")
    assert plan(dom, positions=tpos, device="cpu", backend="reference",
                compact=True).strategy == "allin"
    with pytest.raises(ValueError, match="no compacted path.*'allin'"):
        plan(dom, positions=tpos, device="cpu", compact=True)
    assert plan(dom, positions=tpos, device="cpu").strategy == "allin"
    assert plan(dom, positions=tpos, device="cpu",
                layout="packed", compact=True).strategy == "xpencil"


def test_auto_compact_narrows_and_small_grids_keep_the_ports_box():
    """At division 3 and 0.25 per cell the model puts Par-Part first;
    ``compact=True`` narrows the pick to the cell schedules. There the
    port's sub-box, sized for at least 132 blocks, is (1, 1, 1) where JAX's
    VMEM sizing stages the whole grid, so the port picks the X-pencil and
    JAX All-in-SM: below about division 12 the two packages' ``"auto"``
    differ by design (at JAX's sub-box they agree, as tested above)."""
    jdom = JDomain.cubic(3, cutoff=1.0)
    dom = domain_from_jax(jdom)
    pos = (np.random.default_rng(1).random((6, 3)) * 3.0).astype(np.float32)
    tpos = torch.from_numpy(pos)
    kw = dict(positions=tpos, device="cpu", backend="reference")
    assert plan(dom, **kw).strategy == "par_part"
    assert plan(dom, compact=True, **kw).strategy == "xpencil"
    assert S.subbox_dims(dom, 8) == (1, 1, 1)
    assert j_plan(jdom, positions=jnp.asarray(pos), backend="reference",
                  compact=True).strategy == "allin"


def test_auto_needs_positions():
    with pytest.raises(ValueError, match='strategy="auto" needs positions'):
        plan(Domain.cubic(3), m_c=8, device="cpu")
    with pytest.raises(ValueError, match="needs either m_c or positions"):
        plan(Domain.cubic(3), device="cpu")
