"""The port's Par-Part and Par-Cell schedules and engine shims against the
JAX package's.

Same inputs (numpy, from a seed) through both packages: ``par_part`` and
``cell_dense`` (dense and compacted) on the reference backend against
JAX's reference backend, and the schedules against both packages' O(N^2)
oracles, each element within rtol 3e-4 plus 3e-4 times the sizes of its
own pair terms (the tolerance of ``test_torch_xpencil.py``: the summation
order differs across frameworks). Within the port, the compacted Par-Cell
equals the dense one bit for bit, and padded input gives the real rows the
bits of unpadded input. ``CellListEngine`` and ``compute_interactions``
are held against ``naive_n2``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import ParticleState as JState
from repro.core import bin_particles as j_bin, plan as j_plan
from repro.core import strategies as JS
from repro_torch.convert import (domain_from_jax, kernel_from_jax,
                                 state_from_numpy)
from repro_torch.core import (CellListEngine, bin_particles,
                              compute_interactions, pencil_occupancy, plan,
                              suggest_m_c)
from repro_torch.core import strategies as S
from test_torch_sparse import blob
from test_torch_xpencil import J_KERNELS, _close, _term_sizes

torch.set_num_threads(1)

_J_BIN = jax.jit(j_bin, static_argnames=("domain", "m_c"))
_J_CELL = jax.jit(JS.cell_dense, static_argnames=("domain", "kernel"))
_J_NAIVE = jax.jit(JS.naive_n2, static_argnames=("domain", "kernel"))


def _naive_close(dom, state, kern, f, u, what):
    """(f, u) against the port's naive_n2, per particle within 3e-4 of the
    particle's own pair-term sizes."""
    *nf, nu = S.naive_n2(dom, state.positions, kern)
    fsize, usize = (S.naive_n2(dom, state.positions, k)[3]
                    for k in _term_sizes(kern))
    _close(f.numpy(), torch.stack(nf, -1), fsize[:, None],
           f"forces vs naive_n2, {what}")
    _close(u.numpy(), nu, usize, f"potential vs naive_n2, {what}")


# ---------------------------------------------------------------------------
# Par-Cell: the schedule's planes against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("name", ["lennard_jones", "low_flop",
                                  "sph_density"])
def test_cell_dense_planes_match_jax(name, periodic):
    jdom, pos = blob(3, 100, seed=0, periodic=periodic, sigma_frac=0.3)
    jk = J_KERNELS[name]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    m_c = suggest_m_c(dom, torch.from_numpy(pos))
    tb = bin_particles(dom, torch.from_numpy(pos), m_c=m_c)
    jb = _J_BIN(jdom, jnp.asarray(pos), m_c=m_c)
    got = S.cell_dense(dom, tb, kern)
    want = _J_CELL(jdom, jb, jk)
    fsize, usize = (S.cell_dense(dom, tb, k)[3] for k in _term_sizes(kern))
    for i, what in enumerate(("fx", "fy", "fz", "pot")):
        assert got[i].shape == (3, 3, 3, m_c)
        _close(got[i].numpy(), np.asarray(want[i]),
               usize if what == "pot" else fsize, f"{what} vs JAX cell_dense")


# ---------------------------------------------------------------------------
# plan-level: reference backends against JAX's and the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("strategy,compact", [
    ("par_part", False), ("cell_dense", False), ("cell_dense", True)],
    ids=["par_part", "cell_dense", "cell_dense-compact"])
def test_reference_plan_matches_jax_and_oracles(strategy, compact,
                                                 periodic):
    jdom, pos = blob(6, 160, seed=2, periodic=periodic, sigma_frac=0.1)
    jk = J_KERNELS["lennard_jones"]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    state = state_from_numpy(pos, device="cpu")
    p = plan(dom, kern, positions=state.positions, device="cpu",
             strategy=strategy, backend="reference", compact=compact)
    jp = j_plan(jdom, jk, positions=jnp.asarray(pos), strategy=strategy,
                backend="reference", compact=compact)
    assert (p.m_c, p.max_active) == (jp.m_c, jp.max_active)
    if compact:
        assert p.max_active < dom.nz * dom.ny        # some pencils skipped
    f, u = p.execute(state)
    jf, ju = jp.execute(JState(jnp.asarray(pos)))
    jn = _J_NAIVE(jdom, jnp.asarray(pos), jk)
    fsize, usize = (S.naive_n2(dom, state.positions, k)[3]
                    for k in _term_sizes(kern))
    for what, want_f, want_u in (
            ("JAX reference plan", jf, ju),
            ("JAX naive_n2", np.stack(jn[:3], -1), jn[3])):
        _close(f.numpy(), want_f, fsize[:, None], f"forces vs {what}")
        _close(u.numpy(), want_u, usize, f"potential vs {what}")
    _naive_close(dom, state, kern, f, u, strategy)


@pytest.mark.parametrize("name", ["low_flop", "gravity", "high_flop"])
def test_par_part_matches_naive_per_kernel(name):
    jdom, pos = blob(3, 120, seed=3, periodic=True, sigma_frac=0.3)
    dom, kern = domain_from_jax(jdom), kernel_from_jax(J_KERNELS[name]())
    state = state_from_numpy(pos, device="cpu")
    f, u = plan(dom, kern, positions=state.positions, device="cpu",
                strategy="par_part", backend="reference",
                batch_size=50).execute(state)        # ragged last chunk
    _naive_close(dom, state, kern, f, u, name)


# ---------------------------------------------------------------------------
# bit identities within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_cell_dense_compact_equals_dense_bitwise(periodic):
    jdom, pos = blob(6, 200, seed=4, periodic=periodic)
    dom = domain_from_jax(jdom)
    state = state_from_numpy(pos, device="cpu")
    dense = plan(dom, positions=state.positions, device="cpu",
                 strategy="cell_dense", backend="reference").execute(state)
    comp = plan(dom, positions=state.positions, device="cpu",
                strategy="cell_dense", backend="reference",
                compact=True).execute(state)
    for a, b in zip(comp, dense):
        assert torch.equal(a, b)
    # the sparse schedule leaves the inactive pencils' planes at 0
    bins = bin_particles(dom, state.positions, m_c=16)
    occ = pencil_occupancy(dom, bins.counts, dom.nz * dom.ny)
    out = S.cell_dense_sparse(dom, bins, plan(dom, m_c=16,
                                              device="cpu",
                                              strategy="xpencil").kernel, occ)
    empty = bins.counts.view(6, 6, 6).sum(-1) == 0
    assert bool(empty.any())
    assert not any(o[empty].any() for o in out)


@pytest.mark.parametrize("strategy", ["par_part", "cell_dense"])
def test_padded_equals_unpadded_bitwise(strategy):
    jdom, pos = blob(4, 150, seed=6, periodic=True)
    dom = domain_from_jax(jdom)
    rng = np.random.default_rng(8)
    n, n_pad = pos.shape[0], 30
    where = np.sort(rng.choice(n + n_pad, n_pad, replace=False))
    real = np.setdiff1d(np.arange(n + n_pad), where)
    padded = np.zeros((n + n_pad, 3), np.float32)
    padded[real] = pos
    padded[where] = rng.uniform(0, 4, (n_pad, 3))
    valid = np.ones(n + n_pad, bool)
    valid[where] = False
    p = plan(dom, m_c=24, device="cpu", strategy=strategy,
             backend="reference")
    f, u = p.execute(state_from_numpy(pos, device="cpu"))
    fp, up = p.execute(state_from_numpy(padded, valid=valid, device="cpu"))
    assert torch.equal(fp[real], f) and torch.equal(up[real], u)
    if strategy == "cell_dense":
        assert not fp[where].any() and not up[where].any()


# ---------------------------------------------------------------------------
# the engine shims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,backend", [
    ("xpencil", "cuda"), ("allin", "cuda"), ("cell_dense", "reference"),
    ("par_part", "reference")])
def test_engine_shims_match_naive(strategy, backend):
    jdom, pos = blob(4, 150, seed=7, periodic=False)
    dom = domain_from_jax(jdom)
    state = state_from_numpy(pos, device="cpu")
    kern = kernel_from_jax(J_KERNELS["lennard_jones"]())
    m_c = suggest_m_c(dom, state.positions)
    eng = CellListEngine(dom, kern, m_c=m_c, strategy=strategy,
                         backend=backend, device="cpu")
    assert (eng.m_c, eng.strategy, eng.plan.backend) == (m_c, strategy,
                                                         backend)
    assert eng.check_m_c(state.positions)
    assert not CellListEngine(dom, kern, m_c=1, strategy=strategy,
                              backend=backend,
                              device="cpu").check_m_c(state.positions)
    f, u = eng.compute(state.positions)
    _naive_close(dom, state, kern, f, u, f"engine {strategy}")
    f2, u2 = compute_interactions(dom, state.positions, kern,
                                  strategy=strategy, backend=backend,
                                  device="cpu")
    assert torch.equal(f, f2) and torch.equal(u, u2)
    assert eng.bin(state.positions).m_c == m_c


def test_engine_shims_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the default runs there")
    jdom, pos = blob(3, 20, seed=8)
    dom = domain_from_jax(jdom)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CellListEngine(dom)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_interactions(dom, torch.from_numpy(pos))
