"""A run of each tiny cell on the CPU with the timed path broken underneath
it must come out not correct: once for each fault the cell can have."""

import dataclasses

import pytest

from bench import harness, tiny
from repro_torch.core import api
from repro_torch.serve import engine as serve_engine
from repro_torch.traj import engine as traj_engine

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")


def _altered(fn):
    """Wrap an executor method so that its forces come out 1 % off."""
    def wrapped(self, *args):
        f, u = fn(self, *args)
        return f * 1.01, u
    return wrapped


def _unchanged_step(p, integrator, co, eff_skin, mass, carry, *args):
    out, row, rebin = _STEP(p, integrator, co, eff_skin, mass, carry, *args)
    md = dataclasses.replace(carry.md, step=out.md.step)
    return dataclasses.replace(out, md=md), row, rebin


_STEP = traj_engine._step


def _half_batch(self, sc, ready):
    _DISPATCH(self, sc, ready[:(len(ready) + 1) // 2])


_DISPATCH = serve_engine.ServingEngine._dispatch_batch


def _failed_batch(self, sc, ready):
    """Every request of the dispatch answered ``"failed"``, as when each
    retry of a faulting dispatch is spent."""
    for req in ready:
        self._responses.append(serve_engine.Response(
            req.req_id, "failed", shape_class=sc.label(),
            attempts=self.max_retries + 1))


FAULTS = {
    "step returns its state unchanged": (
        "lj-melt.traj", traj_engine, "_step", _unchanged_step),
    "trajectory forces altered": (
        "lj-melt.traj", api._Executor, "forces",
        _altered(api._Executor.forces)),
    "half of a dispatch left out": (
        "lj-melt.serve", serve_engine.ServingEngine, "_dispatch_batch",
        _half_batch),
    "every dispatch answers failed": (
        "lj-melt.serve", serve_engine.ServingEngine, "_dispatch_batch",
        _failed_batch),
    "served forces altered": (
        "lj-melt.serve", api._Executor, "batch",
        _altered(api._Executor.batch)),
    "execute forces altered": (
        "wca-fluid.force", api._Executor, "single",
        _altered(api._Executor.single)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    cell, owner, attr, broken = FAULTS[fault]
    monkeypatch.setattr(owner, attr, broken)
    r = tiny.run_tiny(cell, SPEC, cell_overrides={"grace_s": 0.3}
                      if cell == "lj-melt.serve" else None)
    assert not r["correct"], r["checks"]
