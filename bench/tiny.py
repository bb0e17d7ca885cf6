"""Each cell shrunk for the CPU tests: a few hundred particles, a few
steps. A cell's file holds its own shrink under ``tiny``: ``config``, the
keys of its configuration that change, and ``cell``, those of the cell.
The widths (cutoff, density, dt) stay the configuration's, except the
Lennard-Jones melt's cutoff, cut so that its small box still holds three
cells of the reference's grid."""

from __future__ import annotations

import time

import torch

from . import harness

SECONDS = 0.2


def shrink(name: str, bench=harness.BENCH):
    """(config overrides, cell overrides) of the cell ``name``."""
    cell, _ = harness.load_cell(name, bench)
    return cell["tiny"]["config"], cell["tiny"]["cell"]


def run_tiny(name: str, spec: dict, bench=harness.BENCH, control=False,
             cell_overrides=None, seed: int = 2 ** 31 + 12345) -> dict:
    """Run a tiny cell on the CPU. A cell may pin the process's intra-op
    threads (``torch_threads``); a test process gets its own back."""
    config, cell = shrink(name, bench)
    threads = torch.get_num_threads()
    try:
        return harness.run_cell(
            name, seed, SECONDS, False, "cpu", time.perf_counter(), spec,
            bench=bench, config_overrides=config,
            cell_overrides={**cell, **(cell_overrides or {})},
            control=control)
    finally:
        torch.set_num_threads(threads)
