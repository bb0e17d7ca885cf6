"""The port's core: domain, pair kernels, binning (dense, occupancy,
packed rows, SFC clusters), schedules, plan/execute, the cost model
(``strategy="auto"``), the measured autotuner (``strategy="autotune"``)
and its stopwatch, and the engine shims."""

from . import scenarios, strategies, traffic
from .api import (InteractionPlan, ParticleState, PlanHealth,
                  active_unit_count, backend_matrix, choose_strategy,
                  degradation_ladder, fallback_plan, get_backend, n_units,
                  plan, plan_health, register_backend, reset_health,
                  suggest_max_active, suggest_pair_cap, suggest_row_cap,
                  supports_compact, supports_layout)
from .binning import (EMPTY_POS, GHOST_ID_BUMP, CellBins, Occupancy,
                      PackedRows, SfcClusters, bin_particles,
                      build_sfc_clusters, cell_counts, decode_pair_codes,
                      dense_to_particles, encode_pair_masks,
                      full_pencil_occupancy, gather_pencil_rows,
                      gather_to_particles, hilbert_decode, hilbert_encode,
                      interior_to_padded, morton_decode, morton_encode,
                      pack_rows, packed_to_particles, padded_row_counts,
                      pencil_occupancy, sfc_cluster_tables, sfc_pair_count,
                      sfc_slot_tables, sfc_to_particles, subbox_counts,
                      subbox_occupancy, unpack_scatter)
from .domain import Domain
from .engine import CellListEngine, compute_interactions, suggest_m_c
from .interactions import (PairKernel, make_gravity, make_high_flop,
                           make_lennard_jones, make_low_flop, make_sph_density,
                           pair_contribution)
from .prefix import (blelloch_counts, exclusive_prefix_sum, operation_counts,
                     paper_prefix_sum)
from .timing import time_fn
from . import autotune
from .autotune import TuneResult, tune

__all__ = [
    "CellBins", "CellListEngine", "Domain", "EMPTY_POS", "GHOST_ID_BUMP",
    "InteractionPlan", "Occupancy", "PackedRows", "PairKernel",
    "ParticleState", "PlanHealth", "SfcClusters", "TuneResult",
    "active_unit_count", "autotune", "backend_matrix", "bin_particles",
    "blelloch_counts", "build_sfc_clusters", "cell_counts", "choose_strategy",
    "compute_interactions", "decode_pair_codes", "degradation_ladder",
    "dense_to_particles", "encode_pair_masks", "exclusive_prefix_sum",
    "fallback_plan", "full_pencil_occupancy", "gather_pencil_rows",
    "gather_to_particles", "get_backend", "hilbert_decode", "hilbert_encode",
    "interior_to_padded", "make_gravity", "make_high_flop",
    "make_lennard_jones", "make_low_flop", "make_sph_density", "morton_decode",
    "morton_encode", "n_units", "operation_counts", "pack_rows",
    "packed_to_particles", "padded_row_counts", "pair_contribution",
    "paper_prefix_sum", "pencil_occupancy", "plan", "plan_health",
    "register_backend", "reset_health", "scenarios", "sfc_cluster_tables",
    "sfc_pair_count", "sfc_slot_tables", "sfc_to_particles", "strategies",
    "subbox_counts", "subbox_occupancy", "suggest_m_c", "suggest_max_active",
    "suggest_pair_cap", "suggest_row_cap", "supports_compact",
    "supports_layout", "time_fn", "traffic", "tune", "unpack_scatter",
]
