"""The port's core: domain, pair kernels, binning (dense, occupancy,
packed rows, SFC clusters), schedules, plan/execute and the engine
shims."""

from . import scenarios
from .api import (InteractionPlan, ParticleState, active_unit_count,
                  get_backend, n_units, plan, register_backend,
                  suggest_max_active, suggest_pair_cap, suggest_row_cap,
                  supports_compact, supports_layout)
from .binning import (EMPTY_POS, GHOST_ID_BUMP, CellBins, Occupancy,
                      PackedRows, SfcClusters, bin_particles,
                      build_sfc_clusters, cell_counts, decode_pair_codes,
                      dense_to_particles, encode_pair_masks,
                      full_pencil_occupancy, gather_to_particles,
                      hilbert_decode, hilbert_encode, morton_decode,
                      morton_encode, pack_rows, packed_to_particles,
                      padded_row_counts, pencil_occupancy, sfc_cluster_tables,
                      sfc_pair_count, sfc_slot_tables, sfc_to_particles,
                      subbox_counts, subbox_occupancy, unpack_scatter)
from .domain import Domain
from .engine import CellListEngine, compute_interactions, suggest_m_c
from .interactions import (PairKernel, make_gravity, make_high_flop,
                           make_lennard_jones, make_low_flop, make_sph_density)

__all__ = [
    "CellBins", "CellListEngine", "Domain", "EMPTY_POS", "GHOST_ID_BUMP",
    "InteractionPlan", "Occupancy", "PackedRows", "PairKernel",
    "ParticleState", "SfcClusters", "active_unit_count", "bin_particles",
    "build_sfc_clusters", "cell_counts", "compute_interactions",
    "decode_pair_codes", "dense_to_particles", "encode_pair_masks",
    "full_pencil_occupancy", "gather_to_particles", "get_backend",
    "hilbert_decode", "hilbert_encode", "make_gravity", "make_high_flop",
    "make_lennard_jones", "make_low_flop", "make_sph_density",
    "morton_decode", "morton_encode", "n_units", "pack_rows",
    "packed_to_particles", "padded_row_counts", "pencil_occupancy", "plan",
    "register_backend", "scenarios", "sfc_cluster_tables", "sfc_pair_count",
    "sfc_slot_tables", "sfc_to_particles", "subbox_counts",
    "subbox_occupancy", "suggest_m_c", "suggest_max_active",
    "suggest_pair_cap", "suggest_row_cap", "supports_compact",
    "supports_layout", "unpack_scatter",
]
