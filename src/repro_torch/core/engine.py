"""The ``m_c`` bound (port of ``repro.core.engine.suggest_m_c``).

``CellListEngine`` and ``compute_interactions``, the JAX package's shims over
the plan API, are not ported yet (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import torch

from .binning import cell_counts
from .domain import Domain


def suggest_m_c(domain: Domain, positions: torch.Tensor, slack: float = 1.5,
                align: int = 8) -> int:
    """M_C choice: the max cell count times ``slack``, rounded up to a
    multiple of ``align``. Gives the same bound as the JAX package, so the
    two packages' bins can be compared slot for slot."""
    mx = int(cell_counts(domain, positions).max())
    m_c = max(1, int(mx * slack + 0.999))
    return -(-m_c // align) * align
