"""Test-time machinery that ships with the library (port of
``repro.testing``).

``repro_torch.testing.chaos`` is the seeded fault-injection registry the
trajectory engine and the checkpoint writer are tested against. Production
code calls its fault points unconditionally; with no active injection
context every point is a near-zero-cost no-op.
"""

from . import chaos

__all__ = ["chaos"]
