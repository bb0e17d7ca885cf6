"""Distribution layer of the port (``repro.dist``'s counterpart).

Modules:
  halo       halo-exchange primitives: Z-slab partition without a host
             sync, the ghost-plane exchange of stacked shards or of one
             slab per rank, per-shard load and occupancy probes.
  engine     ``backend="halo"``: ``plan.execute`` over Z-slabs (per-shard
             binning, ghost exchange, any registered schedule per shard,
             scatter-back), the shard-level overflow contract and the
             elastic shrink after a lost shard.
  fault      straggler watchdog, restart-from-latest-checkpoint driver,
             elastic restore onto the surviving devices.
  compress   int8 gradient compression with error feedback.

``repro.dist.sharding`` (role-based sharding of the LM's tensors) is not
ported yet (ROADMAP.md Queue 1 item 13.6).
"""

from . import compress, engine, fault, halo

__all__ = ["compress", "engine", "fault", "halo"]
