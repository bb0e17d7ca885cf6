"""Role-based sharding rules (port of ``repro.dist.sharding``).

Model code never names mesh axes; it names *roles*:

    x = constrain(x, "dp", None, "tp")     # batch over DP, last dim over TP

and this module resolves roles against the active mesh: "dp" is the data
hierarchy (``("pod", "data")``, plus "model" when the config runs pure
DP), "tp" is the "model" axis. Outside any mesh context ``constrain`` is a
no-op, which is what lets the same model run on one device and, as
DTensors, on a production mesh unchanged.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh``; its axis names
are its ``mesh_dim_names``. A spec is a tuple with one entry per tensor
dim: ``None``, an axis name or a tuple of axis names, the values of JAX's
``PartitionSpec``. ``placements`` turns a spec into DTensor placements:
``Shard(d)`` on each mesh dim that entry ``d`` names, ``Replicate()`` on
the others. ``constrain`` is JAX's ``with_sharding_constraint`` in
DTensor's terms: it redistributes a DTensor to the spec.

``sanitize`` enforces GSPMD's divisibility rule: a spec entry whose axis
product does not divide the dimension is dropped (to ``None``) rather than
left to shard unevenly.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch

Spec = Tuple[Any, ...]

_STATE = threading.local()


def set_pure_dp(flag: bool) -> None:
    """Small models fold the model axis into DP (no tensor parallelism)."""
    _STATE.pure_dp = bool(flag)


def _pure_dp() -> bool:
    return getattr(_STATE, "pure_dp", False)


class use_mesh:
    """``with use_mesh(mesh):`` makes ``mesh`` the resolution target for
    in-model ``constrain`` calls (and for the MoE's dispatch groups), the
    previous one restored on the way out."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.prev = getattr(_STATE, "mesh", None)
        _STATE.mesh = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        _STATE.mesh = self.prev


def current_mesh():
    return getattr(_STATE, "mesh", None)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    return int(mesh.size(axis_names(mesh).index(name)))


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(axis_size(mesh, n) for n in names)


def _spec(entries) -> Spec:
    """A spec of ``entries``, a one-name tuple entry as that name (as
    JAX's ``PartitionSpec`` stores it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def sanitize(mesh, spec: Spec, shape) -> Spec:
    """Drop spec entries whose mesh-axis product doesn't divide the dim."""
    out = []
    for entry, dim in zip(spec, shape):
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            entry = None
        out.append(entry)
    return _spec(out)


def _role_axes(mesh, role: Optional[str]):
    names = axis_names(mesh)
    if role is None:
        return None
    if role == "dp":
        axes = [a for a in ("pod", "data") if a in names]
        if _pure_dp() and "model" in names:
            axes.append("model")
        return tuple(axes) if axes else None
    if role == "tp":
        return "model" if ("model" in names and not _pure_dp()) else None
    if role in names:                      # raw axis name passes through
        return role
    raise ValueError(f"unknown sharding role {role!r}")


def role_size(role: Optional[str]) -> int:
    """How many ways ``role`` splits a dim on the active mesh (1 without
    one)."""
    mesh = current_mesh()
    if mesh is None or not axis_names(mesh):
        return 1
    return _axis_size(mesh, _role_axes(mesh, role))


def placements(mesh, spec: Spec):
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that entry ``d`` names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(name)] = Shard(d)
    return out


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (laid out on a mesh). A plain tensor is
    told apart first, at no cost on the single-device path."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *roles):
    """``with_sharding_constraint`` by role: a DTensor is redistributed to
    the resolved, sanitized spec; anything else, or any tensor without an
    active mesh, comes back unchanged."""
    mesh = current_mesh()
    if mesh is None or not axis_names(mesh) or not is_dtensor(x):
        return x
    spec = sanitize(mesh, tuple(_role_axes(mesh, r) for r in roles),
                    x.shape)
    want = placements(mesh, spec)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def replicate_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` unsharded: a DTensor sharded along it
    is gathered on those mesh dims, its other placements kept. Anything
    else comes back unchanged (the port's layer loop ``unbind``s the
    stacked layer dim, which DTensor will not split across shards)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def keep_whole(x, dim: int, n: int):
    """``x`` with tensor dim ``dim`` gathered unless the shards along it
    divide ``n``: a dim of ``n`` heads (or groups) is split only at their
    boundaries, where DTensor will reshape it into (n, ...). Anything but
    a DTensor comes back unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard
    dim %= x.ndim
    ways = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim == dim)
    return x if n % ways == 0 else replicate_dim(x, dim)


def constrain_like(x, like):
    """``x`` redistributed to ``like``'s placements where both are
    DTensors (same rank); anything else comes back unchanged."""
    if not (is_dtensor(x) and is_dtensor(like)) \
            or list(x.placements) == list(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def per_shard(fn, *tensors, n_out: int = 0, **kwargs):
    """``fn(*tensors, **kwargs)`` run on every shard's local tensors
    (DTensor's ``local_map``), each output laid out as the first DTensor
    argument: for work that is independent along every sharded dim, such
    as attention over (batch, head) blocks or the MoE dispatch over its
    groups. ``n_out`` > 0 says that ``fn`` returns a tuple of that many
    tensors. Without DTensors a plain call."""
    if not any(is_dtensor(t) for t in tensors):
        return fn(*tensors, **kwargs)
    from torch.distributed.tensor.experimental import local_map
    first = next(t for t in tensors if is_dtensor(t))
    out = list(first.placements)
    return local_map(lambda *ts: fn(*ts, **kwargs),
                     out_placements=tuple([out] * n_out) if n_out else out,
                     in_placements=tuple(t.placements if is_dtensor(t)
                                         else None for t in tensors),
                     device_mesh=first.device_mesh)(*tensors)


# --------------------------------------------------------------------------
# spec trees (params / optimizer / batch / kv-cache)
# --------------------------------------------------------------------------

def _leaf_spec(mesh, shape) -> Spec:
    """FSDP-flavoured default: biggest divisible dim over DP, and (2-D+
    leaves) the last other divisible dim over TP."""
    dp = _role_axes(mesh, "dp")
    tp = _role_axes(mesh, "tp")
    entries = [None] * len(shape)
    if shape:
        dp_dim = None
        if dp is not None:
            divisible = [i for i, d in enumerate(shape)
                         if d % _axis_size(mesh, dp) == 0 and d > 1]
            if divisible:
                dp_dim = max(divisible, key=lambda i: shape[i])
                entries[dp_dim] = dp
        if tp is not None and len(shape) >= 2:
            for i in range(len(shape) - 1, -1, -1):
                if i != dp_dim and shape[i] % _axis_size(mesh, tp) == 0 \
                        and shape[i] > 1:
                    entries[i] = tp
                    break
    return _spec(entries)


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's, or the first item of a
    ``(shape, dtype)`` pair (``input_specs``, ``cache_spec``)."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(leaf[0])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _shard_tree(mesh, tree):
    def one(leaf):
        shape = _shape(leaf)
        spec = _leaf_spec(mesh, shape) if shape else ()
        return sanitize(mesh, spec, shape)
    return _tree_map(one, tree)


def params_shardings(cfg, mesh, params):
    set_pure_dp(getattr(cfg, "pure_dp", False))
    return _shard_tree(mesh, params)


def opt_shardings(cfg, mesh, opt, params):
    """Optimizer moments shard exactly like the params (ZeRO)."""
    set_pure_dp(getattr(cfg, "pure_dp", False))
    return _shard_tree(mesh, opt)


def batch_shardings(cfg, mesh, batch: Dict):
    set_pure_dp(getattr(cfg, "pure_dp", False))
    dp = _role_axes(mesh, "dp")

    def one(leaf):
        shape = _shape(leaf)
        spec = (dp,) + (None,) * (len(shape) - 1) if shape else ()
        return sanitize(mesh, spec, shape)
    return _tree_map(one, batch)


def cache_shardings(cfg, mesh, cache):
    """KV caches: batch dim over DP, head dim (when present) over TP."""
    set_pure_dp(getattr(cfg, "pure_dp", False))
    return _shard_tree(mesh, cache)


def distribute(mesh, tree, specs):
    """Each tensor of ``tree`` as a DTensor laid out by its spec in
    ``specs`` (a tree of the same shape, from the ``*_shardings`` rules)."""
    from torch.distributed.tensor import distribute_tensor

    def go(t, s):
        if isinstance(t, dict):
            return {k: go(t[k], s[k]) for k in t}
        return distribute_tensor(t, mesh, placements(mesh, s))
    return go(tree, specs)
