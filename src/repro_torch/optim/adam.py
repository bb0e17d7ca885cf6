"""AdamW over the params dict (port of ``repro.optim.adam``).

Plain functions, not ``torch.optim``: the state is JAX's dict ``{"m", "v",
"step"}`` with the moments mirroring the params tree in ``moment_dtype``
(fp32 by default) and ``step`` a 0-d int32 tensor on the params' device, so
a step needs no host sync. The update math runs in fp32: global-norm
clipping, the cosine or constant schedule with linear warmup, bias
correction with ``b1 ** step`` in fp32, and decoupled weight decay on
leaves with ``ndim >= 2`` only (no decay on norms and scalars).

Where JAX donates its buffers, the port updates in place: ``adam_update``
writes the new params and moments into the tensors it is given, under
``torch.no_grad()``, and returns the same dicts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    schedule: str = "cosine"         # cosine | constant
    warmup_steps: int = 100
    total_steps: int = 10_000


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The tensor leaves of nested dicts, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_leaves(tree[k])
    else:
        yield tree


def init_opt_state(params: Tree, cfg: AdamConfig) -> Dict[str, Any]:
    """Zero moments in ``cfg.moment_dtype`` beside each leaf, step 0."""
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt,  # noqa: E731
                                  device=p.device)
    device = next(tree_leaves(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def lr_at(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in fp32."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(sum(torch.sum(l.float() ** 2)
                          for l in tree_leaves(tree)))


@torch.no_grad()
def adam_update(params: Tree, grads: Tree, state: Dict[str, Any],
                cfg: AdamConfig) -> Tuple[Tree, Dict[str, Any]]:
    """-> (params, state), both updated in place. Everything fp32
    internally; params keep their dtype, moments ``moment_dtype``."""
    step = state["step"] + 1
    scale = None
    if cfg.grad_clip > 0:
        gn = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    sf = step.float()
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)
    b1, b2 = cfg.b1, cfg.b2

    def upd(p, g, m, v):
        # JAX's expressions and roundings, with the temporaries reused in
        # place (the fp32 temporaries of the embedding table are GBs)
        gf = g.float() if scale is None else g.float() * scale
        mf = m if m.dtype == torch.float32 else m.float()
        vf = v if v.dtype == torch.float32 else v.float()
        mf.mul_(b1).add_(gf * (1.0 - b1))
        vf.mul_(b2).add_((gf * gf).mul_(1.0 - b2))
        update = (mf / c1).div_((vf / c2).sqrt_().add_(cfg.eps))
        pf = p.float()
        if cfg.weight_decay > 0 and p.dim() >= 2:
            update.add_(pf * cfg.weight_decay)
        update.mul_(lr)
        if pf is p:
            p.sub_(update)
        else:
            p.copy_(pf.sub_(update))
        if mf is not m:
            m.copy_(mf)
            v.copy_(vf)

    tree_map(upd, params, grads, state["m"], state["v"])
    state["step"] = step
    return params, state
