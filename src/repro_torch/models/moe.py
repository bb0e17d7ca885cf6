"""Top-k MoE with sort-based dispatch: the paper's binning pipeline reused.

The port of ``repro/models/moe.py``. Token dispatch to expert-capacity
buffers is the paper's particle binning problem: experts are cells,
capacity is M_C, and the pipeline is count -> prefix sum -> rank in cell
-> dense slot scatter. The expert offsets come from the paper's §6 scan
through ``kernels.prefix_sum.prefix_sum``, as the particle binning's cell
offsets do (``core/binning.py``): on the card every MoE layer launches
kernel A once a call, on the CPU the scan is ``paper_prefix_sum``.

Capacity overflow drops assignments (their tokens pass through the
residual), GShard's semantics: an assignment past its expert's capacity
goes to a dump row past the last expert's buffer, which is sliced off (JAX
scatters it out of bounds with ``mode="drop"``).

Dispatch is *grouped*, as JAX's: the tokens are viewed as (G, T/G) with G
the number of data-parallel shards of the active mesh (``_dp_groups``, 1
without a mesh), and the binning runs per group, so sorts and scatters
never cross a DP shard. The ``constrain`` calls pin the dispatch chain to
JAX's layouts on a mesh (``dist/sharding.py``) and do nothing without one.

Where the port differs: ``lax.top_k`` puts the lower index first among equal
probabilities; ``torch.topk`` promises no order, so the port takes the
top k of a stable descending sort. The combine gathers each token's k
assignments back into (token, k) order and sums them there, where JAX
segment-sums them in expert order; for k = 2 the two sums are the same
bits. The expert GEMMs are ``torch.bmm`` where JAX has einsums.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..core.prefix import exclusive_prefix_sum
from ..dist.sharding import (axis_names, axis_size, constrain, current_mesh,
                             per_shard)
from ..kernels.prefix_sum import prefix_sum
from .layers import _act, _normal

Tensor = torch.Tensor


def init_moe(gen: torch.Generator, d: int, f: int, n_experts: int, dtype,
             device, out: Optional[Dict[str, Tensor]] = None
             ) -> Dict[str, Tensor]:
    """Router (fp32) and expert weights (E, d, f), (E, d, f), (E, f, d).

    The expert weights are drawn one expert at a time, into ``out``'s
    tensors where given (the stacked layers' views), so no fp32 draw of a
    whole expert tensor exists (17.8 GB for one arctic-480b ``w_gate``)."""
    s_in, s_out = d ** -0.5, f ** -0.5
    router = _normal(gen, (d, n_experts), s_in, torch.float32, device)
    if out is None:
        out = {"w_gate": torch.empty((n_experts, d, f), dtype=dtype,
                                     device=device),
               "w_up": torch.empty((n_experts, d, f), dtype=dtype,
                                   device=device),
               "w_down": torch.empty((n_experts, f, d), dtype=dtype,
                                     device=device)}
    for name, std in (("w_gate", s_in), ("w_up", s_in), ("w_down", s_out)):
        w = out[name]
        for i in range(n_experts):
            w[i] = _normal(gen, tuple(w.shape[1:]), std, dtype, device)
    return {"router": router, **out}


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    cap = int(n_tokens * top_k * capacity_factor / n_experts) + 1
    return max(8, -(-cap // 8) * 8)   # pad to sublane multiple


def _ep(n_experts: int) -> bool:
    """True when the active mesh can shard the expert dim (EP)."""
    mesh = current_mesh()
    if mesh is None or "model" not in axis_names(mesh):
        return False
    return n_experts % axis_size(mesh, "model") == 0


def _dp_groups() -> int:
    """Number of data-parallel shards in the active mesh (1 when unset)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    g = 1
    for a in ("pod", "data"):
        if a in axis_names(mesh):
            g *= axis_size(mesh, a)
    return g


def _row_scan(counts: Tensor) -> Tensor:
    """Inclusive scan of each row of (G, E) int32 counts. Kernel A takes
    one group as a rank-1 tensor; several groups (a mesh, which only the
    dry run's host tensors have) take the plain scan along the last
    axis."""
    if counts.shape[0] == 1:
        return prefix_sum(counts.reshape(-1)).view_as(counts)
    return prefix_sum(counts)


class Routing(NamedTuple):
    """One dispatch's binning, over the A = T * k assignments (with a
    leading group dim G where ``route`` was given one).

    ``gate_idx``/``gate_vals`` (T, k) are each token's experts and their
    renormalised gates; ``counts``/``offsets`` (E,) int32 the assignments
    per expert and their exclusive scan (kernel A on the card); ``order``
    (A,) the stable sort of the assignments by expert, ``rank`` each sorted
    assignment's place in its expert, ``slot`` its row of the (E * cap)
    buffer (``E * cap``, the dump row, where ``keep`` is False), ``tok``
    its token, ``w`` its gate and ``unsort`` the inverse of ``order``."""
    probs: Tensor
    gate_idx: Tensor
    gate_vals: Tensor
    counts: Tensor
    offsets: Tensor
    order: Tensor
    rank: Tensor
    slot: Tensor
    keep: Tensor
    tok: Tensor
    w: Tensor
    unsort: Tensor
    cap: int


def route(xt: Tensor, router: Tensor, top_k: int, cap: int) -> Routing:
    """Router (fp32), top k, and the binning of the assignments into
    expert buffers of ``cap`` rows. xt (T, d), or (G, T, d) binned per
    group (on a mesh, each shard bins its own groups)."""
    if xt.dim() == 2:
        r = route(xt[None], router, top_k, cap)
        return Routing(*(f[0] for f in r[:-1]), cap)
    fields = per_shard(_route_groups, xt, router, top_k=top_k, cap=cap,
                       n_out=len(Routing._fields) - 1)
    return Routing(*fields, cap)


def _route_groups(xt: Tensor, router: Tensor, *, top_k: int, cap: int):
    """``route``'s fields over (G, T, d) tokens, ``cap`` left out."""
    g, t, _ = xt.shape
    e = router.shape[-1]
    dev = xt.device
    probs = torch.softmax(xt.float() @ router, dim=-1)        # (G, T, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :top_k], idx[..., :top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    a = t * top_k
    flat_e = gate_idx.reshape(g, a)
    counts = torch.zeros((g, e), dtype=torch.int32, device=dev).scatter_add_(
        1, flat_e, torch.ones((g, a), dtype=torch.int32, device=dev))
    offsets = exclusive_prefix_sum(counts, scan=_row_scan)   # paper §6
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    arange = torch.arange(a, device=dev).expand(g, a)
    rank = arange - offsets.gather(1, sorted_e)
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank, e * cap)
    unsort = torch.empty_like(order).scatter_(1, order, arange)
    return (probs, gate_idx, gate_vals, counts, offsets, order, rank, slot,
            keep, order // top_k, gate_vals.reshape(g, a).gather(1, order),
            unsort)


def _dispatch(xt: Tensor, tok: Tensor, slot: Tensor, *, e: int,
              cap: int) -> Tensor:
    """The dense slot scatter of (G, T, d) tokens into (G, E, cap, d)
    expert buffers: slots are unique but the dump row's, cut off."""
    g, _, d = xt.shape
    x_sorted = xt.gather(1, tok[..., None].expand(-1, -1, d))
    xbuf = xt.new_zeros((g, e * cap + 1, d)).scatter(
        1, slot[..., None].expand(-1, -1, d), x_sorted)
    return xbuf[:, :e * cap].reshape(g, e, cap, d)


def _combine(yb: Tensor, slot: Tensor, keep: Tensor, w: Tensor,
             unsort: Tensor, *, top_k: int) -> Tensor:
    """Each assignment's expert output gathered from (G, E * cap, d),
    weighted (fp32, as JAX's bf16 * f32 promotes), and each token's k
    summed in (token, k) order -> (G, T, d)."""
    g, ec, d = yb.shape
    y = yb.gather(1, slot.clamp_max(ec - 1)[..., None].expand(-1, -1, d))
    y = y * (keep * w)[..., None]
    out = y.gather(1, unsort[..., None].expand(-1, -1, d))
    return out.view(g, -1, top_k, d).sum(2)


def moe_mlp(x: Tensor, p: Dict[str, Tensor], *, top_k: int,
            capacity_factor: float, act: str = "silu"):
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar).

    aux_loss is the standard load-balancing loss (Switch §2.2). Where
    ``moe_mlp.log`` is a list, each call appends its :class:`Routing`
    (over (T,) without a mesh, over (G, T/G) with one). On a mesh the
    routing, the slot scatter and the combine run on each shard's groups
    (``per_shard``); the expert GEMMs run on the mesh, EP or TP by the
    ``constrain`` calls."""
    b, s, d = x.shape
    t = b * s
    e = p["router"].shape[-1]
    g = _dp_groups()
    if t % g:
        g = 1
    tl = t // g                                            # tokens per group
    cap = moe_capacity(tl, e, top_k, capacity_factor)
    xt = constrain(x.reshape(g, tl, d), "dp", None, None)
    r = route(xt, p["router"], top_k, cap)
    if moe_mlp.log is not None:
        moe_mlp.log.append(r if g > 1 else
                           Routing(*(f[0] for f in r[:-1]), cap))

    xbuf = per_shard(_dispatch, xt, r.tok, r.slot, e=e, cap=cap)
    xbuf = constrain(xbuf, "dp", "tp", None, None)  # (G dp, E ep, cap, d)
    # the expert GEMMs batched over E, each over its G * cap rows
    xe = xbuf.transpose(0, 1).reshape(e, g * cap, d)
    h = _act(torch.bmm(xe, p["w_gate"]), act) * torch.bmm(xe, p["w_up"])
    h = h.reshape(e, g, cap, -1).transpose(0, 1)
    h = (constrain(h, "dp", "tp", None, None) if _ep(e) else
         constrain(h, "dp", None, None, "tp"))     # TP within expert (grok)
    ybuf = torch.bmm(h.transpose(0, 1).reshape(e, g * cap, -1), p["w_down"])
    ybuf = constrain(ybuf.reshape(e, g, cap, d).transpose(0, 1),
                     "dp", "tp", None, None)
    yb = constrain(ybuf.reshape(g, e * cap, d), "dp", None, None)
    out = per_shard(_combine, yb, r.slot, r.keep, r.w, r.unsort,
                    top_k=top_k)
    out = constrain(out, "dp", None, None)

    frac_tokens = r.counts.float().sum(0) / (t * top_k)
    aux = e * torch.sum(frac_tokens * r.probs.mean((0, 1)))
    return out.reshape(b, s, d).to(x.dtype), aux


moe_mlp.log = None
