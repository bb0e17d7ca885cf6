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

Where the port differs: without a device mesh JAX's ``_dp_groups()`` is 1,
so the port dispatches all tokens as one group, and JAX's ``constrain``
layout hints do nothing (``dist/sharding.py`` waits for ROADMAP Queue 1
item 13.6). ``lax.top_k`` puts the lower index first among equal
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


class Routing(NamedTuple):
    """One dispatch's binning, over the A = T * k assignments.

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
    expert buffers of ``cap`` rows. xt (T, d)."""
    t = xt.shape[0]
    e = router.shape[-1]
    dev = xt.device
    probs = torch.softmax(xt.float() @ router, dim=-1)        # (T, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :top_k], idx[:, :top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    a = t * top_k
    flat_e = gate_idx.reshape(a)
    counts = torch.zeros(e, dtype=torch.int32, device=dev).scatter_add_(
        0, flat_e, torch.ones(a, dtype=torch.int32, device=dev))
    offsets = exclusive_prefix_sum(counts, scan=prefix_sum)   # paper §6
    sorted_e, order = torch.sort(flat_e, stable=True)
    arange = torch.arange(a, device=dev)
    rank = arange - offsets[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank, e * cap)
    unsort = torch.empty_like(order).scatter_(0, order, arange)
    return Routing(probs, gate_idx, gate_vals, counts, offsets, order, rank,
                   slot, keep, order // top_k, gate_vals.reshape(a)[order],
                   unsort, cap)


def moe_mlp(x: Tensor, p: Dict[str, Tensor], *, top_k: int,
            capacity_factor: float, act: str = "silu"):
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar).

    aux_loss is the standard load-balancing loss (Switch §2.2). Where
    ``moe_mlp.log`` is a list, each call appends its :class:`Routing`."""
    b, s, d = x.shape
    t = b * s
    e = p["router"].shape[-1]
    cap = moe_capacity(t, e, top_k, capacity_factor)
    xt = x.reshape(t, d)
    r = route(xt, p["router"], top_k, cap)
    if moe_mlp.log is not None:
        moe_mlp.log.append(r)

    # dense slot scatter: slots are unique but the dump row's, cut off
    xbuf = x.new_zeros((e * cap + 1, d)).index_put((r.slot,), xt[r.tok])
    xbuf = xbuf[:e * cap].view(e, cap, d)
    h = _act(torch.bmm(xbuf, p["w_gate"]), act) * torch.bmm(xbuf, p["w_up"])
    ybuf = torch.bmm(h, p["w_down"]).reshape(e * cap, d)

    # combine: gather each assignment's expert output, weight (fp32, as
    # JAX's bf16 * f32 promotes), sum each token's k in (token, k) order
    y = ybuf[r.slot.clamp_max(e * cap - 1)] * (r.keep * r.w)[:, None]
    out = y[r.unsort].view(t, top_k, d).sum(1)

    frac_tokens = r.counts.float() / (t * top_k)
    aux = e * torch.sum(frac_tokens * r.probs.mean(0))
    return out.reshape(b, s, d).to(x.dtype), aux


moe_mlp.log = None
