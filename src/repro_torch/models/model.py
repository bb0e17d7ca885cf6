"""Model assembly: init / forward / prefill / decode for all 10 families.

The port of ``repro/models/model.py``:
``dense`` (gemma2-2b, qwen1.5-0.5b, codeqwen1.5-7b, starcoder2-3b),
``moe`` (grok-1-314b, arctic-480b: the MLP swapped for ``models/moe.py``,
whose dispatch launches kernel A), ``ssm`` (mamba2-130m, the Mamba-2
stack of ``models/ssm.py``), ``hybrid`` (zamba2-1.2b: the Mamba-2
stack with one *shared* attention + MLP block after every
``hybrid_attn_every`` layers, one weight set, a KV cache per
invocation), ``vlm`` (phi-3-vision-4.2b: the decoder with stub
``patch_embeds`` put before the token embeddings; RoPE positions and the
KV cache start at the prefix) and ``audio`` (whisper-base: a
bidirectional encoder over stub ``frame_embeds``, sinusoidal positions
and no RoPE, and a cross-attention in each decoder layer whose K/V the
prefill caches). ``init_params(cfg, seed) -> params`` is a nested dict
with the layer weights stacked over a leading L dimension, as in JAX; the
layer scan is a Python loop over that dimension.

Modes:
  forward      full-sequence logits
  prefill      full sequence -> (logits, decode cache)
  decode_step  one token + cache -> (logits, cache updated in place)

JAX's ``constrain`` sites are here (``dist/sharding.py``): q, k and v,
the sequence-sharded residual, the FSDP weight gather at use
(``_gather_fsdp``), the embeddings and the logits. Without a mesh each is
a no-op; on a mesh (the dry run's DTensors) they lay the tensors out as
GSPMD does, and the port adds what DTensor needs besides: the residual's
norm gathered along the sequence before the projections (``_sp_norm``),
a head split that TP does not divide gathered first
(``layers.split_heads``), the stacked layer dim unsharded before the loop
(``_unstack``), attention run on each shard's (batch, KV head) block
(``_attend``) and the LM head gathered with its vocab over TP (``_head``).

Where the port differs in structure: a local layer whose window is shorter
than the sequence runs kernel G (``kernels.ops.window_attention``) where
JAX runs the plain ``window_attention_blocked``; the two compute the same
function, and G's gradient is kernel Gb. ``forward_hidden`` and
``forward`` take ``remat`` (default True, as JAX's): each decoder layer
then runs under ``torch.utils.checkpoint`` and its activations are
recomputed in the backward pass (JAX's ``nothing_saveable`` policy).

For ``ssm`` and ``hybrid`` JAX's ``prefill`` returns the logits and a
*zeroed* decode cache, and its ``generate`` replays the prompt through
decode steps; the port keeps both (``models/serving.py``).

Whisper's decoder layer runs self-attention, then the MLP, then the
cross-attention, as JAX's code does (its layer scan and its
``decode_step`` add the cross-attention after the MLP); the comment in
JAX's ``decode_step`` and published Whisper put it before the MLP. The
port follows the code, which the tests hold it to. The frames must come
in ``cfg.dtype``: JAX promotes fp32 frames against bf16 weights, and the
port raises rather than cast.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core._device import resolve_device
from ..dist.sharding import (constrain, constrain_like, per_shard,
                             replicate_dim)
from ..kernels.ops import window_attention
from .attention import _chunk_for, attention, decode_attention
from .layers import (apply_norm, embed_tokens, init_attn, init_embed,
                     init_mlp, init_norm, mlp, out_project, qkv_project,
                     rope, sinusoidal_positions, split_heads)
from .moe import _ep, init_moe, moe_mlp
from .ssm import init_mamba2, mamba2_block, mamba2_decode

Tensor = torch.Tensor
Params = Dict[str, Any]

_MAMBA = ("ssm", "hybrid")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(cfg: ModelConfig, gen: torch.Generator, dtype,
                device, experts: Optional[Params] = None) -> Params:
    """One decoder layer's params (unstacked); a MoE layer draws its expert
    weights into ``experts``' tensors where given."""
    norm = lambda: init_norm(cfg.d_model, cfg.norm, dtype, device)  # noqa: E731
    p: Params = {"norm1": norm(), "norm2": norm()}
    if cfg.post_norms:
        p["post_norm1"], p["post_norm2"] = norm(), norm()
    if cfg.family in _MAMBA:
        p["mamba"] = init_mamba2(gen, cfg.d_model, cfg.d_inner,
                                 cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv,
                                 dtype, device)
        return p
    p["attn"] = init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, dtype, device, bias=cfg.qkv_bias)
    if cfg.n_experts:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, dtype,
                            device, out=experts)
        if cfg.moe_dense_residual:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device,
                                cfg.mlp_gated)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device,
                            cfg.mlp_gated)
    return p


def _init_layers(cfg: ModelConfig, gen: torch.Generator, dtype,
                 device) -> Params:
    """The n_layers layers' params, stacked. The MoE expert weights are
    drawn straight into their stacked tensors (stacking them afterwards
    would hold two copies: 2 x 54 GB at two arctic-480b layers)."""
    experts = None
    if cfg.n_experts:
        e, d, f, n = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.n_layers
        experts = {name: torch.empty((n, e) + shape, dtype=dtype,
                                     device=device)
                   for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                                       ("w_down", (f, d)))}
    layers = []
    for i in range(cfg.n_layers):
        p = _init_layer(cfg, gen, dtype, device, experts and
                        {k: v[i] for k, v in experts.items()})
        if experts:
            for name in experts:
                del p["moe"][name]
        layers.append(p)
    stacked = _stack(layers)
    if experts:
        stacked["moe"].update(experts)
    return stacked


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return replicate_dim(tree, 0)[i]


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    in ``cfg.dtype``, on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Params = {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dtype, dev),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dtype, dev),
        "layers": _init_layers(cfg, gen, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embed(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, dev).T.contiguous()
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        norm = lambda: init_norm(cfg.d_model, cfg.norm, dtype, dev)  # noqa: E731
        params["shared_attn"] = {
            "norm1": norm(), "norm2": norm(),
            "attn": init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, dtype, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, dev,
                            cfg.mlp_gated),
        }
    if cfg.n_enc_layers:
        norm = lambda: init_norm(cfg.d_model, cfg.norm, dtype, dev)  # noqa: E731
        attn = lambda: init_attn(gen, cfg.d_model, cfg.n_heads,  # noqa: E731
                                 cfg.n_kv_heads, cfg.head_dim, dtype, dev)
        params["enc_layers"] = _stack([
            {"norm1": norm(), "norm2": norm(), "attn": attn(),
             "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, dev,
                             cfg.mlp_gated)}
            for _ in range(cfg.n_enc_layers)])
        params["enc_final_norm"] = norm()
        params["cross_attn"] = _stack([{"norm": norm(), "attn": attn()}
                                       for _ in range(cfg.n_layers)])
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _self_attention(cfg: ModelConfig, p: Params, x: Tensor, positions: Tensor,
                    is_local: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (projected output, k, v) — k/v reused by prefill cache building."""
    q, k, v = qkv_project(x, p, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    q = constrain(q, "dp", "tp", None, None)
    k = constrain(k, "dp", "tp", None, None)
    v = constrain(v, "dp", "tp", None, None)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    s = x.shape[1]
    if is_local and cfg.window < s:
        o = _attend(window_attention, q, k, v, window=cfg.window,
                    blk=_chunk_for(s, 128), softcap=cfg.attn_softcap)
    else:
        o = _attend(attention, q, k, v, causal=True,
                    softcap=cfg.attn_softcap, q_chunk=cfg.attn_q_chunk,
                    k_chunk=cfg.attn_k_chunk)
    return out_project(o, p), k, v


def _attend(fn, q: Tensor, k: Tensor, v: Tensor, **kwargs) -> Tensor:
    """``fn(q, k, v, **kwargs)``; on a mesh, over each shard's (batch, KV
    head) block, with K and V unsharded along the sequence and Q laid out
    as K (its heads follow their KV heads)."""
    k = constrain(k, "dp", "tp", None, None)
    v = constrain(v, "dp", "tp", None, None)
    return per_shard(fn, constrain_like(q, k), k, v, **kwargs)


_FSDP_GATHER_RULES = {
    # leaf name -> spec roles with the fsdp (weight-resting) axis dropped:
    # inside the layer each weight is all-gathered over DP just in time
    # (ZeRO-3) instead of staying put while activation partials are
    # all-reduced over the data axis.
    "wq": (None, "tp"), "wk": (None, "tp"), "wv": (None, "tp"),
    "wo": ("tp", None),
    "w_gate": (None, "tp"), "w_up": (None, "tp"), "w_down": ("tp", None),
    "in_proj": (None, "tp"), "out_proj": ("tp", None),
    "router": (None, None),
}

_FSDP_GATHER_RULES_MOE_EP = {
    "w_gate": ("tp", None, None), "w_up": ("tp", None, None),
    "w_down": ("tp", None, None), "router": (None, None),
}

_FSDP_GATHER_RULES_MOE_TP = {
    "w_gate": (None, None, "tp"), "w_up": (None, None, "tp"),
    "w_down": (None, "tp", None), "router": (None, None),
}


def _gather_fsdp(p: Params, names: Tuple[str, ...] = ()) -> Params:
    """One layer's weights laid out by the rules above (experts over the
    model axis when it divides their count, else TP within each expert).
    Without a mesh every ``constrain`` is a no-op and ``p`` comes back as
    it was."""
    out = {}
    for name, leaf in p.items():
        if isinstance(leaf, dict):
            out[name] = _gather_fsdp(leaf, names + (name,))
        elif "moe" in names and name in _FSDP_GATHER_RULES_MOE_EP:
            rules = (_FSDP_GATHER_RULES_MOE_EP if _ep(leaf.shape[0])
                     else _FSDP_GATHER_RULES_MOE_TP)
            out[name] = constrain(leaf, *rules[name])
        elif name in _FSDP_GATHER_RULES and leaf.ndim == len(
                _FSDP_GATHER_RULES[name]):
            out[name] = constrain(leaf, *_FSDP_GATHER_RULES[name])
        else:
            out[name] = leaf
    return out


def _sp_norm(cfg: ModelConfig, x: Tensor, p: Params) -> Tensor:
    """The norm of the sequence-sharded residual, gathered along the
    sequence for the block's projections (Megatron-SP's all-gather; JAX's
    GSPMD places it by itself, DTensor will not fold two sharded dims
    into one matmul row dim)."""
    return constrain(apply_norm(x, p, cfg.norm), "dp", None, None)


def _maybe_post(cfg: ModelConfig, p: Params, name: str, h: Tensor) -> Tensor:
    if cfg.post_norms:
        return apply_norm(h, p[name], cfg.norm)
    return h


def _mlp_or_moe(cfg: ModelConfig, p: Params, x: Tensor
                ) -> Tuple[Tensor, Tensor]:
    """-> (MLP or MoE output, aux loss; 0 without experts)."""
    if cfg.n_experts:
        out, aux = moe_mlp(x, p["moe"], top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor, act=cfg.act)
        if cfg.moe_dense_residual:
            out = out + mlp(x, p["mlp"], cfg.act)
        return out, aux
    return mlp(x, p["mlp"], cfg.act), torch.zeros((), device=x.device)


def _decoder_layer(cfg: ModelConfig, p: Params, x: Tensor, positions: Tensor,
                   is_local: bool) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """-> (x, aux_loss, k, v). The residual stream is sequence-sharded
    over the TP axis between blocks (Megatron-SP)."""
    x = constrain(x, "dp", "tp", None)
    p = _gather_fsdp(p)
    h, k, v = _self_attention(cfg, p["attn"],
                              _sp_norm(cfg, x, p["norm1"]),
                              positions, is_local)
    x = x + _maybe_post(cfg, p, "post_norm1", h)
    h, aux = _mlp_or_moe(cfg, p, _sp_norm(cfg, x, p["norm2"]))
    x = x + _maybe_post(cfg, p, "post_norm2", h)
    return x, aux, k, v


def _q_project(cfg: ModelConfig, p: Params, x: Tensor) -> Tensor:
    """x (B, S, d) -> q (B, H, S, Dh): ``qkv_project``'s q alone (JAX
    projects k and v too and drops them)."""
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    return split_heads(q, cfg.n_heads, cfg.head_dim)


def _cross_kv(cfg: ModelConfig, p: Params, enc_h: Tensor
              ) -> Tuple[Tensor, Tensor]:
    """The cross-attention's K and V of the encoder output: ``enc_h @ wk``
    and ``enc_h @ wv`` (no bias) as (B, KH, Se, Dh)."""
    return tuple(split_heads(enc_h @ p[w], cfg.n_kv_heads, cfg.head_dim)
                 for w in ("wk", "wv"))


def _cross_attention(cfg: ModelConfig, xp: Params, h: Tensor, k: Tensor,
                     v: Tensor) -> Tensor:
    """Non-causal attention of the normed ``h`` over the encoder's K/V;
    the flash picks each side's chunk (``_chunk_for``)."""
    q = _q_project(cfg, xp["attn"], apply_norm(h, xp["norm"], cfg.norm))
    o = _attend(attention, q, k, v, causal=False, softcap=0.0,
                q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    return out_project(o, xp["attn"])


def _decoder_block(cfg: ModelConfig, p: Params, xp: Optional[Params],
                   x: Tensor, positions: Tensor, is_local: bool,
                   enc_h: Optional[Tensor]):
    """``_decoder_layer``, then (whisper) the cross-attention over
    ``enc_h``, added after the MLP as JAX's layer scan adds it.
    -> (x, aux_loss, (k, v) or (k, v, cross k, cross v))."""
    x, aux, k, v = _decoder_layer(cfg, p, x, positions, is_local)
    if enc_h is None:
        return x, aux, (k, v)
    xk, xv = _cross_kv(cfg, xp["attn"], enc_h)
    return x + _cross_attention(cfg, xp, x, xk, xv), aux, (k, v, xk, xv)


def _encoder_layer(cfg: ModelConfig, p: Params, h: Tensor) -> Tensor:
    q, k, v = qkv_project(apply_norm(h, p["norm1"], cfg.norm), p["attn"],
                          cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    a = _attend(attention, q, k, v, causal=False, softcap=0.0,
                q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    h = h + out_project(a, p["attn"])
    return h + mlp(apply_norm(h, p["norm2"], cfg.norm), p["mlp"], cfg.act)


def _run_encoder(cfg: ModelConfig, params: Params, frames: Tensor,
                 remat: bool = False) -> Tensor:
    """Whisper's encoder over stub frame embeddings (B, Se, d): the
    sinusoidal table added in the frames' dtype, bidirectional layers,
    ``enc_final_norm``. With ``remat`` each layer runs under
    ``torch.utils.checkpoint``."""
    if frames.dtype != _dtype(cfg):
        raise TypeError(f"{cfg.name}: frame_embeds are {frames.dtype}, the "
                        f"model computes in {_dtype(cfg)}; pass the frames "
                        f"in cfg.dtype")
    x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      frames.dtype, frames.device)[None]
    for lp in _unstack(params["enc_layers"], cfg.n_enc_layers):
        if remat:
            x = checkpoint(_encoder_layer, cfg, lp, x, use_reentrant=False)
        else:
            x = _encoder_layer(cfg, lp, x)
    return apply_norm(x, params["enc_final_norm"], cfg.norm)


def _mamba_layer(cfg: ModelConfig, p: Params, x: Tensor) -> Tensor:
    x = constrain(x, "dp", "tp", None)     # sequence-sharded residual (SP)
    p = _gather_fsdp(p)
    h = mamba2_block(_sp_norm(cfg, x, p["norm1"]), p["mamba"],
                     d_inner=cfg.d_inner, state=cfg.ssm_state,
                     n_heads=cfg.ssm_heads, headdim=cfg.ssm_headdim,
                     chunk=cfg.ssm_chunk)
    return x + h


def _shared_block_after(cfg: ModelConfig, hi: int) -> bool:
    """Whether zamba2's shared block runs after the group of layers ending
    at ``hi``: after every group but a short last one (JAX's test)."""
    every = cfg.hybrid_attn_every
    return cfg.family == "hybrid" and bool(every) and (
        hi < cfg.n_layers or cfg.n_layers % every == 0)


def _mamba_groups(cfg: ModelConfig):
    """(lo, hi) of each group of layers between two shared blocks; one
    group of all layers for ``ssm``."""
    every = cfg.hybrid_attn_every
    if cfg.family == "ssm" or not every:
        return [(0, cfg.n_layers)]
    return [(lo, min(lo + every, cfg.n_layers))
            for lo in range(0, cfg.n_layers, every)]


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------


def _unstack(tree, n: int):
    """The n layers' params, each a tree of views: ``unbind`` once a leaf,
    so the backward stacks each leaf's n gradients in one op (a ``select``
    a layer would scatter each into a zero stacked tensor). A DTensor
    sharded along the layer dim is gathered along it first."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return replicate_dim(tree, 0).unbind(0)


def _run_decoder_stack(cfg: ModelConfig, params: Params, x: Tensor,
                       positions: Tensor, collect_kv: bool = False,
                       remat: bool = False, enc_h: Optional[Tensor] = None):
    """Loop over the stacked decoder layers -> (x, aux_loss, kv or None);
    kv is the stacked (k, v), and with ``enc_h`` (whisper) the stacked
    cross-attention K and V after them.

    gemma2 (``local_global``) runs (local, global) layer pairs, as JAX's
    pair scan does. With ``remat`` each layer (and its cross-attention)
    runs under ``torch.utils.checkpoint`` and keeps only its input for the
    backward pass."""
    if cfg.family in _MAMBA:
        return (_run_mamba_stack(cfg, params, x, positions, remat),
                torch.zeros((), device=x.device), None)
    kinds = ([i % 2 == 0 for i in range(cfg.n_layers)] if cfg.local_global
             else [False] * cfg.n_layers)
    aux = torch.zeros((), device=x.device)
    kvs = []
    layers = _unstack(params["layers"], cfg.n_layers)
    cross = (_unstack(params["cross_attn"], cfg.n_layers) if enc_h is not None
             else [None] * cfg.n_layers)
    for i, is_local in enumerate(kinds):
        if remat:
            x, a, kv = checkpoint(_decoder_block, cfg, layers[i], cross[i],
                                  x, positions, is_local, enc_h,
                                  use_reentrant=False)
        else:
            x, a, kv = _decoder_block(cfg, layers[i], cross[i], x,
                                      positions, is_local, enc_h)
        aux = aux + a
        if collect_kv:
            kvs.append(kv)
    return x, aux, ([torch.stack(t) for t in zip(*kvs)] if collect_kv
                    else None)


def _run_mamba_stack(cfg: ModelConfig, params: Params, x: Tensor,
                     positions: Tensor, remat: bool = False) -> Tensor:
    """The Mamba-2 layers; zamba2's shared attention + MLP block (one
    weight set, applied at several depths) after each group. With
    ``remat`` each Mamba layer runs under ``torch.utils.checkpoint``."""
    layers = _unstack(params["layers"], cfg.n_layers)
    for lo, hi in _mamba_groups(cfg):
        for i in range(lo, hi):
            if remat:
                x = checkpoint(_mamba_layer, cfg, layers[i], x,
                               use_reentrant=False)
            else:
                x = _mamba_layer(cfg, layers[i], x)
        if _shared_block_after(cfg, hi):
            sp = params["shared_attn"]
            h, _, _ = _self_attention(cfg, sp["attn"],
                                      apply_norm(x, sp["norm1"], cfg.norm),
                                      positions, False)
            x = x + h
            x = x + mlp(apply_norm(x, sp["norm2"], cfg.norm), sp["mlp"],
                        cfg.act)
    return x


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _embed_inputs(cfg: ModelConfig, params: Params, tokens: Tensor,
                  extras: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
    """The decoder's input (B, S', d) and positions (S',): for the VLM the
    patch embeddings (cast to the working dtype) before the token
    embeddings, so S' = n_img + S; for whisper the sinusoidal table
    added."""
    takes = ({"patch_embeds"} if cfg.family == "vlm" else
             {"frame_embeds"} if cfg.n_enc_layers else set())
    if set(extras) - takes:
        raise ValueError(f"{cfg.name} ({cfg.family}) takes no "
                         f"{sorted(set(extras) - takes)}; its extra inputs "
                         f"are {sorted(takes)}")
    x = embed_tokens(params["embed"], tokens, scale=cfg.scale_embed)
    x = constrain(x, "dp", None, None)
    if "patch_embeds" in extras:
        x = torch.cat([extras["patch_embeds"].to(x.dtype), x], dim=1)
    if cfg.n_enc_layers:            # whisper decoder: sinusoidal, no rope
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype,
                                     x.device)[None]
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions


def _encode(cfg: ModelConfig, params: Params, extras: Dict[str, Tensor],
            remat: bool) -> Optional[Tensor]:
    """Whisper's encoder output over ``frame_embeds``; None for a decoder
    without an encoder."""
    if not cfg.n_enc_layers:
        return None
    if "frame_embeds" not in extras:
        raise ValueError(f"{cfg.name} needs frame_embeds (B, Se, "
                         f"{cfg.d_model}) for its encoder")
    return _run_encoder(cfg, params, extras["frame_embeds"], remat)


def lm_head(cfg: ModelConfig, params: Params) -> Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _head(cfg: ModelConfig, params: Params) -> Tensor:
    """The LM head gathered just in time with its vocab over TP, as the
    train loss gathers it (a no-op without a mesh): the logits are then
    computed vocab-sharded, never whole on one device."""
    return constrain(lm_head(cfg, params), None, "tp")


def logits_transform(cfg: ModelConfig):
    """The final logit softcap with the roundings of JAX's ``cap * tanh(l
    / cap)``: in place when ``l`` needs no gradient (no logits-sized
    temporaries), out of place when autograd must keep tanh's output."""
    if cfg.logit_softcap > 0.0:
        cap = cfg.logit_softcap
        return lambda l: (torch.tanh(l / cap) * cap if l.requires_grad
                          else l.div_(cap).tanh_().mul_(cap))
    return lambda l: l


def _logits(cfg: ModelConfig, params: Params, x: Tensor) -> Tensor:
    x = constrain(apply_norm(x, params["final_norm"], cfg.norm),
                  "dp", None, None)
    logits = constrain(x @ _head(cfg, params), "dp", None, "tp")
    return logits_transform(cfg)(logits)


def forward_hidden(cfg: ModelConfig, params: Params, tokens: Tensor,
                   remat: bool = True, **extras) -> Tuple[Tensor, Tensor]:
    """Final-norm hidden states (B, S, d) and the aux loss — the train loss
    applies the LM head chunk by chunk, so the full (B, S, V) logits never
    exist. ``remat`` recomputes each layer in the backward pass."""
    x, positions = _embed_inputs(cfg, params, tokens, extras)
    enc_h = _encode(cfg, params, extras, remat)
    x, aux, _ = _run_decoder_stack(cfg, params, x, positions, remat=remat,
                                   enc_h=enc_h)
    return apply_norm(x, params["final_norm"], cfg.norm), aux


def forward(cfg: ModelConfig, params: Params, tokens: Tensor,
            remat: bool = True, **extras) -> Tuple[Tensor, Tensor]:
    """Full-sequence logits. Returns (logits (B, S', V), aux_loss); S' =
    n_img + S for the VLM with ``patch_embeds``."""
    x, aux = forward_hidden(cfg, params, tokens, remat=remat, **extras)
    logits = constrain(x @ _head(cfg, params), "dp", None, "tp")
    return logits_transform(cfg)(logits), aux


def prefill(cfg: ModelConfig, params: Params, tokens: Tensor,
            max_len: Optional[int] = None, **extras
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Score the prompt and build the decode cache (serving prefill). The
    KV cache holds the VLM's prefix first; it is padded to ``max_len``
    where that is longer, and whisper's cache adds the cross-attention
    K/V of every layer (``cross_k``, ``cross_v``: (L, B, KH, Se, Dh))."""
    max_len = max_len or tokens.shape[1]
    x, positions = _embed_inputs(cfg, params, tokens, extras)
    if cfg.family in _MAMBA:
        # as JAX: the logits and a zeroed cache; ``generate`` replays the
        # prompt through decode steps to build the state
        x, _, _ = _run_decoder_stack(cfg, params, x, positions)
        return _logits(cfg, params, x), init_cache(
            cfg, tokens.shape[0], max_len, device=x.device)
    enc_h = _encode(cfg, params, extras, False)
    x, _, kv = _run_decoder_stack(cfg, params, x, positions,
                                  collect_kv=True, enc_h=enc_h)
    pad = max_len - kv[0].shape[3]
    if pad > 0:
        kv[:2] = [F.pad(t, (0, 0, 0, pad)) for t in kv[:2]]
    cache = dict(zip(("k", "v", "cross_k", "cross_v"), kv))
    return _logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def cache_spec(cfg: ModelConfig, batch: int, max_len: int
               ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each decode-cache tensor: K and V a layer (and
    whisper's cross-attention K and V over ``enc_seq`` frames); the conv
    window and SSM state a Mamba layer, and for ``hybrid`` K and V an
    invocation of the shared block."""
    if cfg.family in _MAMBA:
        spec = _mamba_cache_spec(cfg, batch)
        if cfg.family == "hybrid":
            n_inv = (cfg.n_layers // cfg.hybrid_attn_every
                     if cfg.hybrid_attn_every else 0)
            kv = (n_inv, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
            spec["shared_k"] = spec["shared_v"] = (kv, _dtype(cfg))
        return spec
    kv = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    spec = {"k": (kv, _dtype(cfg)), "v": (kv, _dtype(cfg))}
    if cfg.n_enc_layers and cfg.enc_seq:
        xkv = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.enc_seq,
               cfg.head_dim)
        spec["cross_k"] = spec["cross_v"] = (xkv, _dtype(cfg))
    return spec


def _mamba_cache_spec(cfg: ModelConfig, batch: int):
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {"conv": ((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_ch),
                     _dtype(cfg)),
            "ssm": ((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_headdim,
                     cfg.ssm_state), torch.float32)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Dict[str, Tensor]:
    """A zeroed decode cache on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, (shape, dtype) in cache_spec(cfg, batch,
                                                   max_len).items()}


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, Tensor],
                tokens: Tensor, cache_index: int
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decoding step. tokens (B, 1); cache_index = current length (for
    the VLM it counts the image prefix). Whisper adds row ``cache_index``
    of the sinusoidal table and, after each layer's MLP, attends over
    every cached encoder frame (the padded ones too, as JAX).

    The cache is updated in place (JAX returns a new one; here that would
    copy the whole cache every token) and returned."""
    idx = int(cache_index)
    x = embed_tokens(params["embed"], tokens, scale=cfg.scale_embed)
    positions = torch.tensor([idx], device=x.device)
    if cfg.n_enc_layers:
        x = x + sinusoidal_positions(cache["k"].shape[3], cfg.d_model,
                                     x.dtype, x.device)[idx]
    if cfg.family in _MAMBA:
        return _logits(cfg, params, _decode_mamba(cfg, params, cache, x,
                                                  idx, positions)), cache
    s_cache = cache["k"].shape[3]
    for i in range(cfg.n_layers):
        lp = _gather_fsdp(_index(params["layers"], i))
        kc, vc = cache["k"][i], cache["v"][i]
        hn = apply_norm(x, lp["norm1"], cfg.norm)
        q, k, v = qkv_project(hn, lp["attn"], cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim)
        if cfg.use_rope:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        kc[:, :, idx] = k[:, :, 0]
        vc[:, :, idx] = v[:, :, 0]
        if cfg.local_global and i % 2 == 0 and cfg.window < s_cache:
            # the paper's cutoff applied to the cache: only the window
            # pencil is read, not the whole cache
            w = cfg.window
            start = min(max(idx - w + 1, 0), s_cache - w)
            o = decode_attention(q, kc[:, :, start:start + w],
                                 vc[:, :, start:start + w], idx - start,
                                 softcap=cfg.attn_softcap)
        else:
            o = decode_attention(q, kc, vc, idx, softcap=cfg.attn_softcap)
        x = x + _maybe_post(cfg, lp, "post_norm1", out_project(o, lp["attn"]))
        m, _ = _mlp_or_moe(cfg, lp, apply_norm(x, lp["norm2"], cfg.norm))
        x = x + _maybe_post(cfg, lp, "post_norm2", m)
        if cfg.n_enc_layers:
            xp = _index(params["cross_attn"], i)
            xk, xv = cache["cross_k"][i], cache["cross_v"][i]
            q2 = _q_project(cfg, xp["attn"],
                            apply_norm(x, xp["norm"], cfg.norm))
            o2 = decode_attention(q2, xk, xv, xk.shape[2] - 1)
            x = x + out_project(o2, xp["attn"])
    return _logits(cfg, params, x), cache


def _decode_mamba(cfg: ModelConfig, params: Params, cache: Dict[str, Tensor],
                  x: Tensor, idx: int, positions: Tensor) -> Tensor:
    """One token through the Mamba-2 stack (and zamba2's shared block),
    each layer's conv window and SSM state and each shared-block
    invocation's K/V updated in place. -> the last hidden state."""
    inv = 0
    for lo, hi in _mamba_groups(cfg):
        for i in range(lo, hi):
            lp = _index(params["layers"], i)
            y, _ = mamba2_decode(
                apply_norm(x, lp["norm1"], cfg.norm), lp["mamba"],
                {"conv": cache["conv"][i], "ssm": cache["ssm"][i]},
                d_inner=cfg.d_inner, state=cfg.ssm_state,
                n_heads=cfg.ssm_heads, headdim=cfg.ssm_headdim)
            x = x + y
        if _shared_block_after(cfg, hi):
            sp = params["shared_attn"]
            q, k, v = qkv_project(apply_norm(x, sp["norm1"], cfg.norm),
                                  sp["attn"], cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            kc, vc = cache["shared_k"][inv], cache["shared_v"][inv]
            kc[:, :, idx] = k[:, :, 0]
            vc[:, :, idx] = v[:, :, 0]
            o = decode_attention(q, kc, vc, idx)
            x = x + out_project(o, sp["attn"])
            x = x + mlp(apply_norm(x, sp["norm2"], cfg.norm), sp["mlp"],
                        cfg.act)
            inv += 1
    return x
