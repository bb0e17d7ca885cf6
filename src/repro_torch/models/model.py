"""Model assembly: init / forward / prefill / decode, decoder-only.

The port of ``repro/models/model.py`` for the decoder-only families:
``dense`` (gemma2-2b, qwen1.5-0.5b, codeqwen1.5-7b, starcoder2-3b),
``moe`` (grok-1-314b, arctic-480b: the MLP swapped for ``models/moe.py``,
whose dispatch launches kernel A), ``ssm`` (mamba2-130m, the Mamba-2
stack of ``models/ssm.py``) and ``hybrid`` (zamba2-1.2b: the Mamba-2
stack with one *shared* attention + MLP block after every
``hybrid_attn_every`` layers, one weight set, a KV cache per
invocation). ``init_params(cfg, seed) -> params`` is a nested dict with
the layer weights stacked over a leading L dimension, as in JAX; the layer
scan is a Python loop over that dimension.

Modes:
  forward      full-sequence logits
  prefill      full sequence -> (logits, decode cache)
  decode_step  one token + cache -> (logits, cache updated in place)

Where the port differs in structure: a local layer whose window is shorter
than the sequence runs kernel G (``kernels.ops.window_attention``) where
JAX runs the plain ``window_attention_blocked``; the two compute the same
function, and G's gradient is kernel Gb. ``forward_hidden`` and
``forward`` take ``remat`` (default True, as JAX's): each decoder layer
then runs under ``torch.utils.checkpoint`` and its activations are
recomputed in the backward pass (JAX's ``nothing_saveable`` policy).

For ``ssm`` and ``hybrid`` JAX's ``prefill`` returns the logits and a
*zeroed* decode cache, and its ``generate`` replays the prompt through
decode steps; the port keeps both (``models/serving.py``). Encoder-decoder
(whisper) and VLM inputs are not ported (ROADMAP Queue 1 items 13.4, 13.5)
and raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core._device import resolve_device
from ..kernels.ops import window_attention
from .attention import _chunk_for, attention, decode_attention
from .layers import (apply_norm, embed_tokens, init_attn, init_embed,
                     init_mlp, init_norm, mlp, out_project, qkv_project,
                     rope)
from .moe import init_moe, moe_mlp
from .ssm import init_mamba2, mamba2_block, mamba2_decode

Tensor = torch.Tensor
Params = Dict[str, Any]

UNPORTED = "ROADMAP Queue 1 item"
_MAMBA = ("ssm", "hybrid")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a family or option the port does not have yet."""
    missing = [(what, item) for what, item, on in (
        ("an encoder (n_enc_layers)", "13.4", cfg.n_enc_layers),
        ("non-rope positions (use_rope=False)", "13.4", not cfg.use_rope),
        (f"the {cfg.family} family", "13.5", cfg.family == "vlm")) if on]
    if missing:
        raise ValueError(
            f"{cfg.name}: {', '.join(w for w, _ in missing)} not ported yet "
            f"({UNPORTED} {', '.join(sorted({i for _, i in missing}))})")


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
    return tree[i]


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    in ``cfg.dtype``, on ``device`` (default: the CUDA card)."""
    check_ported(cfg)
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
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _self_attention(cfg: ModelConfig, p: Params, x: Tensor, positions: Tensor,
                    is_local: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (projected output, k, v) — k/v reused by prefill cache building."""
    q, k, v = qkv_project(x, p, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    s = x.shape[1]
    if is_local and cfg.window < s:
        o = window_attention(q, k, v, window=cfg.window,
                             blk=_chunk_for(s, 128), softcap=cfg.attn_softcap)
    else:
        o = attention(q, k, v, True, cfg.attn_softcap, cfg.attn_q_chunk,
                      cfg.attn_k_chunk)
    return out_project(o, p), k, v


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
    """-> (x, aux_loss, k, v)."""
    h, k, v = _self_attention(cfg, p["attn"],
                              apply_norm(x, p["norm1"], cfg.norm),
                              positions, is_local)
    x = x + _maybe_post(cfg, p, "post_norm1", h)
    h, aux = _mlp_or_moe(cfg, p, apply_norm(x, p["norm2"], cfg.norm))
    x = x + _maybe_post(cfg, p, "post_norm2", h)
    return x, aux, k, v


def _mamba_layer(cfg: ModelConfig, p: Params, x: Tensor) -> Tensor:
    h = mamba2_block(apply_norm(x, p["norm1"], cfg.norm), p["mamba"],
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
    a layer would scatter each into a zero stacked tensor)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return tree.unbind(0)


def _run_decoder_stack(cfg: ModelConfig, params: Params, x: Tensor,
                       positions: Tensor, collect_kv: bool = False,
                       remat: bool = False):
    """Loop over the stacked decoder layers -> (x, aux_loss, kv or None).

    gemma2 (``local_global``) runs (local, global) layer pairs, as JAX's
    pair scan does. With ``remat`` each layer runs under
    ``torch.utils.checkpoint`` and keeps only its input for the backward
    pass."""
    if cfg.family in _MAMBA:
        return (_run_mamba_stack(cfg, params, x, positions, remat),
                torch.zeros((), device=x.device), None)
    kinds = ([i % 2 == 0 for i in range(cfg.n_layers)] if cfg.local_global
             else [False] * cfg.n_layers)
    aux = torch.zeros((), device=x.device)
    ks, vs = [], []
    layers = _unstack(params["layers"], cfg.n_layers)
    for i, is_local in enumerate(kinds):
        if remat:
            x, a, k, v = checkpoint(_decoder_layer, cfg, layers[i], x,
                                    positions, is_local,
                                    use_reentrant=False)
        else:
            x, a, k, v = _decoder_layer(cfg, layers[i], x, positions,
                                        is_local)
        aux = aux + a
        if collect_kv:
            ks.append(k)
            vs.append(v)
    return x, aux, ((torch.stack(ks), torch.stack(vs)) if collect_kv
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
    if extras:
        raise ValueError(f"extra inputs {sorted(extras)} (VLM patches, "
                         f"encoder frames) are not ported yet ({UNPORTED})")
    x = embed_tokens(params["embed"], tokens, scale=cfg.scale_embed)
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions


def lm_head(cfg: ModelConfig, params: Params) -> Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


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
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return logits_transform(cfg)(x @ lm_head(cfg, params))


def forward_hidden(cfg: ModelConfig, params: Params, tokens: Tensor,
                   remat: bool = True, **extras) -> Tuple[Tensor, Tensor]:
    """Final-norm hidden states (B, S, d) and the aux loss — the train loss
    applies the LM head chunk by chunk, so the full (B, S, V) logits never
    exist. ``remat`` recomputes each layer in the backward pass."""
    check_ported(cfg)
    x, positions = _embed_inputs(cfg, params, tokens, extras)
    x, aux, _ = _run_decoder_stack(cfg, params, x, positions, remat=remat)
    return apply_norm(x, params["final_norm"], cfg.norm), aux


def forward(cfg: ModelConfig, params: Params, tokens: Tensor,
            remat: bool = True, **extras) -> Tuple[Tensor, Tensor]:
    """Full-sequence logits. Returns (logits (B, S, V), aux_loss)."""
    x, aux = forward_hidden(cfg, params, tokens, remat=remat, **extras)
    return logits_transform(cfg)(x @ lm_head(cfg, params)), aux


def prefill(cfg: ModelConfig, params: Params, tokens: Tensor,
            max_len: Optional[int] = None, **extras
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Score the prompt and build the decode cache (serving prefill)."""
    check_ported(cfg)
    s = tokens.shape[1]
    max_len = max_len or s
    x, positions = _embed_inputs(cfg, params, tokens, extras)
    if cfg.family in _MAMBA:
        # as JAX: the logits and a zeroed cache; ``generate`` replays the
        # prompt through decode steps to build the state
        x, _, _ = _run_decoder_stack(cfg, params, x, positions)
        return _logits(cfg, params, x), init_cache(
            cfg, tokens.shape[0], max_len, device=x.device)
    x, _, (ks, vs) = _run_decoder_stack(cfg, params, x, positions,
                                        collect_kv=True)
    pad = (0, 0, 0, max_len - s)
    cache = {"k": F.pad(ks, pad), "v": F.pad(vs, pad)}
    return _logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def cache_spec(cfg: ModelConfig, batch: int, max_len: int
               ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each decode-cache tensor: K and V a layer; the
    conv window and SSM state a Mamba layer, and for ``hybrid`` K and V an
    invocation of the shared block."""
    check_ported(cfg)
    if cfg.family in _MAMBA:
        spec = _mamba_cache_spec(cfg, batch)
        if cfg.family == "hybrid":
            n_inv = (cfg.n_layers // cfg.hybrid_attn_every
                     if cfg.hybrid_attn_every else 0)
            kv = (n_inv, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
            spec["shared_k"] = spec["shared_v"] = (kv, _dtype(cfg))
        return spec
    kv = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": (kv, _dtype(cfg)), "v": (kv, _dtype(cfg))}


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
    """One decoding step. tokens (B, 1); cache_index = current length.

    The cache is updated in place (JAX returns a new one; here that would
    copy the whole cache every token) and returned."""
    check_ported(cfg)
    idx = int(cache_index)
    x = embed_tokens(params["embed"], tokens, scale=cfg.scale_embed)
    positions = torch.tensor([idx], device=x.device)
    if cfg.family in _MAMBA:
        return _logits(cfg, params, _decode_mamba(cfg, params, cache, x,
                                                  idx, positions)), cache
    s_cache = cache["k"].shape[3]
    for i in range(cfg.n_layers):
        lp = _index(params["layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        hn = apply_norm(x, lp["norm1"], cfg.norm)
        q, k, v = qkv_project(hn, lp["attn"], cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim)
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
