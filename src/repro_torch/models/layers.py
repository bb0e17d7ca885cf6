"""Shared transformer layers: norms, RoPE, MLP, projections, embedding.

The port of ``repro/models/layers.py``. Parameters are plain nested dicts
of tensors; every init function takes an explicit ``torch.Generator`` (on
the device the tensors go to), a dtype and a device. The model stacks the
layer weights over a leading L dimension, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..dist.sharding import constrain, keep_whole, role_size

Tensor = torch.Tensor


# -- norms -------------------------------------------------------------------

def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm in fp32 with the ``(1 + scale)`` form, cast back."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor,
               eps: float = 1e-5) -> Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def apply_norm(x: Tensor, p: Dict[str, Tensor], kind: str) -> Tensor:
    if kind == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def init_norm(d: int, kind: str, dtype, device) -> Dict[str, Tensor]:
    if kind == "rms":                                  # (1 + scale) form
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


# -- rotary position embedding ------------------------------------------------

def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x (..., S, D) with D even; positions (..., S) or (S,). Half-split
    layout (not interleaved), fp32 angles."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs             # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


def sinusoidal_positions(s: int, d: int, dtype, device) -> Tensor:
    """Whisper-style fixed sinusoidal table (S, D): [sin, cos] of position
    times ``exp(-i log(1e4) / (half - 1))``, in fp32 as JAX's (its log is
    an fp32 log), cast to ``dtype``."""
    half = d // 2
    step = torch.log(torch.tensor(10000.0, device=device)) / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=device) * step)
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] \
        * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# -- dense / GLU MLP -----------------------------------------------------------

def _act(x: Tensor, kind: str) -> Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp(x: Tensor, p: Dict[str, Tensor], act: str) -> Tensor:
    if "w_gate" not in p:            # plain 2-matrix MLP (starcoder2/whisper)
        h = _act(constrain(x @ p["w_up"], "dp", None, "tp"), act)
        return h @ p["w_down"]
    gate = _act(constrain(x @ p["w_gate"], "dp", None, "tp"), act)
    return (gate * (x @ p["w_up"])) @ p["w_down"]


def _normal(gen: torch.Generator, shape, std: float, dtype,
            device) -> Tensor:
    """fp32 standard normal times ``std``, cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def init_mlp(gen: torch.Generator, d: int, f: int, dtype, device,
             gated: bool = True) -> Dict[str, Tensor]:
    p = {"w_up": _normal(gen, (d, f), d ** -0.5, dtype, device),
         "w_down": _normal(gen, (f, d), f ** -0.5, dtype, device)}
    if gated:
        p["w_gate"] = _normal(gen, (d, f), d ** -0.5, dtype, device)
    return p


# -- attention projections -----------------------------------------------------

def init_attn(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
              head_dim: int, dtype, device, bias: bool = False
              ) -> Dict[str, Tensor]:
    s = d ** -0.5
    p = {
        "wq": _normal(gen, (d, n_heads * head_dim), s, dtype, device),
        "wk": _normal(gen, (d, n_kv * head_dim), s, dtype, device),
        "wv": _normal(gen, (d, n_kv * head_dim), s, dtype, device),
        "wo": _normal(gen, (n_heads * head_dim, d),
                      (n_heads * head_dim) ** -0.5, dtype, device),
    }
    if bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype,
                                  device=device)
    return p


def qkv_project(x: Tensor, p: Dict[str, Tensor], n_heads: int, n_kv: int,
                head_dim: int):
    """x (B, S, d) -> q (B, H, S, Dh), k/v (B, KH, S, Dh)."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (split_heads(q, n_heads, head_dim), split_heads(k, n_kv, head_dim),
            split_heads(v, n_kv, head_dim))


def split_heads(t: Tensor, n: int, head_dim: int) -> Tensor:
    """(B, S, n * Dh) -> (B, n, S, Dh). On a mesh a column shard must hold
    whole heads: columns split other than at head boundaries are gathered
    first (a no-op without a mesh)."""
    t = keep_whole(t, -1, n)
    b, s, _ = t.shape
    return t.reshape(b, s, n, head_dim).transpose(1, 2)


def out_project(o: Tensor, p: Dict[str, Tensor]) -> Tensor:
    """(B, H, S, Dh) -> (B, S, d)."""
    b, h, s, dh = o.shape
    x = o.transpose(1, 2).reshape(b, s, h * dh)
    if h % role_size("tp"):
        # wo's TP row shards split heads: shard the merged columns here,
        # so that the gradient comes back to the heads whole (DTensor
        # will not split a sharded dim into heads)
        x = constrain(x, "dp", None, "tp")
    return x @ p["wo"]


# -- embedding -----------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> Tensor:
    return _normal(gen, (vocab, d), d ** -0.5, dtype, device)


def embed_tokens(table: Tensor, tokens: Tensor, scale: bool = False) -> Tensor:
    """Rows of ``table``; times sqrt(d) in the working dtype if ``scale``."""
    x = table[tokens]
    if scale:
        x = x * (table.shape[-1] ** 0.5)
    return x
