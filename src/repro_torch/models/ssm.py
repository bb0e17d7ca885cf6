"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block.

The port of ``repro/models/ssm.py``, in plain PyTorch: the JAX package
runs this path in ``jnp`` with no Pallas kernel. Chunked SSD: within-chunk
attention-like products plus an inter-chunk linear recurrence. Chunking
plays the same role as the paper's pencils: the quadratic part is confined
to a staged block, the cross-block coupling is a cheap carried state.
Decode is a single-token state update (O(1) per token).

Shapes: d_inner = expand * d_model, heads H = d_inner / headdim P, single
B/C group (G=1), state size N = cfg.ssm_state.

Where the port differs: JAX's 3- and 4-operand einsums are written as
pairwise products in the order that keeps the intermediates small (the
card has no ``opt_einsum``), and the inter-chunk ``lax.scan`` is a loop
over the chunks. ``mamba2_decode`` updates the layer's cache in place and
returns it (JAX returns a new one).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..dist.sharding import constrain, keep_whole, replicate_dim, role_size
from .layers import _normal, rms_norm

Tensor = torch.Tensor


def init_mamba2(gen: torch.Generator, d: int, d_inner: int, n_heads: int,
                state: int, conv: int, dtype, device) -> Dict[str, Tensor]:
    conv_ch = d_inner + 2 * state       # x, B, C run through the conv
    proj_out = 2 * d_inner + 2 * state + n_heads   # z, x, B, C, dt
    f32 = torch.float32
    return {
        "in_proj": _normal(gen, (d, proj_out), d ** -0.5, dtype, device),
        "conv_w": _normal(gen, (conv, conv_ch), conv ** -0.5, dtype, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.zeros((n_heads,), dtype=f32, device=device),
        "d_skip": torch.ones((n_heads,), dtype=f32, device=device),
        "dt_bias": torch.zeros((n_heads,), dtype=f32, device=device),
        "norm_scale": torch.zeros((d_inner,), dtype=dtype, device=device),
        "out_proj": _normal(gen, (d_inner, d), d_inner ** -0.5, dtype,
                            device),
    }


def _split_proj(zxbcdt: Tensor, d_inner: int, state: int, n_heads: int):
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    bm = zxbcdt[..., 2 * d_inner:2 * d_inner + state]
    cm = zxbcdt[..., 2 * d_inner + state:2 * d_inner + 2 * state]
    dt = zxbcdt[..., 2 * d_inner + 2 * state:]
    return z, x, bm, cm, dt


def _causal_conv(u: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv: u (B, S, C), w (K, C) -> (B, S, C), as JAX's
    shifted adds in the same order (so bf16 rounds alike)."""
    k = w.shape[0]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + pad[:, i:i + u.shape[1], :] * w[i]
    return out + b


def _segsum(x: Tensor) -> Tensor:
    """x (..., Q) -> (..., Q, Q): sum_{k=j+1..i} x[k] for i >= j, -inf
    else."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    lower = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return seg.masked_fill(~lower, float("-inf"))


def ssd_chunked(x: Tensor, dt: Tensor, a: Tensor, bm: Tensor, cm: Tensor,
                chunk: int) -> Tensor:
    """SSD scan. x (B,S,H,P), dt (B,S,H) >0, a (H,) <0, bm/cm (B,S,N).

    Returns y (B,S,H,P). fp32 internally."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        # dt = 0 rows are exact no-ops (decay exp(0)=1, zero state injection)
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
        return ssd_chunked(x, dt, a, bm, cm, chunk)[:, :s]
    nc = s // q

    xf = (x * dt[..., None]).float().reshape(b, nc, q, h, p)
    da = (dt * a).float().reshape(b, nc, q, h).permute(0, 3, 1, 2)  # b,h,c,q
    bmf = bm.float().reshape(b, nc, q, n)
    cmf = cm.float().reshape(b, nc, q, n)
    da_cs = torch.cumsum(da, dim=-1)                  # (b, h, c, q)
    xh = xf.permute(0, 3, 1, 2, 4)                    # (b, h, c, q, p)

    # 1) intra-chunk (the "attention-like" quadratic part, staged per
    #    chunk): "bcln,bcsn,bhcls,bcshp->bclhp" as (C B^T) * L, then @ x
    ell = torch.exp(_segsum(da))                      # (b, h, c, l, s)
    cb = cmf @ bmf.transpose(-1, -2)                  # (b, c, l, s)
    y_diag = (cb[:, None] * ell) @ xh                 # (b, h, c, l, p)

    # 2) per-chunk terminal states: "bcln,bhcl,bclhp->bchpn"
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)          # (b,h,c,q)
    xd = xh * decay_states[..., None]                          # (b,h,c,l,p)
    states = xd.transpose(-1, -2) @ bmf[:, None]               # (b,h,c,p,n)

    # 3) inter-chunk recurrence (linear scan over chunk boundaries); each
    #    chunk reads the state before it
    chunk_decay = torch.exp(da_cs[..., -1])                    # (b, h, c)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[..., c, None, None] + states[:, :, c]
    prev_states = torch.stack(prev, dim=2)                     # (b,h,c,p,n)

    # 4) contribution of the carried state: "bcln,bchpn,bhcl->bclhp"
    state_decay = torch.exp(da_cs)                             # (b,h,c,q)
    y_off = (cmf[:, None] @ prev_states.transpose(-1, -2)) \
        * state_decay[..., None]                               # (b,h,c,l,p)

    y = y_diag + y_off
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, p)


def mamba2_block(x: Tensor, p: Dict[str, Tensor], *, d_inner: int,
                 state: int, n_heads: int, headdim: int, chunk: int
                 ) -> Tensor:
    """Full Mamba-2 mixer (train/prefill path). x (B, S, d) -> (B, S, d)."""
    z, xs, bm, cm, dt = _split_proj(x @ p["in_proj"], d_inner, state,
                                    n_heads)
    conv_in = torch.cat([xs, bm, cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs = conv_out[..., :d_inner]
    bm = conv_out[..., d_inner:d_inner + state]
    cm = conv_out[..., d_inner + state:]

    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xs = keep_whole(xs, -1, n_heads)      # on a mesh: whole heads a shard
    xh = xs.reshape(*xs.shape[:-1], n_heads, headdim)
    y = ssd_chunked(xh, dt, a, bm, cm, chunk)
    y = y + xh.float() * p["d_skip"][:, None]
    y = y.reshape(xs.shape).to(x.dtype)

    y = rms_norm(y * F.silu(z), p["norm_scale"])
    if n_heads % role_size("tp"):
        # out_proj's TP row shards split heads: shard the columns here, so
        # that the gradient comes back to the heads whole
        y = constrain(y, "dp", None, "tp")
    return y @ p["out_proj"]


def mamba2_decode(x: Tensor, p: Dict[str, Tensor], cache: Dict[str, Tensor],
                  *, d_inner: int, state: int, n_heads: int, headdim: int
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Single-token step. x (B, 1, d); cache = {"conv": (B, K-1, C),
    "ssm": (B, H, P, N)}, updated in place. Returns (y (B, 1, d), cache)."""
    z, xs, bm, cm, dt = _split_proj(x @ p["in_proj"], d_inner, state,
                                    n_heads)
    conv_in = torch.cat([xs, bm, cm], dim=-1)                 # (B, 1, C)
    window = torch.cat([cache["conv"], conv_in], dim=1)       # (B, K, C)
    conv_out = F.silu((window * p["conv_w"]).sum(1)
                      + p["conv_b"])[:, None, :]
    cache["conv"].copy_(window[:, 1:])

    xs = conv_out[..., :d_inner]
    bm = conv_out[..., d_inner:d_inner + state]
    cm = conv_out[..., d_inner + state:]

    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]                  # (B,H)
    a = -torch.exp(p["a_log"])
    xs = keep_whole(xs, -1, n_heads)
    xh = xs.reshape(-1, n_heads, headdim).float()                     # (B,H,P)
    decay = torch.exp(dt * a)                                         # (B,H)
    bmf = bm[:, 0].float()                                            # (B,N)
    cmf = cm[:, 0].float()
    dx = xh * dt[..., None]                                           # (B,H,P)
    h_new = (cache["ssm"] * decay[..., None, None]
             + dx[..., None] * bmf[:, None, None, :])
    cache["ssm"].copy_(h_new)
    y = (h_new @ cmf[:, None, :, None])[..., 0] + xh * p["d_skip"][:, None]
    y = replicate_dim(y, 1).reshape(-1, 1, d_inner).to(x.dtype)

    y = rms_norm(y * F.silu(z), p["norm_scale"])
    return y @ p["out_proj"], cache


def init_mamba_cache(batch: int, d_inner: int, state: int, n_heads: int,
                     headdim: int, conv: int, dtype, device
                     ) -> Dict[str, Tensor]:
    return {
        "conv": torch.zeros((batch, conv - 1, d_inner + 2 * state),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, n_heads, headdim, state),
                           dtype=torch.float32, device=device),
    }
