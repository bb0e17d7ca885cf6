"""Attention: chunked flash (forward), pencil-window and decode paths.

The port of ``repro/models/attention.py``, in plain PyTorch:

  flash_attention   full causal attention as a double loop over (q, kv)
                    chunks with online softmax; a ``torch.autograd.Function``
                    whose backward is JAX's ``_flash_bwd`` (P recomputed
                    from the saved log-sum-exp, dK/dV accumulated per KV
                    chunk), its products in ``torch.matmul`` as JAX leaves
                    them to XLA.
  window_attention_blocked
                    sliding-window attention over window-sized blocks, each
                    attending to (previous, self). The model's local layers
                    run kernel G (``kernels.ops.window_attention``) instead,
                    which computes the same function; this one is held
                    against JAX's in the tests.
  decode_attention  one-token-vs-cache masked softmax.

All paths take GQA natively (no KV repetition) and gemma2's logit softcap.
Scores and accumulators are fp32 whatever the input dtype: where JAX asks
its einsum for fp32 results, the port casts the operands to fp32 first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
NEG_INF = -1.0e30


def attention(q: Tensor, k: Tensor, v: Tensor, causal: bool, softcap: float,
              q_chunk: int, k_chunk: int) -> Tensor:
    """Production path: chunked flash. (JAX's dense switch for roofline cost
    runs belongs to the dry-run tools, which are not ported.)"""
    return flash_attention(q, k, v, causal, softcap, q_chunk, k_chunk)


def _softcap(s: Tensor, cap: float) -> Tensor:
    return cap * torch.tanh(s / cap) if cap > 0.0 else s


def _softcap_grad(s_capped: Tensor, cap: float) -> Tensor:
    """d softcap / d s from the *capped* value, with ``s / cap`` clipped to
    [-1, 1] as JAX's ``_flash_bwd`` clips it: a masked score (-1e30) then
    gets a finite derivative, which its P = 0 cancels."""
    if cap <= 0.0:
        return torch.ones_like(s_capped)
    t = torch.clamp(s_capped / cap, -1.0, 1.0)
    return 1.0 - t * t


def _split_gqa(q: Tensor, kh: int) -> Tensor:
    b, h, s, d = q.shape
    return q.reshape(b, kh, h // kh, s, d)


def _chunk_for(s: int, target: int) -> int:
    """Largest divisor of s that is <= target."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _scores(q: Tensor, k: Tensor, softcap: float) -> Tensor:
    """q (b, kh, g, qc, d) x k (b, kh, kc, d) -> fp32 (b, kh, g, qc, kc)."""
    b, kh, g, qc, _ = q.shape
    s = q.float().flatten(2, 3) @ k.float().transpose(-1, -2)
    return _softcap(s.view(b, kh, g, qc, -1), softcap)


def _pv(p: Tensor, v: Tensor) -> Tensor:
    """fp32 p (b, kh, g, qc, kc) x v (b, kh, kc, d) -> fp32 (b, kh, g, qc,
    d)."""
    b, kh, g, qc, _ = p.shape
    return (p.flatten(2, 3) @ v.float()).view(b, kh, g, qc, -1)


# ---------------------------------------------------------------------------
# full causal flash (double chunk loop, custom backward)
# ---------------------------------------------------------------------------

def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                    softcap: float = 0.0, q_chunk: int = 512,
                    k_chunk: int = 512) -> Tensor:
    """Memory-efficient attention. q (B,H,Sq,D); k,v (B,KH,Skv,D).
    Differentiable in q, k and v; the backward recomputes P chunk by chunk
    from the forward's log-sum-exp, so no (Sq, Skv) matrix is kept."""
    return _FlashAttention.apply(q, k, v, causal, softcap, q_chunk, k_chunk)


class _FlashAttention(torch.autograd.Function):
    """JAX's ``custom_vjp`` pair: saves (q, k, v, out, lse) as
    ``_flash_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap, q_chunk, k_chunk):
        out, lse = _flash_fwd(q, k, v, causal, softcap, q_chunk, k_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, softcap, q_chunk, k_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.args, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def _last_chunk(causal: bool, qi: int, qc: int, kc: int, nk: int) -> int:
    """KV chunks 0 ... last - 1 meet query chunk ``qi``: under ``causal`` a
    KV chunk wholly after the query chunk is skipped. JAX visits it, but
    there every score is -1e30, so in the forward it adds exp(-1e30 - m) =
    0 and rescales by exp(0) = 1 (chunk 0 already made every running max
    finite), and in the backward its P is 0; skipping it changes no bit."""
    return min(nk, ((qi + 1) * qc - 1) // kc + 1) if causal else nk


def _flash_fwd(q, k, v, causal, softcap, q_chunk, k_chunk):
    """-> (out (B,H,Sq,D) in q's dtype, lse (B,KH,G,Sq) fp32)."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    g = h // kh
    qc, kc = _chunk_for(sq, q_chunk), _chunk_for(skv, k_chunk)
    nq, nk = sq // qc, skv // kc
    qg = _split_gqa(q, kh) * d ** -0.5          # in q's dtype, as JAX
    out = torch.empty((b, kh, g, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, kh, g, sq), device=q.device)
    rows = torch.arange(qc, device=q.device)[:, None]
    cols = torch.arange(kc, device=q.device)[None, :]
    for qi in range(nq):
        qblk = qg[:, :, :, qi * qc:(qi + 1) * qc]
        m = torch.full((b, kh, g, qc, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, kh, g, qc, 1), device=q.device)
        acc = torch.zeros((b, kh, g, qc, d), device=q.device)
        for ki in range(_last_chunk(causal, qi, qc, kc, nk)):
            s = _scores(qblk, k[:, :, ki * kc:(ki + 1) * kc], softcap)
            if causal:
                s = torch.where(qi * qc + rows >= ki * kc + cols, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + _pv(p, v[:, :, ki * kc:(ki + 1) * kc])
            m = m_new
        l = l.clamp_min(1e-30)
        out[:, :, :, qi * qc:(qi + 1) * qc] = acc / l
        lse[..., qi * qc:(qi + 1) * qc] = (m + torch.log(l))[..., 0]
    return out.reshape(b, h, sq, d), lse


def _flash_bwd(causal, softcap, q_chunk, k_chunk, res, dout):
    """JAX's ``_flash_bwd``: delta = rowsum(dout * out), P = exp(s - lse)
    per (q, kv) chunk, dS through the softcap derivative, dQ per query
    chunk and dK, dV accumulated per KV chunk in fp32 with the GQA group
    summed. -> (dq, dk, dv) in the inputs' dtypes."""
    q, k, v, out, lse = res
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    g = h // kh
    qc, kc = _chunk_for(sq, q_chunk), _chunk_for(skv, k_chunk)
    nq, nk = sq // qc, skv // kc
    scale = d ** -0.5
    qg = _split_gqa(q, kh) * scale                  # in q's dtype, as JAX
    do = _split_gqa(dout.float(), kh)
    delta = (do * _split_gqa(out.float(), kh)).sum(-1)   # (b, kh, g, sq)
    dq = torch.empty((b, kh, g, sq, d), device=q.device)
    dk = torch.zeros((b, kh, skv, d), device=q.device)
    dv = torch.zeros((b, kh, skv, d), device=q.device)
    rows = torch.arange(qc, device=q.device)[:, None]
    cols = torch.arange(kc, device=q.device)[None, :]
    for qi in range(nq):
        sl = slice(qi * qc, (qi + 1) * qc)
        qblk, doblk = qg[:, :, :, sl], do[:, :, :, sl]
        lseblk, dblk = lse[..., sl, None], delta[..., sl, None]
        dq_blk = torch.zeros((b, kh, g * qc, d), device=q.device)
        for ki in range(_last_chunk(causal, qi, qc, kc, nk)):
            kk = slice(ki * kc, (ki + 1) * kc)
            kf, vf = k[:, :, kk].float(), v[:, :, kk].float()
            s = _scores(qblk, k[:, :, kk], softcap)
            if causal:
                s = torch.where(qi * qc + rows >= ki * kc + cols, s, NEG_INF)
            p = torch.exp(s - lseblk)                   # (b, kh, g, qc, kc)
            dp = (doblk.flatten(2, 3) @ vf.transpose(-1, -2)).view_as(p)
            ds = p * (dp - dblk)
            if softcap > 0.0:
                ds = ds * _softcap_grad(s, softcap)
            ds2, p2 = ds.flatten(2, 3), p.flatten(2, 3)
            dv[:, :, kk] += p2.transpose(-1, -2) @ doblk.flatten(2, 3)
            dk[:, :, kk] += ds2.transpose(-1, -2) @ qblk.flatten(2, 3).float()
            dq_blk += ds2 @ kf
        dq[:, :, :, sl] = (dq_blk * scale).view(b, kh, g, qc, d)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# pencil-window attention (the paper's cutoff transferred; O(S * window))
# ---------------------------------------------------------------------------

def window_attention_blocked(q: Tensor, k: Tensor, v: Tensor, *, window: int,
                             softcap: float = 0.0) -> Tensor:
    """Causal sliding-window attention via two-block pencils: tokens are
    grouped into blocks of ``window``; block i attends to blocks (i-1, i)
    with the exact (q - k < window, k <= q) mask. Requires S % window == 0.
    """
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    if s % window:
        raise ValueError(f"window_attention_blocked: S = {s} must be a "
                         f"multiple of window = {window}")
    nb = s // window
    qb = _split_gqa(q, kh).reshape(b, kh, g, nb, window, d) * d ** -0.5
    kb = k.reshape(b, kh, nb, window, d)
    vb = v.reshape(b, kh, nb, window, d)
    # previous block (pencil neighbour): shift right, zero-pad block -1
    k_prev = F.pad(kb[:, :, :-1], (0, 0, 0, 0, 1, 0))
    v_prev = F.pad(vb[:, :, :-1], (0, 0, 0, 0, 1, 0))
    k2 = torch.cat([k_prev, kb], dim=3).float()     # (b, kh, nb, 2w, d)
    v2 = torch.cat([v_prev, vb], dim=3).float()
    sc = _softcap(torch.einsum("bkgnqd,bknsd->bkgnqs", qb.float(), k2),
                  softcap)
    qpos = torch.arange(window, device=q.device)[:, None] + window
    kpos = torch.arange(2 * window, device=q.device)[None, :]
    mask = (kpos <= qpos) & (qpos - kpos < window)
    first = torch.arange(nb, device=q.device)[:, None, None] > 0
    mask = mask[None] & (first | (kpos[None] >= window))
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgnqs,bknsd->bkgnqd", p, v2)
    return o.reshape(b, h, s, d).to(q.dtype)


# ---------------------------------------------------------------------------
# decode: one new token vs cache
# ---------------------------------------------------------------------------

def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     cache_index: int, *, window: int = 0,
                     softcap: float = 0.0) -> Tensor:
    """q (B,H,1,D) vs cache (B,KH,S,D); positions > cache_index are masked,
    and positions <= cache_index - window when window > 0. (JAX's
    ``window_flag`` gates the window inside its traced layer scan; the
    port's layer loop slices the cache instead.)"""
    b, h, _, d = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    qg = _split_gqa(q, kh) * d ** -0.5              # (b, kh, g, 1, d)
    sc = _scores(qg, k_cache, softcap)
    kpos = torch.arange(s, device=q.device)
    valid = kpos <= cache_index
    if window > 0:
        valid = valid & (kpos > cache_index - window)
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return _pv(p, v_cache).reshape(b, h, 1, d).to(q.dtype)
