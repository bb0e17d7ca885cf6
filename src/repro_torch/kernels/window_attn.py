"""Sliding-window attention: the wrapper of kernel G.

Replaces ``repro/kernels/window_attn.py::window_attention``, the Pallas
flash-style kernel that keeps a query block resident while the KV blocks
inside the window stream through, and never loads those outside it. The
signature, layout and contract are JAX's: q (B, H, S, D), k and v
(B, KH, S, D), ``H % KH == 0`` and ``S % blk == 0``; the output has q's
dtype. ``blk`` sets the query block of the plain version; kernel G tiles
by its own rows and masks ragged tiles itself.

Kernel G has two routes, chosen by :func:`route` from the dtype and D:

* ``"wgmma"`` (``csrc/window_attn_sm90.cu``): bf16 with ``D % 16 == 0``
  and ``D <= 256``, on Hopper's tensor cores (wgmma, TMA, a warp-specialised
  producer); P is rounded to bf16 before P . V;
* ``"simt"`` (``csrc/window_attn.cu``): fp32, and bf16 at other head dims,
  in fp32 on the CUDA cores.

On a CPU tensor the wrapper runs :func:`window_attention_plain`; on a CUDA
tensor it launches kernel G or raises. ``window_attention.launches`` counts
the launches, ``window_attention.launches_by_route`` the launches of each
route.

``window_attention`` is a ``torch.autograd.Function``: its backward is
:func:`window_attention_bwd`, which launches kernel Gb
(``csrc/window_attn_bwd.cu``, fp32 arithmetic on the CUDA cores, three
launches a call) on a CUDA tensor or raises, and runs
:func:`window_attention_bwd_plain` on a CPU tensor.
``window_attention_bwd.launches`` counts its calls on the card. JAX has no
Pallas backward: it trains through XLA's autodiff of the plain
``window_attention_blocked``.
"""

from __future__ import annotations

import torch

from ._common import MAX_SMEM, launch

NEG_INF = -1.0e30
MAX_D = 256
TILE_Q, TILE_K = 32, 32               # window_attn.cu kBQ, kBK
WGMMA_Q, WGMMA_K, WGMMA_STAGES = 128, 64, 2   # window_attn_sm90.cu
BWD_TILE = 32                         # window_attn_bwd.cu kBQ = kBK
BWD_PLAIN_BLOCK = 128                 # queries a block of Gb's plain version
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, d: int) -> str:
    """Kernel G's route for inputs of ``dtype`` and head_dim ``d``: bf16
    with ``d % 16 == 0`` and ``d <= 256`` takes the tensor cores (bf16 wgmma
    needs a depth of 16); everything else the fp32 CUDA-core body, where
    TF32 tensor cores would miss the fp32 tolerance of 3e-4."""
    if dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= MAX_D:
        return "wgmma"
    return "simt"


def smem_bytes(d: int) -> int:
    """Shared memory the SIMT route stages per block: fp32 Q and K tiles at
    an odd number of float4s per row, and the V tile (window_attn.cu
    ``smem_bytes``)."""
    padded = 4 * ((d + 3) // 4 | 1)
    return 4 * ((TILE_Q + TILE_K) * padded + TILE_K * d)


def wgmma_smem_bytes(d: int) -> int:
    """Shared memory the wgmma route asks for per block (window_attn_sm90.cu
    ``smem_bytes``): the bf16 Q tile, the two-stage K and V ring, seven
    mbarriers and 1 KB to align the base to the 128-byte swizzle's
    1024-byte atom."""
    return (2 * d * (WGMMA_Q + 2 * WGMMA_STAGES * WGMMA_K)
            + 8 * (1 + 3 * WGMMA_STAGES) + 1024)


def bwd_smem_bytes(d: int) -> int:
    """Shared memory kernel Gb's dK/dV launch stages per block, its
    largest (window_attn_bwd.cu ``dkdv_smem``): fp32 Q, dout, K and V tiles
    at kernel G's padded stride, the P and dS tiles, lse and delta."""
    padded = 4 * ((d + 3) // 4 | 1)
    return 4 * (4 * BWD_TILE * padded + 2 * BWD_TILE * BWD_TILE
                + 2 * BWD_TILE)


def _check(q, k, v, window: int, blk: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"window_attention: q (B, H, S, D) and k, v "
                         f"(B, KH, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    kh = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or h % kh:
        raise ValueError(f"window_attention: shapes {tuple(q.shape)} and "
                         f"{tuple(k.shape)} need equal B, S, D and H % KH "
                         f"== 0")
    if blk < 1 or s % blk:
        raise ValueError(f"window_attention: S = {s} must be a multiple of "
                         f"blk = {blk}")
    if window < 1:
        raise ValueError(f"window_attention: window {window} < 1")


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, window: int, blk: int = 128,
                           softcap: float = 0.0) -> torch.Tensor:
    """Kernel G's plain version: for each block of ``blk`` queries, the
    exact masked softmax over the keys of its window, in fp32."""
    _check(q, k, v, window, blk)
    b, h, s, d = q.shape
    kh = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, kh, h // kh, s, d) * scale
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    out = torch.empty_like(qf)
    pos = torch.arange(s, device=q.device)
    for q0 in range(0, s, blk):
        q1 = q0 + blk
        k0 = max(0, q0 - window + 1)
        sc = qf[..., q0:q1, :] @ kf[..., k0:q1, :].transpose(-1, -2)
        if softcap > 0.0:
            sc = softcap * torch.tanh(sc / softcap)
        qp, kp = pos[q0:q1, None], pos[None, k0:q1]
        mask = (kp <= qp) & (qp - kp < window)
        sc = torch.where(mask, sc, NEG_INF)
        p = torch.exp(sc - sc.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        out[..., q0:q1, :] = (p @ vf[..., k0:q1, :]) / l
    return out.reshape(b, h, s, d).to(q.dtype)


def _check_cuda(what: str, tensors) -> None:
    """Raise unless the named tensors share one dtype, float32 or bfloat16,
    and one device."""
    (_, first), rest = tensors[0], tensors[1:]
    if first.dtype not in _DTYPE_CODE or any(
            t.dtype != first.dtype or t.device != first.device
            for _, t in rest):
        got = ", ".join(f"{n} {t.dtype} on {t.device}" for n, t in tensors)
        raise ValueError(f"{what} takes {', '.join(n for n, _ in tensors)} "
                         f"of one dtype, float32 or bfloat16, on one device; "
                         f"got {got}")


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, blk: int = 128,
                     softcap: float = 0.0) -> torch.Tensor:
    """Causal sliding-window attention: key j is visible to query i when
    ``j <= i`` and ``i - j < window``. Returns (B, H, S, D) in q's dtype.
    Differentiable in q, k and v (kernel Gb on the card)."""
    _check(q, k, v, window, blk)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _WindowAttention.apply(q, k, v, window, blk, softcap)


class _WindowAttention(torch.autograd.Function):
    """Kernel G forward, kernel Gb backward (plain versions on the CPU).
    Saves q, k, v and the output, as JAX's ``_flash_fwd`` saves its
    residuals; Gb recomputes each row's log-sum-exp itself."""

    @staticmethod
    def forward(ctx, q, k, v, window, blk, softcap):
        out = _forward(q, k, v, window=window, blk=blk, softcap=softcap)
        ctx.save_for_backward(q, k, v, out)
        ctx.window, ctx.softcap = window, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = window_attention_bwd(q, k, v, out, dout,
                                          window=ctx.window,
                                          softcap=ctx.softcap)
        return dq, dk, dv, None, None, None


def _forward(q, k, v, *, window: int, blk: int, softcap: float):
    """Kernel G on a CUDA tensor, its plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, window=window, blk=blk,
                                      softcap=softcap)
    _check_cuda("window_attention: kernel G", [("q", q), ("k", k),
                                               ("v", v)])
    b, h, s, d = q.shape
    if d > MAX_D:
        raise ValueError(f"window_attention: kernel G takes head_dim <= "
                         f"{MAX_D}, got {d}")
    way = route(q.dtype, d)
    if way == "simt" and smem_bytes(d) > MAX_SMEM:
        raise ValueError(f"window_attention: head_dim {d} needs "
                         f"{smem_bytes(d)} bytes of shared memory, at most "
                         f"{MAX_SMEM}")
    if way == "simt" and b * h > 65535:
        raise ValueError(f"window_attention: B * H = {b * h} > 65535")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if way == "wgmma":
        # TMA reads q, k and v from 16-byte aligned bases
        bad = [n for n, t in (("q", q), ("k", k), ("v", v))
               if t.data_ptr() % 16]
        if bad:
            raise ValueError(f"window_attention: kernel G's wgmma route "
                             f"needs 16-byte aligned {bad}")
        launch("window_attn_sm90.cu", "window_attention_sm90", q, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, k.shape[1],
               s, d, int(window), float(softcap), 1.0 / (d ** 0.5))
    else:
        launch("window_attn.cu", "window_attention_fwd", q, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, k.shape[1],
               s, d, int(window), float(softcap), 1.0 / (d ** 0.5),
               _DTYPE_CODE[q.dtype])
    window_attention.launches += 1
    window_attention.launches_by_route[way] += 1
    return out


window_attention.launches = 0
window_attention.launches_by_route = {"wgmma": 0, "simt": 0}


# ---------------------------------------------------------------------------
# backward: kernel Gb
# ---------------------------------------------------------------------------


def window_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               dout: torch.Tensor, *, window: int,
                               softcap: float = 0.0):
    """Kernel Gb's plain version: the gradient of
    :func:`window_attention_plain` by its explicit formulas, per block of
    ``BWD_PLAIN_BLOCK`` queries over the keys of its window, in fp32 (JAX's
    ``_flash_bwd`` on the window's band): P from each row's log-sum-exp,
    ``delta = rowsum(dout * out)``, the softcap derivative with ``s / cap``
    clipped to [-1, 1], dK and dV summed over the GQA group. -> (dq, dk,
    dv) in the inputs' dtypes."""
    _check(q, k, v, window, 1)
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, kh, g, s, d) * scale
    dof = dout.float().reshape(b, kh, g, s, d)
    delta = (dof * out.float().reshape(b, kh, g, s, d)).sum(-1)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    dq = torch.empty_like(qf)
    dk = torch.zeros((b, kh, s, d), device=q.device)
    dv = torch.zeros((b, kh, s, d), device=q.device)
    pos = torch.arange(s, device=q.device)
    for q0 in range(0, s, BWD_PLAIN_BLOCK):
        q1 = min(q0 + BWD_PLAIN_BLOCK, s)
        k0 = max(0, q0 - window + 1)
        sc = qf[..., q0:q1, :] @ kf[..., k0:q1, :].transpose(-1, -2)
        if softcap > 0.0:
            sc = softcap * torch.tanh(sc / softcap)
        qp, kp = pos[q0:q1, None], pos[None, k0:q1]
        mask = (kp <= qp) & (qp - kp < window)
        sc = torch.where(mask, sc, NEG_INF)
        lse = torch.logsumexp(sc, -1, keepdim=True)
        p = torch.where(mask, torch.exp(sc - lse), 0.0)
        dp = dof[..., q0:q1, :] @ vf[..., k0:q1, :].transpose(-1, -2)
        ds = p * (dp - delta[..., q0:q1, None])
        if softcap > 0.0:
            t = torch.clamp(sc / softcap, -1.0, 1.0)
            ds = ds * (1.0 - t * t)
        dq[..., q0:q1, :] = ds @ kf[..., k0:q1, :]
        dk[:, :, k0:q1] += (ds.transpose(-1, -2) @ qf[..., q0:q1, :]).sum(2)
        dv[:, :, k0:q1] += (p.transpose(-1, -2) @ dof[..., q0:q1, :]).sum(2)
    return ((dq * scale).reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def window_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, dout: torch.Tensor, *,
                         window: int, softcap: float = 0.0):
    """The gradient of :func:`window_attention` at output ``out`` and
    output gradient ``dout``: kernel Gb on CUDA tensors, its plain version
    on CPU tensors. -> (dq (B, H, S, D), dk, dv (B, KH, S, D)) in the
    inputs' dtype."""
    _check(q, k, v, window, 1)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"window_attention_bwd: out and dout must have q's "
                         f"shape {tuple(q.shape)}, got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}")
    if q.device.type == "cpu":
        return window_attention_bwd_plain(q, k, v, out, dout, window=window,
                                          softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_bwd runs on cpu or cuda, not "
                         f"{q.device}")
    _check_cuda("window_attention_bwd: kernel Gb",
                [("q", q), ("k", k), ("v", v), ("out", out),
                 ("dout", dout)])
    b, h, s, d = q.shape
    if d > MAX_D:
        raise ValueError(f"window_attention_bwd: kernel Gb takes head_dim "
                         f"<= {MAX_D}, got {d}")
    if bwd_smem_bytes(d) > MAX_SMEM:
        raise ValueError(f"window_attention_bwd: head_dim {d} needs "
                         f"{bwd_smem_bytes(d)} bytes of shared memory, at "
                         f"most {MAX_SMEM}")
    if b * h > 65535:
        raise ValueError(f"window_attention_bwd: B * H = {b * h} > 65535")
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    launch("window_attn_bwd.cu", "window_attention_bwd", q, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), b, h, k.shape[1], s, d, int(window),
           float(softcap), 1.0 / (d ** 0.5), _DTYPE_CODE[q.dtype])
    window_attention_bwd.launches += 1
    return dq, dk, dv


window_attention_bwd.launches = 0
