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
"""

from __future__ import annotations

import torch

from ._common import MAX_SMEM, launch

NEG_INF = -1.0e30
MAX_D = 256
TILE_Q, TILE_K = 32, 32               # window_attn.cu kBQ, kBK
WGMMA_Q, WGMMA_K, WGMMA_STAGES = 128, 64, 2   # window_attn_sm90.cu
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


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, blk: int = 128,
                     softcap: float = 0.0) -> torch.Tensor:
    """Causal sliding-window attention: key j is visible to query i when
    ``j <= i`` and ``i - j < window``. Returns (B, H, S, D) in q's dtype."""
    _check(q, k, v, window, blk)
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, window=window, blk=blk,
                                      softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if (q.dtype not in _DTYPE_CODE or k.dtype != q.dtype
            or v.dtype != q.dtype or k.device != q.device
            or v.device != q.device):
        raise ValueError(f"window_attention: kernel G takes q, k, v of one "
                         f"dtype, float32 or bfloat16, on one device; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype} on {q.device}, "
                         f"{k.device}, {v.device}")
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
