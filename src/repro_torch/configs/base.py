"""The port's copy of the JAX package's config schema.

``ModelConfig``, ``ShapeCell``, ``SHAPES``, ``shape_by_name`` and
``cell_is_runnable`` are copied from ``repro/configs/base.py``, which
imports JAX. ``input_specs`` (the dry-run's stand-ins) belongs to the
dry-run tools and is not ported (ROADMAP Queue 1 item 13.6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False           # qwen1.5
    norm: str = "rms"                # rms | ln
    act: str = "silu"                # silu | gelu
    mlp_gated: bool = True           # GLU (3 mats) vs plain MLP (2 mats)
    rope_theta: float = 10_000.0
    use_rope: bool = True            # whisper: sinusoidal instead
    tie_embeddings: bool = False
    attn_q_chunk: int = 512          # flash-attention chunking (perf knobs)
    attn_k_chunk: int = 512

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    hybrid_attn_every: int = 0       # zamba2: shared attn block period

    # gemma2
    local_global: bool = False       # alternate local/global attention
    window: int = 4096
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    post_norms: bool = False         # gemma2 sandwich norms
    scale_embed: bool = False        # gemma2 sqrt(d) embed scaling

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0                 # stub frontend: frames fed pre-embedded

    # vlm (phi-3-vision): stub frontend feeds patch embeddings
    n_img_tokens: int = 0

    # numerics
    dtype: str = "bfloat16"
    moment_dtype: str = "float32"    # adam moments; bf16 for the giants
    dryrun_microbatches: int = 1     # grad-accumulation for the train cell
    pure_dp: bool = False            # small models: model axis joins DP

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid only, per assignment)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for roofline math."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        mlp_dense = (3 if self.mlp_gated else 2) * d * f
        per_layer = 0
        if self.family == "ssm":
            per_layer = self._mamba_params()
        elif self.family == "hybrid":
            per_layer = self._mamba_params()
        else:
            per_layer = attn
            if self.n_experts:
                per_layer += self.n_experts * 3 * d * f + d * self.n_experts
                if self.moe_dense_residual:
                    per_layer += mlp_dense
            else:
                per_layer += mlp_dense
        total = self.n_layers * per_layer + v * d
        if self.family == "hybrid" and self.hybrid_attn_every:
            total += attn + mlp_dense                       # one shared block
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn + mlp_dense)
            total += self.n_layers * attn                   # cross attention
        if not self.tie_embeddings:
            total += v * d
        return total

    def _mamba_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        g_bc = 2 * n                       # single-group B and C
        in_proj = d * (2 * di + g_bc + self.ssm_heads)
        return in_proj + di * d + self.ssm_conv * (di + g_bc) + 2 * di

    def active_param_count(self) -> int:
        """MoE: params touched per token (top_k experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * d * f
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (shape) cell: what gets lowered in the dry-run."""
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_is_runnable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Assignment skip rules. Returns (runnable, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is {cfg.family} (full attention)")
    return True, ""
