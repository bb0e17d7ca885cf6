"""whisper-base [audio] — 6L enc + 6L dec, d512 8H d_ff=2048 vocab=51865,
enc-dec; the conv frontend is a stub: the encoder takes precomputed frame
embeddings (``frame_embeds``), enc_seq padded 1500 -> 1536 for chunked
attention. [arXiv:2212.04356; unverified]

The numbers are copied from ``repro/configs/whisper_base.py``. Sinusoidal
positions and no RoPE (``use_rope=False``), LayerNorm with bias, the
ungated tanh-GELU MLP, a tied LM head; every attention is the global
flash (the encoder's and the cross-attention's non-causal)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
        vocab_size=51865, head_dim=64, norm="ln", act="gelu",
        use_rope=False, n_enc_layers=6, enc_seq=1536, tie_embeddings=True,
        mlp_gated=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=16, norm="ln", act="gelu",
        use_rope=False, n_enc_layers=2, enc_seq=16, tie_embeddings=True,
        mlp_gated=False, dtype="float32")
