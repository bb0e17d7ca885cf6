"""phi-3-vision-4.2b [vlm] — 32L d3072 32H (kv=32) d_ff=8192 vocab=32064,
phi3-mini backbone + CLIP frontend (a stub: the model takes precomputed
patch embeddings, ``patch_embeds``, put before the prompt's token
embeddings). [hf:microsoft/Phi-3-vision-128k-instruct; hf]

The numbers are copied from ``repro/configs/phi_3_vision_4_2b.py``: RoPE
over the image prefix and the prompt, RMSNorm, the gated SiLU MLP; every
layer takes the global attention path."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab_size=32064, head_dim=96, n_img_tokens=64,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=16, n_img_tokens=8, dtype="float32")
