"""internvl2-26b — VLM [arXiv:2404.16821; hf].

Backbone only: InternLM2-20B-style decoder — 48L, d_model
6144, 48 heads (GQA kv=8), d_ff 16384, vocab 92553, SwiGLU, RMSNorm.
The InternViT frontend is a STUB: ``batch["embeds"]`` carries
precomputed patch embeddings [B, S, d_model] (vision tokens and the
projected text, mixed).
"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=92553,
        mlp="swiglu", norm="rmsnorm", use_rope=True,
        frontend="vision",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=128)
