"""qwen2.5-32b — dense LM (Qwen/Qwen2.5-32B config.json).

64L, d_model 5120, 40 heads (GQA kv=8), head_dim 128, d_ff 27648,
vocab 152064.  SwiGLU, RMSNorm, RoPE (theta 1e6), QKV bias.
"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=27648, vocab_size=152064,
        mlp="swiglu", norm="rmsnorm", use_rope=True, qkv_bias=True,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=128)
