"""starcoder2-3b — dense code LM [arXiv:2402.19173; hf].

30L, d_model 3072, 24 heads (GQA kv=2), d_ff 12288, vocab 49152.
Non-gated GELU MLP, LayerNorm, RoPE, tied embeddings, QKV bias.
"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
        head_dim=128, d_ff=12288, vocab_size=49152,
        mlp="gelu", norm="layernorm", use_rope=True, tie_embeddings=True,
        qkv_bias=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=128)
