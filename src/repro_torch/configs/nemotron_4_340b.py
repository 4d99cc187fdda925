"""nemotron-4-340b — dense LM [arXiv:2402.16819].

96L, d_model 18432, 96 heads (GQA kv=8), head_dim 192, d_ff 73728,
vocab 256000.  Squared-ReLU (non-gated) MLP, LayerNorm, RoPE, no bias.
"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
        head_dim=192, d_ff=73728, vocab_size=256000,
        mlp="squared_relu", norm="layernorm", use_rope=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
        head_dim=16, d_ff=384, vocab_size=128)
