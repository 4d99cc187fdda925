"""granite-20b — dense code LM [arXiv:2405.04324; hf].

52L, d_model 6144, 48 heads (GQA kv=1 ⇒ MQA), d_ff 24576, vocab 49152.
GPT-BigCode lineage: non-gated GELU MLP, LayerNorm; RoPE enabled.
"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense",
        num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
        head_dim=128, d_ff=24576, vocab_size=49152,
        mlp="gelu", norm="layernorm", use_rope=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=256, vocab_size=128)
