"""granite-moe-3b-a800m — MoE LM [hf:ibm-granite/granite-3.0-1b-a400m; hf].

32L, d_model 1536, 24 heads (GQA kv=8), per-expert d_ff 512,
vocab 49155, 40 experts top-8.  SwiGLU experts, RMSNorm, RoPE.
"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
        head_dim=64, d_ff=512, vocab_size=49155,
        pattern=(("attn", "moe"),),
        num_experts=40, top_k=8, expert_pad=8,  # 48 = 3 x 16 for EP
        mlp="swiglu", norm="rmsnorm", use_rope=True, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=128, num_experts=8, top_k=2)
