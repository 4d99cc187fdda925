"""moonshot-v1-16b-a3b — MoE LM [hf:moonshotai/Moonlight-16B-A3B; hf].

48L, d_model 2048, 16 heads (kv=16 ⇒ MHA), per-expert d_ff 1408,
vocab 163840, 64 experts top-6.  SwiGLU experts, RMSNorm, RoPE.
(Moonlight's shared expert is folded into the routed pool, as in the
reference.)
"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=163840,
        pattern=(("attn", "moe"),),
        num_experts=64, top_k=6,
        mlp="swiglu", norm="rmsnorm", use_rope=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=64, vocab_size=128, num_experts=8, top_k=2)
