"""recurrentgemma-9b — hybrid RG-LRU + local attention [arXiv:2402.19427].

38L, d_model 4096, 16 heads (GQA kv=1 ⇒ MQA) head_dim 256, d_ff 12288,
vocab 256000, window 2048, pattern 2×recurrent : 1×local-attn.
38 = 12 full (rec, rec, attn) units + a (rec, rec) tail.
"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        head_dim=256, d_ff=12288, vocab_size=256000,
        pattern=(("rglru", "mlp"), ("rglru", "mlp"), ("local_attn", "mlp")),
        window=2048, lru_width=4096, conv_width=4,
        mlp="swiglu", norm="rmsnorm", use_rope=True, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=256, vocab_size=128, window=16, lru_width=64)
