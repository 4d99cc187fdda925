"""hubert-xlarge — audio encoder [arXiv:2106.07447; unverified].

48L encoder-only (bidirectional), d_model 1280, 16 heads (MHA),
d_ff 5120, vocab 504 (masked-prediction codebook targets).
The conv waveform frontend is a STUB: ``batch["embeds"]`` carries
precomputed frame embeddings [B, S, 1280].  No decode shapes
(encoder-only).
"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
        head_dim=80, d_ff=5120, vocab_size=504,
        mlp="gelu", norm="layernorm", use_rope=False, causal=False,
        frontend="audio",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=256, vocab_size=64)
