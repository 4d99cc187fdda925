"""mamba2-370m — SSM (state-space duality) [arXiv:2405.21060].

48L, d_model 1024, attention-free, ssm_state 128, vocab 50280.
Pure Mamba-2 blocks (no MLP): expand 2 ⇒ d_inner 2048, 32 heads of 64.
Tied embeddings.
"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        num_layers=48, d_model=1024, vocab_size=50280,
        pattern=(("mamba2", "none"),),
        ssm_state=128, ssm_head_dim=64, expand=2, conv_width=4,
        mlp="gelu", norm="rmsnorm", use_rope=False, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16,
        vocab_size=128, ssm_chunk=8)
