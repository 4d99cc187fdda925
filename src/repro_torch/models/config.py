"""Model configuration (the port's copy of the reference ``ModelConfig``).

A model is a stack of (mixer, ffn) layer specs cycled from ``pattern``:

  mixer ∈ {"attn", "local_attn", "mamba2", "rglru"}
  ffn   ∈ {"mlp", "moe", "none"}

Field names and defaults match the reference so a configuration maps
one to one; ``dtype`` is a torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # layer pattern: tuple of (mixer, ffn) cycled over layers
    pattern: tuple[tuple[str, str], ...] = (("attn", "mlp"),)
    # attention options
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 1e4
    causal: bool = True
    window: int = 0                # local-attention window (0 = full)
    # ffn options
    mlp: str = "swiglu"            # swiglu | squared_relu | gelu
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    # moe
    num_experts: int = 0
    top_k: int = 0
    expert_pad: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "local"
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4
    expand: int = 2
    # hybrid (rg-lru)
    lru_width: int = 0
    # modality frontend stub: None | "audio" | "vision"
    frontend: str | None = None
    # numerics / memory
    dtype: Any = torch.bfloat16
    remat: str = "unit"
    attn_impl: str = "chunked"
    # serving
    page_size: int = 128           # KV-arena tokens per page
    kv_dtype: str = "bf16"         # bf16 | int8 (per-slot-per-head scales)

    @property
    def layer_specs(self) -> tuple[tuple[str, str], ...]:
        m = len(self.pattern)
        return tuple(self.pattern[i % m] for i in range(self.num_layers))

    @property
    def full_units(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def tail_specs(self) -> tuple[tuple[str, str], ...]:
        r = self.num_layers % len(self.pattern)
        return self.pattern[:r]

    @property
    def attn_layers(self) -> int:
        return sum(1 for mx, _ in self.layer_specs
                   if mx in ("attn", "local_attn"))

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once per table),
        the reference's: projections only, the padded experts left out."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings and self.vocab_size:
            n += self.vocab_size * self.d_model
        for mixer, ffn in self.layer_specs:
            if mixer in ("attn", "local_attn"):
                n += self.d_model * (self.num_heads + 2 * self.num_kv_heads) \
                     * self.head_dim
                n += self.num_heads * self.head_dim * self.d_model
            elif mixer == "mamba2":
                di = self.expand * self.d_model
                h = di // self.ssm_head_dim
                n += self.d_model * (2 * di + 2 * self.ssm_state + h)
                n += di * self.d_model
            elif mixer == "rglru":
                w = self.lru_width
                n += 2 * self.d_model * w + 2 * w * w + w * self.d_model
            k = 3 if self.mlp == "swiglu" else 2
            if ffn == "mlp":
                n += k * self.d_model * self.d_ff
            elif ffn == "moe":
                n += self.num_experts * k * self.d_model * self.d_ff
                n += self.d_model * self.num_experts
        return n
