"""Architecture registry of the port.

``get_config(arch)`` returns the published configuration;
``get_smoke_config(arch)`` a reduced same-family configuration for CPU
tests.  The registry holds the reference's ten architectures: the port
serves, and runs the full-sequence forward of, the dense, MoE, Mamba-2 and
RG-LRU hybrid families, and runs the forward of the two encoder / front-end
stubs (hubert-xlarge, internvl2-26b) on ``batch["embeds"]``.
"""

from __future__ import annotations

import importlib

ARCHS = ("qwen2_5_32b", "mamba2_370m", "granite_20b", "starcoder2_3b",
         "nemotron_4_340b", "recurrentgemma_9b", "granite_moe_3b_a800m",
         "moonshot_v1_16b_a3b", "hubert_xlarge", "internvl2_26b")


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = canon(arch)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
