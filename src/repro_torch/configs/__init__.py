"""Architecture registry of the port.

``get_config(arch)`` returns the published configuration;
``get_smoke_config(arch)`` a reduced same-family configuration for CPU
tests.  The port serves qwen2.5-32b and runs the full-sequence forward of
qwen2.5-32b and mamba2-370m.
"""

from __future__ import annotations

import importlib

ARCHS = ("qwen2_5_32b", "mamba2_370m")


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
