"""PyTorch/CUDA port of the ``repro`` package (paged serving over the
device Ralloc arena), for one NVIDIA H100.

The package imports ``torch`` and never JAX or the reference package:
what it needs from framework-free reference modules it keeps as its own
copy.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA they raise rather than fall back.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
