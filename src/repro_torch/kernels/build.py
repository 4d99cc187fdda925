"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and links into ONE shared
library with a plain C interface, loaded with ``ctypes``.  The library
is built at first use from the sources in this checkout, into
``_build/`` beside this package (listed in ``.gitignore``), and named by
a hash of the sources, the headers they include (``csrc/*.cuh``) and the
flags, so an edit never loads a stale build.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_lib = None
build_info: dict = {}          # seconds, library path and nvcc's output


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources(csrc: Path | None = None) -> list[Path]:
    """The translation units: every ``*.cu`` (each compiled on its own)."""
    return sorted((csrc or CSRC).glob("*.cu"))


def _digest(csrc: Path | None = None) -> str:
    """A hash of the flags and of every ``*.cu`` and ``*.cuh`` under
    ``csrc``: an edit to a header renames the library as an edit to a
    source does."""
    csrc = csrc or CSRC
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    sources = _sources()
    out = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if out.exists():
        build_info.update(seconds=0.0, library=str(out), log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for src, proc in zip(sources, procs):
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, library=str(out),
                      log="\n".join(logs))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kv_update_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.kv_update_launch.restype = i
        lib.rope_kv_append_launch.argtypes = [p] * 12 + [i] * 12 + [p]
        lib.rope_kv_append_launch.restype = i
        lib.rope_kv_append_int8_launch.argtypes = [p] * 14 + [i] * 12 + [p]
        lib.rope_kv_append_int8_launch.restype = i
        lib.paged_attention_launch.argtypes = [p] * 11 + [i] * 6 + [
            ctypes.c_float, i, i, i, p]
        lib.paged_attention_launch.restype = i
        lib.paged_attention_int8_launch.argtypes = [p] * 13 + [i] * 6 + [
            ctypes.c_float, i, i, i, p]
        lib.paged_attention_int8_launch.restype = i
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_bwd_launch.argtypes = [p] * 13 + [i] * 9 + [
            ctypes.c_float, i, p]
        lib.flash_attention_bwd_launch.restype = i
        lib.ssd_scan_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                        i, p]
        lib.ssd_scan_launch.restype = i
        lib.ssd_scan_bwd_launch.argtypes = [p] * 12 + [i] * 5 + [p]
        lib.ssd_scan_bwd_launch.restype = i
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
