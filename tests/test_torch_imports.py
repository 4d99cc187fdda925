"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the reference package, and the entry
points refuse to fall back to the CPU when CUDA is absent."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [f for f in files if f.exists()]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _bad_imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    depth = len(path.relative_to(ROOT / "src").parts) - 1 \
        if PORT in path.parents else 0
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _forbidden(node.module or ""):
                bad.append(node.module)
            elif node.level > depth:        # relative import out of the port
                bad.append("." * node.level + (node.module or ""))
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            arg = node.args[0]
            if name in ("import_module", "__import__") and \
                    isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str) and _forbidden(arg.value):
                bad.append(arg.value)
    return bad


def test_port_imports_neither_jax_nor_reference():
    files = _sources()
    assert any(f.name == "engine.py" for f in files)
    # the walk globs the package: the forward slice's modules are in it
    for rel in ("models/transformer.py", "layers/attention.py",
                "layers/ssd.py", "layers/mlp.py",
                "kernels/flash_attention/kernel.py",
                "kernels/ssd_scan/kernel.py", "launch/profile_forward.py",
                "layers/rglru.py", "configs/granite_20b.py",
                "configs/starcoder2_3b.py", "configs/nemotron_4_340b.py",
                "configs/recurrentgemma_9b.py", "layers/moe.py",
                "configs/granite_moe_3b_a800m.py",
                "configs/moonshot_v1_16b_a3b.py", "configs/hubert_xlarge.py",
                "configs/internvl2_26b.py", "tree.py", "train/optimizer.py",
                "train/step.py", "train/loop.py", "data/pipeline.py",
                "distributed/compression.py", "launch/train.py",
                "launch/profile_train.py", "analysis/faults.py",
                "core/pptr.py", "core/layout.py", "core/atomics.py",
                "core/heap.py", "core/filters.py", "core/spans.py",
                "core/heap_recovery.py", "core/ralloc.py",
                "checkpoint/manager.py", "distributed/mesh.py",
                "distributed/specs.py", "launch/mesh_decode.py",
                "launch/mesh_depth.py", "launch/ranks.py",
                "launch/mesh_train.py", "distributed/sharding.py",
                "distributed/collectives.py"):
        assert PORT / rel in files, rel
    assert (ROOT / "chip_smoke.py") in files
    found = {str(f.relative_to(ROOT)): _bad_imports(f) for f in files}
    assert {k: v for k, v in found.items() if v} == {}


def test_import_checker_catches_forbidden_imports(tmp_path):
    p = PORT / "serving" / "engine.py"
    for src in ("import jax\n", "from repro.core import jax_alloc\n",
                "import repro\n", "from jax import numpy\n",
                "importlib.import_module('repro.configs')\n"):
        f = tmp_path / "m.py"
        f.write_text(src)
        assert _bad_imports(f), src
    assert _bad_imports(p) == []


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve, train
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the train entry points: the trainer and the CLI raise without CUDA
    # unless asked for the CPU, with --ckpt too (before making its heap)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(get_smoke_config("starcoder2-3b"), AdamWConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "starcoder2-3b", "--smoke", "--steps", "1"])
    heap = tmp_path / "train.heap"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "starcoder2-3b", "--smoke", "--steps", "1",
                    "--ckpt", str(heap)])
    assert not heap.exists()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "starcoder2-3b", "--smoke", "--steps", "3", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "final loss" in out.stdout
    cfg = get_smoke_config("qwen2.5-32b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, params, lanes=2, max_seq=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen2.5-32b", "--smoke", "--steps", "1"])
    # asked for the CPU, the same entry points run
    eng = ServingEngine(cfg, params, lanes=2, max_seq=32, device="cpu")
    eng.add_request([1, 2])
    assert eng.step() == {}              # still teacher-forcing the prompt
    serve.main(["--arch", "qwen2.5-32b", "--smoke", "--steps", "2",
                "--requests", "2", "--device", "cpu"])
    # and so do the MoE archs' (the serve CLI takes them like the others)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--steps",
                    "1"])
    serve.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--steps", "2",
                "--requests", "2", "--crash-at", "1", "--device", "cpu"])
