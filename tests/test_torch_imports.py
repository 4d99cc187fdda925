"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the reference package, and the entry
points refuse to fall back to the CPU when CUDA is absent."""

import ast
import pathlib

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


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
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
