"""The training layout's specs against the reference's, and what the
sharded train step refuses (no ranks: nothing here starts a process).

- ``train_param_specs`` of all ten archs' published configs equal the
  reference's ``PartitionSpec``s (as tuples) on (2, 2), (1, 4) and the
  (16, 16) production mesh, over the reference's abstract parameter
  shapes, and over the port's own tree (``param_shapes``: meta tensors).
- The counterpart of ``tests/test_baselines_and_sharding.py::
  test_train_specs_divisibility_fallback``, ``batch_spec`` and
  ``opt_state_specs``; ``make_batch_constrainer`` checks the batch shard.
- RG-LRU with ``model`` > 1 and MoE on any mesh of more than one rank
  raise ``NotImplementedError`` naming ROADMAP A8b (2); ranks asked to run
  on ``cuda`` without it raise before any process starts.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS, get_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models.params import param_shapes  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

MESHES = [(2, 2), (1, 4), (16, 16)]


class _FakeMesh:
    """What the reference's rules read of a mesh: names and sizes."""

    def __init__(self, data, model):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


class _ShapeMesh:
    """What the port's ``check_mesh`` reads of a ``DeviceMesh``."""

    def __init__(self, data, model):
        self.mesh_dim_names = ("data", "model")
        self.shape = (data, model)

    def size(self):
        return self.shape[0] * self.shape[1]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}".lstrip("/")))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_param_specs_match_reference(arch, mesh):
    cfg = get_config(arch)
    shapes = jax.eval_shape(lambda: JT.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    want = _flat(jsh.train_param_specs(shapes, _FakeMesh(*mesh)))
    sizes = {"data": mesh[0], "model": mesh[1]}
    got = _flat(tsh.train_param_specs(shapes, sizes))
    assert got.keys() == want.keys()
    for path, spec in want.items():
        assert got[path] == tuple(spec), (path, got[path], spec)
    # the port's own tree: its paths and shapes give the same specs
    own = _flat(tsh.train_param_specs(param_shapes(t_get(arch)), sizes))
    assert own == got


def test_train_specs_divisibility_fallback():
    """The reference's fallback cases, on the port's rules (a path with
    and without the leading ``/`` of ``init_params``)."""
    mesh = {"data": 16, "model": 16}
    spec = tsh.train_param_spec
    assert spec("embed", (92553, 6144), mesh) == (None, "data")
    assert spec("/embed", (49152, 6144), mesh) == ("model", "data")
    for path in ("units/l0/attn/wq", "/units/l0/attn/wq"):
        assert spec(path, (52, 6144, 6144), mesh) == (None, "data", "model")
    # kv=1 projection: 128 columns still divide 16
    assert spec("units/l0/attn/wk", (52, 6144, 128), mesh) == \
        (None, "data", "model")
    # moe experts: E=48 divides
    assert spec("units/l0/ffn/wi", (32, 48, 1536, 512), mesh) == \
        (None, "model", "data", None)
    # a tail layer has no unit dim; a norm is replicated
    assert spec("tail/t0/ssd/out_proj", (4096, 2048), mesh) == \
        ("model", "data")
    assert spec("/units/l0/norm1/w", (38, 4096), mesh) == (None, None)


def test_batch_and_opt_state_specs():
    for shape in ((2, 2), (1, 4), (16, 16)):
        sizes = {"data": shape[0], "model": shape[1]}
        assert tsh.batch_spec(sizes) == (("data",),)
        # JAX writes a one-axis tuple as the axis name
        assert tuple(jsh.batch_spec(_FakeMesh(*shape))) in \
            ((("data",),), ("data",))
    pod = {"pod": 2, "data": 16, "model": 16}
    assert tsh.batch_spec(pod) == (("pod", "data"),)
    specs = tsh.train_param_specs(param_shapes(t_smoke("qwen2.5-32b")),
                                  {"data": 2, "model": 2})
    assert tsh.opt_state_specs(specs) == jsh.opt_state_specs(specs) == \
        {"m": specs, "v": specs}


def test_batch_constrainer_checks_the_shard():
    """No mesh: the identity.  On a mesh it passes the rank's batch shard
    through and raises on any other dim 0."""
    x = torch.zeros(3, 5)
    assert tsh.make_batch_constrainer(None)(x) is x
    f = tsh.make_batch_constrainer(_ShapeMesh(2, 2), local_batch=3)
    assert f(x) is x
    with pytest.raises(ValueError, match="batch shard is 3"):
        f(torch.zeros(6, 5))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
def test_moe_on_a_mesh_is_deferred(arch, mesh):
    cfg = dataclasses.replace(t_smoke(arch), dtype=torch.float32)
    with pytest.raises(NotImplementedError, match=r"A8b \(2\)"):
        make_train_step(cfg, AdamWConfig(), mesh=_ShapeMesh(*mesh))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)])
def test_rglru_with_model_parallel_is_deferred(mesh):
    cfg = dataclasses.replace(t_smoke("recurrentgemma-9b"),
                              dtype=torch.float32)
    with pytest.raises(NotImplementedError, match=r"A8b \(2\)"):
        make_train_step(cfg, AdamWConfig(), mesh=_ShapeMesh(*mesh))


def _never(rank, world, job):
    raise AssertionError("a rank started")


def test_ranks_on_cuda_without_it_raise():
    """``run_ranks`` runs on ``cuda`` unless told otherwise; without CUDA
    it raises before starting any process."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_ranks(_never, 2, {}, **kw)
