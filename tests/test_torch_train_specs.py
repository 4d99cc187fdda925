"""The training layout's specs against the reference's, and what the
sharded train step refuses (no ranks: nothing here starts a process).

- ``train_param_specs`` of all ten archs' published configs equal the
  reference's ``PartitionSpec``s (as tuples) on (2, 2), (1, 4) and the
  (16, 16) production mesh, over the reference's abstract parameter
  shapes, and over the port's own tree (``param_shapes``: meta tensors).
- The counterpart of ``tests/test_baselines_and_sharding.py::
  test_train_specs_divisibility_fallback``, ``batch_spec`` and
  ``opt_state_specs``; ``make_batch_constrainer`` checks the batch shard.
- MoE on any mesh of more than one rank raises ``NotImplementedError``
  naming ROADMAP A8b (2); the RG-LRU mixer with ``model`` > 1 builds.
- The plan of a split dim (``unit_ranges``) covers every query head, d_ff
  column, SSD head and RG-LRU channel of the ten published configs once
  at model 2, 3, 4, 8 and 16, and every KV head a rank's query heads
  read; ``make_train_step`` builds for every dense and hybrid arch on
  (16, 16), (1, 3), (1, 4) and (2, 2), and every MoE arch raises; the
  layers raise where a rank would hold no unit.
- Ranks asked to run on ``cuda`` without it raise before any process
  starts.
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
from repro_torch.distributed.collectives import unit_ranges  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.layers.attention import kv_heads_of_rank, \
    kv_map_of_rank  # noqa: E402
from repro_torch.layers.mlp import apply_mlp  # noqa: E402
from repro_torch.layers.ssd import mamba2_forward, n_heads  # noqa: E402
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
    """What the port's ``check_mesh`` and ``make_train_step`` read of a
    ``DeviceMesh`` (this process as rank 0)."""

    def __init__(self, data, model):
        self.mesh_dim_names = ("data", "model")
        self.shape = (data, model)

    def size(self):
        return self.shape[0] * self.shape[1]

    def get_local_rank(self, axis):
        return 0


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
def test_rglru_with_model_parallel_builds(mesh):
    cfg = dataclasses.replace(t_smoke("recurrentgemma-9b"),
                              dtype=torch.float32)
    assert callable(make_train_step(cfg, AdamWConfig(),
                                    mesh=_ShapeMesh(*mesh)))


def _is_moe(cfg):
    return any(f == "moe" for _, f in cfg.layer_specs)


def _split_dims(cfg):
    """{name: units} of every dim the layers of ``cfg`` split over
    ``model`` by the plan."""
    mixers = {m for m, _ in cfg.layer_specs}
    ffns = {f for _, f in cfg.layer_specs}
    out = {}
    if mixers & {"attn", "local_attn"}:
        out["query heads"] = cfg.num_heads
    if "mlp" in ffns:
        out["d_ff"] = cfg.d_ff
    if "mamba2" in mixers:
        out["SSD heads"] = n_heads(cfg)
    if "rglru" in mixers:
        out["RG-LRU channels"] = cfg.lru_width
    return out


def test_plan_covers_every_unit_and_the_step_builds():
    """At model 2, 3, 4, 8 and 16, over the ten published configs: every
    split dim's ranges tile it (each unit once, in order); the KV heads a
    rank reads hold every query head's, and a rank's ``kv_map`` (where
    given) maps each of its heads to its own; ``make_train_step`` builds
    for every dense and hybrid arch on (16, 16), (1, 3), (1, 4) and
    (2, 2); every MoE arch raises, naming ROADMAP A8b (2)."""
    for arch in ARCHS:
        cfg = t_get(arch)
        dims = _split_dims(cfg)
        assert dims, arch
        for tp in (2, 3, 4, 8, 16):
            for name, n in dims.items():
                ranges = unit_ranges(n, tp)
                assert [u for lo, hi in ranges for u in range(lo, hi)] == \
                    list(range(n)), (arch, name, tp)
                assert all(hi > lo for lo, hi in ranges), (arch, name, tp)
            if "query heads" not in dims:
                continue
            H, K = cfg.num_heads, cfg.num_kv_heads
            for r, (q0, q1) in enumerate(unit_ranges(H, tp)):
                k0, k1 = kv_heads_of_rank(H, K, tp, r)
                idx = kv_map_of_rank(H, K, tp, r)
                hl, kl = q1 - q0, k1 - k0
                for j in range(hl):
                    want = (q0 + j) // (H // K) - k0
                    got = idx[j] if idx is not None else j // (hl // kl)
                    assert got == want and 0 <= got < kl, (arch, tp, r, j)
        for mesh in ((16, 16), (1, 3), (1, 4), (2, 2)):
            if _is_moe(cfg):
                with pytest.raises(NotImplementedError,
                                   match=r"A8b \(2\)"):
                    make_train_step(cfg, AdamWConfig(),
                                    mesh=_ShapeMesh(*mesh))
            else:
                assert callable(make_train_step(cfg, AdamWConfig(),
                                                mesh=_ShapeMesh(*mesh)))


def test_layers_raise_where_a_rank_would_hold_no_unit():
    """2 query heads, d_ff 2 and 2 SSD heads over model 3: the plan and
    the layers raise before any collective."""
    mesh = _ShapeMesh(1, 3)
    with pytest.raises(NotImplementedError, match="do not split"):
        unit_ranges(2, 3)
    with pytest.raises(NotImplementedError, match="do not split"):
        kv_heads_of_rank(2, 1, 3, 0)
    cfg = dataclasses.replace(t_smoke("qwen2.5-32b"), dtype=torch.float32,
                              d_ff=2)
    p = {"wi": torch.zeros(64, 2), "wg": torch.zeros(64, 2),
         "wo": torch.zeros(2, 64)}
    with pytest.raises(NotImplementedError, match="do not split"):
        apply_mlp(cfg, p, torch.zeros(1, 8, 64), mesh=mesh)
    mcfg = dataclasses.replace(t_smoke("mamba2-370m"), dtype=torch.float32,
                               d_model=16)          # d_inner 32: 2 heads
    with pytest.raises(NotImplementedError, match="do not split"):
        mamba2_forward(mcfg, {}, torch.zeros(1, 8, 16), mesh=mesh)


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
