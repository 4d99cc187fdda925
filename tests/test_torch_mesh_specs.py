"""The port's sharding specs against the reference's ``PartitionSpec``s,
and ``shard_tree`` / ``gather_tree`` on gloo ranks.

- ``serve_param_specs`` and ``dstate_specs`` of all ten archs at TP 1, 2,
  4 and 16, batch-sharded and sequence-parallel, on (data, model) and
  (pod, data, model) meshes, equal to the reference's (a spec as a tuple;
  JAX writes a one-axis tuple as the axis name, so both sides are read
  that way), over the reference's abstract parameter shapes.
- The counterpart of ``tests/test_baselines_and_sharding.py::
  test_serve_specs_vocab_fallback``: internvl2-26b's 92553-row tables are
  replicated at TP 16, qwen2.5-32b's split over ``model``.
- ``gather_tree(shard_tree(x))`` is ``x`` on every rank of a (2, 2) mesh
  for qwen2.5-32b's smoke weights and a sequence-parallel decode state;
  on the same ranks the vocab-parallel embedding and greedy token (a tie
  across shards) equal one device's, and ``pmax`` over both axes;
  ``make_mesh`` refuses a mesh larger than the process group.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS, get_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.serving import decode as jdec  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.distributed import specs as tspecs  # noqa: E402
from repro_torch.distributed.mesh import make_mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402

MESHES = [("data", "model"), ("pod", "data", "model")]


def _norm(spec):
    out = []
    for e in spec:
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(None if e == () else e)
    return tuple(out)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _compare(jtree, ttree):
    j, t = _flat(jtree), _flat(ttree)
    assert j.keys() == t.keys()
    for k in j:
        assert _norm(tuple(j[k])) == _norm(t[k]), (k, j[k], t[k])


@pytest.fixture(scope="module")
def shapes():
    return {a: jax.eval_shape(lambda a=a: jspecs.abstract_params(
        get_config(a))) for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, shapes):
    for tp in (1, 2, 4, 16):
        _compare(jdec.serve_param_specs(get_config(arch), shapes[arch], tp),
                 tspecs.serve_param_specs(t_get(arch), shapes[arch], tp))
    for names in MESHES:
        jmesh = types.SimpleNamespace(axis_names=names)
        tmesh = types.SimpleNamespace(mesh_dim_names=names)
        for kv in ("bf16", "int8"):
            jcfg, tcfg = get_config(arch), t_get(arch)
            if kv == "int8":
                jcfg = dataclasses.replace(jcfg, kv_dtype="int8")
                tcfg = dataclasses.replace(tcfg, kv_dtype="int8")
            for bs in (True, False):
                _compare(jdec.dstate_specs(jcfg, jmesh, bs),
                         tspecs.dstate_specs(tcfg, tmesh, bs))


def test_serve_specs_vocab_fallback(shapes):
    sp = tspecs.serve_param_specs(t_get("internvl2_26b"),
                                  shapes["internvl2_26b"], tp=16)
    assert sp["embed"] == (None, None)          # 92553 % 16 != 0
    sp2 = tspecs.serve_param_specs(t_get("qwen2_5_32b"),
                                   shapes["qwen2_5_32b"], tp=16)
    assert sp2["embed"] == ("model", None)


def _roundtrip_rank(rank, world, job):
    from repro_torch.models.params import init_params
    from repro_torch.serving.decode import make_dstate
    cfg = job["cfg"]
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    ds = make_dstate(cfg, batch=4, max_seq=512, dp_shards=2, device="cpu")
    g = torch.Generator().manual_seed(1)
    for st in ds["units"].values():
        for k, v in st.items():
            v.copy_(torch.randn(v.shape, generator=g).to(v.dtype))
    ds["kv_pos"].copy_(torch.randint(-1, 99, ds["kv_pos"].shape,
                                     generator=g))
    ok = []
    for tree, specs in ((params, tspecs.serve_param_specs(cfg, params, 2)),
                        (ds, tspecs.dstate_specs(cfg, mesh, True)),
                        (ds, tspecs.dstate_specs(cfg, mesh, False))):
        loc = tspecs.shard_tree(tree, specs, mesh)
        back = tspecs.gather_tree(loc, specs, mesh)
        ok.append(all(torch.equal(a, b) for a, b in zip(
            _flat(tree).values(), _flat(back).values())))
        # the blocks are the rank's share of the global leaf
        ok.append(sum(t.numel() for t in _flat(loc).values())
                  < sum(t.numel() for t in _flat(tree).values()))
    # the vocab-parallel forms against one device's: the embedding, and
    # the greedy token with ties across shards (the first index wins)
    from repro_torch.distributed.mesh import pmax
    from repro_torch.serving import tp_layers as tpl
    table = params["embed"]
    tok = torch.tensor([0, 63, 64, 127, 5])
    rows = tpl.embed_tp(tspecs.local_block(table, ("model", None), mesh),
                        tok, mesh)
    ok.append(torch.equal(rows, table[tok]))
    logits = torch.randn(5, 128, generator=g)
    logits[1, 3] = logits[1, 70] = logits[1].max() + 1    # a tie, 2 shards
    loc = tspecs.local_block(logits, (None, "model"), mesh)
    ok.append(torch.equal(tpl.greedy_sample_tp(loc, mesh),
                          torch.argmax(logits, 1).to(torch.int32)))
    x = torch.full((3,), float(rank))
    ok.append(torch.equal(pmax(x, mesh, ("data", "model")),
                          torch.full((3,), 3.0)))
    return ok


def test_shard_then_gather_is_the_identity():
    res = run_ranks(_roundtrip_rank, 4, {"cfg": t_smoke("qwen2.5-32b")},
                    device="cpu")
    assert all(all(r) for r in res), res


def test_a_mesh_needs_its_ranks():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs torch.distributed"):
        make_mesh((2, 2), ("data", "model"), "cpu")
