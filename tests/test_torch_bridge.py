"""The port's weight bridge, seeded init, hash helpers and metrics copy
against the reference."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core.prefix_index import hash_tokens as j_hash  # noqa: E402
from repro.core.prefix_trie import fingerprint as j_fp  # noqa: E402
from repro.core.prefix_trie import page_hashes as j_ph  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import prefix_hash as ph  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402

_DT = {"bf16": (jnp.bfloat16, torch.bfloat16),
       "fp32": (jnp.float32, torch.float32)}
_TORCH_OF = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("dt", ["bf16", "fp32"])
def test_params_round_trip_bit_exact(dt):
    jdt, tdt = _DT[dt]
    cfg = dataclasses.replace(get_smoke_config("qwen2_5_32b"), dtype=jdt)
    jp = jax.tree.map(np.asarray, T.init_params(cfg, jax.random.PRNGKey(3)))
    jl, tl = _leaves(jp), _leaves(tparams.from_numpy_tree(jp))
    assert jl.keys() == tl.keys()
    for k, a in jl.items():
        assert tl[k].dtype == _TORCH_OF[a.dtype.name], k
        if a.dtype.name == "bfloat16":     # compare the bits
            a, t = a.view(np.uint16), tl[k].view(torch.uint16)
        else:
            t = tl[k]
        np.testing.assert_array_equal(t.numpy(), a, err_msg=k)


@pytest.mark.parametrize("dt", ["bf16", "fp32"])
def test_init_params_same_tree_shapes_dtypes(dt):
    jdt, tdt = _DT[dt]
    jcfg = dataclasses.replace(get_smoke_config("qwen2_5_32b"), dtype=jdt)
    tcfg = dataclasses.replace(t_smoke("qwen2_5_32b"), dtype=tdt)
    jl = _leaves(jax.eval_shape(lambda: T.init_params(
        jcfg, jax.random.PRNGKey(0))))
    gen = torch.Generator().manual_seed(0)
    tl = _leaves(tparams.init_params(tcfg, gen, device="cpu"))
    assert jl.keys() == tl.keys()
    for k, a in jl.items():
        assert tuple(a.shape) == tuple(tl[k].shape), k
        assert tl[k].dtype == _TORCH_OF[np.dtype(a.dtype).name], k
    # the scale rule: normal x fan_in^-0.5, embeddings d^-0.5, norms 1,
    # biases 0
    d = tcfg.d_model
    p = tparams.init_params(tcfg, torch.Generator().manual_seed(1),
                            device="cpu")
    wq = p["units"]["l0"]["attn"]["wq"].float()
    assert abs(float(wq.std()) - d ** -0.5) < 0.2 * d ** -0.5
    emb = p["embed"].float()
    assert abs(float(emb.std()) - d ** -0.5) < 0.2 * d ** -0.5
    assert bool((p["units"]["l0"]["norm1"]["w"] == 1).all())
    assert bool((p["units"]["l0"]["attn"]["bq"] == 0).all())


def test_init_params_is_seeded():
    cfg = t_smoke("qwen2_5_32b")
    a, b = (tparams.init_params(cfg, torch.Generator().manual_seed(7),
                                device="cpu") for _ in range(2))
    for k, v in _leaves(a).items():
        assert torch.equal(v, _leaves(b)[k]), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_helpers_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(0, 70))
        toks = [int(t) for t in rng.integers(-5, 2**40, size=n)]
        page = int(rng.integers(1, 9))
        assert ph.hash_tokens(toks) == j_hash(toks)
        assert ph.page_hashes(toks, page) == j_ph(toks, page)
        a, b = (int(x) for x in rng.integers(-2**40, 2**40, size=2))
        assert ph.fingerprint(a, b) == j_fp(a, b)


def test_obs_registry_matches_reference():
    """The same metric traffic through both registries snapshots alike
    (span timings aside)."""
    snaps = []
    for mod in (jobs, tobs):
        reg = mod.Registry(enabled=True)
        c = reg.counter("device.alloc_calls")
        g = reg.gauge("engine.publish_queue_depth")
        h = reg.histogram("engine.publish_batch_size")
        for i in range(5):
            c.inc()
            g.set(i)
            h.observe(i % 3)
        with reg.span("engine_recovery.mark_sweep") as sp:
            sp.add(4)
        snap = reg.snapshot()
        for row in snap["phases"].values():
            row.pop("seconds")
        snaps.append(snap)
    assert snaps[0] == snaps[1]
