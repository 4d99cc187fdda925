"""The port's MoE feed-forward (``layers/moe.py``, ``moe_decode_tp``)
against the reference's ``layers/moe.py`` and ``serving/tp_layers.py``, in
fp32, from the same numpy weights and inputs: the output within 1e-5 (of
the largest output, where that exceeds 1), the load-balancing loss within
1e-6, and the same keep mask -- the same (token, choice) assignments
dropped past the capacity.  The reference's
keep mask is read from its own traced program: the ``ranks < cap``
comparison, the one ``lt`` against the literal capacity."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro.runtime import make_host_mesh, shard_map  # noqa: E402
from repro.serving import tp_layers as jtp  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.layers import moe as tmoe  # noqa: E402
from repro_torch.models.params import from_numpy_tree  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving import tp_layers as ttp  # noqa: E402


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_smoke(arch), dtype=jnp.float32, **kw),
            dataclasses.replace(t_smoke(arch), dtype=torch.float32, **kw))


def _params(jcfg, seed=0):
    p = jax.tree.map(np.asarray,
                     jmoe.init_moe(jcfg, jax.random.PRNGKey(seed)))
    return jax.tree.map(jnp.asarray, p), from_numpy_tree(p)


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.as_tensor(x)


def _err(t, j) -> float:
    """Largest difference over max(1, largest |reference|): 1e-5 of it is
    1e-5 where the outputs stay within 1, and fp32's own rounding where
    they do not (the smoke experts, scaled by (E + pad)^-0.5, give
    |y| ~ 50 at E 8, where the reference itself is 3e-5 from the float64
    result)."""
    j = np.asarray(j, np.float32)
    return float(np.abs(t.numpy() - j).max()) / max(
        1.0, float(np.abs(j).max()))


def reference_keep(fn, x, cap: int) -> np.ndarray:
    """Run the reference's ``fn(x)`` equation by equation and return the
    value of its ``ranks < cap`` comparison: the one ``lt`` whose second
    operand is the literal ``cap`` (every other ``lt`` in the MoE compares
    against 0)."""
    closed = jax.make_jaxpr(fn)(x)
    env = dict(zip(closed.jaxpr.constvars, closed.consts))
    env.update(zip(closed.jaxpr.invars, [x]))

    def read(v):
        return v.val if type(v).__name__ == "Literal" else env[v]

    kept = []
    for e in closed.jaxpr.eqns:
        out = e.primitive.bind(*[read(v) for v in e.invars], **e.params)
        outs = out if e.primitive.multiple_results else [out]
        env.update(zip(e.outvars, outs))
        rhs = e.invars[1] if len(e.invars) > 1 else None
        if e.primitive.name == "lt" and type(rhs).__name__ == "Literal" \
                and int(rhs.val) == cap:
            kept.append(np.asarray(outs[0]))
    assert len(kept) == 1, len(kept)
    return kept[0]


@pytest.mark.parametrize("cf", [1.25, 0.3, 100.0])
@pytest.mark.parametrize("dispatch", ["local", "global"])
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "moonshot_v1_16b_a3b"])
def test_moe_matches_reference(arch, dispatch, cf):
    """y within 1e-5, aux within 1e-6 and the same keep mask, per-row and
    global dispatch, at the configs' capacity factor, one that drops
    (0.3) and one that never does (100)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=1)
    B, S = 3, 16
    jx, tx = _x((B, S, jcfg.d_model), seed=2)
    jfn = {"local": jmoe.apply_moe_local,
           "global": jmoe.apply_moe_global}[dispatch]
    tfn = {"local": tmoe.apply_moe_local,
           "global": tmoe.apply_moe_global}[dispatch]
    jy, jaux = jfn(jcfg, jp, jx, capacity_factor=cf)
    ty, taux = tfn(tcfg, tp, tx, capacity_factor=cf)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == jy.shape
    assert _err(ty, jy) < 1e-5
    assert abs(float(taux) - float(jaux)) < 1e-6

    E, K = tcfg.num_experts, tcfg.top_k
    rows, n = (B, S * K) if dispatch == "local" else (1, B * S * K)
    cap = tmoe.capacity(cf, n, E)
    _, expert, _ = tmoe.route(tcfg, tp, tx)
    keep, _ = tmoe.dispatch(expert.reshape(rows, n), E, cap)
    want = reference_keep(lambda x: jfn(jcfg, jp, x, capacity_factor=cf),
                          jx, cap)
    np.testing.assert_array_equal(keep.numpy().reshape(want.shape), want)
    if cf == 0.3:
        assert not bool(keep.all())                 # some tokens drop
    if cf == 100.0:
        assert bool(keep.all())


def test_moe_local_dispatch_matches_global():
    """The reference's ``test_perf_features.py::
    test_moe_local_dispatch_matches_global`` on the port: with no token
    dropped, the per-row dispatch equals the global one."""
    _, tcfg = _cfgs("granite_moe_3b_a800m")
    tp = init_params(dataclasses.replace(tcfg, num_layers=1),
                     torch.Generator().manual_seed(0),
                     device="cpu")["units"]["l0"]["ffn"]
    tp = {k: v[0] for k, v in tp.items()}
    x = torch.randn((3, 16, tcfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    yg, ag = tmoe.apply_moe_global(tcfg, tp, x, capacity_factor=100.0)
    yl, al = tmoe.apply_moe_local(tcfg, tp, x, capacity_factor=100.0)
    assert float((yg - yl).abs().max()) < 1e-5
    assert abs(float(ag - al)) < 1e-6


def test_moe_local_dispatch_drops_per_row():
    """The reference's ``::test_moe_local_dispatch_drops_per_row`` on the
    port, held to the reference: with 4 experts, top-1 and capacity 0.3
    the per-row capacity is 1, each row keeps exactly its first token per
    chosen expert, and y and aux match the reference's."""
    jcfg, tcfg = _cfgs("granite_moe_3b_a800m", num_experts=4, top_k=1,
                       expert_pad=0)
    jp, tp = _params(jcfg, seed=0)
    jx, tx = _x((2, 8, jcfg.d_model), seed=2)
    jy, jaux = jmoe.apply_moe_local(jcfg, jp, jx, capacity_factor=0.3)
    ty, taux = tmoe.apply_moe_local(tcfg, tp, tx, capacity_factor=0.3)
    assert bool(torch.isfinite(ty).all())
    assert _err(ty, jy) < 1e-5 and abs(float(taux) - float(jaux)) < 1e-6
    cap = tmoe.capacity(0.3, 8, 4)
    assert cap == 1
    _, expert, _ = tmoe.route(tcfg, tp, tx)
    flat = expert.reshape(2, 8)
    keep, slot = tmoe.dispatch(flat, 4, cap)
    for r in range(2):
        first = {}
        for n, e in enumerate(flat[r].tolist()):
            first.setdefault(e, n)
        want = [first[e] == n for n, e in enumerate(flat[r].tolist())]
        assert keep[r].tolist() == want
        # a dropped token lands on the dump slot and contributes nothing
        assert (slot[r][~keep[r]] == 4 * cap).all()
        assert bool((ty[r][~keep[r]] == 0).all())


def _decode_tp(cfg, p, x):
    """The reference's ``moe_decode_tp`` at TP = 1, inside shard_map."""
    f = shard_map(lambda p_, x_: jtp.moe_decode_tp(cfg, p_, x_, "model"),
                  mesh=make_host_mesh(), in_specs=(P(), P()), out_specs=P())
    return jax.jit(f)(p, x)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "moonshot_v1_16b_a3b"])
def test_moe_decode_tp_matches_reference(arch, mlp):
    """One token a lane through every expert (the padded ones too), the
    gates masking the combine: within 1e-5 of the reference."""
    jcfg, tcfg = _cfgs(arch, mlp=mlp)
    jp, tp = _params(jcfg, seed=3)
    assert tp["wi"].shape[0] == tcfg.num_experts + tcfg.expert_pad
    jx, tx = _x((5, jcfg.d_model), seed=4)
    want = _decode_tp(jcfg, jp, jx)
    got = ttp.moe_decode_tp(tcfg, tp, tx)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _err(got, want) < 1e-5


def test_moe_decode_tp_makes_no_host_sync():
    """The decode half reads nothing back to the host, so a decode step
    can be captured: no ``.item()``, no ``nonzero``, no boolean-mask
    indexing -- checked by running it under the meta device, where any
    of those raises."""
    _, tcfg = _cfgs("granite_moe_3b_a800m")
    E, d, f = tcfg.num_experts + tcfg.expert_pad, tcfg.d_model, tcfg.d_ff
    p = {"router": torch.empty((d, tcfg.num_experts), device="meta"),
         "wi": torch.empty((E, d, f), device="meta"),
         "wg": torch.empty((E, d, f), device="meta"),
         "wo": torch.empty((E, f, d), device="meta")}
    y = ttp.moe_decode_tp(tcfg, p, torch.empty((4, d), device="meta"))
    assert y.shape == (4, d) and y.device.type == "meta"
