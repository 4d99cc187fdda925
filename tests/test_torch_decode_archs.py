"""The port's decode step against the reference's ``make_decode_step`` (one
host device) and against the full-sequence ``T.forward``, on the smoke
configurations of the dense, MoE, Mamba-2 and RG-LRU hybrid families:
the reference's ``test_serving.py::test_decode_matches_oracle`` cases,
held on the port.

bf16 (granite-20b, starcoder2-3b, nemotron-4-340b, mamba2-370m): logits
within 3e-2 of the largest logit, against ``T.forward`` and against the
reference's step (the reference's bound; bf16 rounds at other places in
the two frameworks, ROADMAP C4).  fp32 (all five, recurrentgemma-9b the
reference's own fp32 case): logits within 1e-3, identical greedy tokens
at every step, and the recurrent states within 1e-4 at the end.  The MoE
archs (granite-moe-3b-a800m, moonshot-v1-16b-a3b) run in fp32 with
``capacity_factor=100``, as the reference's own cases do: top-k routing
is discrete, and the full-sequence oracle must drop no token (the decode
step has no capacity)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.runtime import make_host_mesh  # noqa: E402
from repro.serving import decode as dec  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models.params import from_numpy_tree  # noqa: E402
from repro_torch.serving import decode as tdec  # noqa: E402

_DT = {"fp32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 24


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch,dt", [
    ("granite_20b", "bf16"), ("starcoder2_3b", "bf16"),
    ("nemotron_4_340b", "bf16"), ("mamba2_370m", "bf16"),
    ("granite_20b", "fp32"), ("starcoder2_3b", "fp32"),
    ("nemotron_4_340b", "fp32"), ("mamba2_370m", "fp32"),
    ("recurrentgemma_9b", "fp32"),
    ("granite_moe_3b_a800m", "fp32"), ("moonshot_v1_16b_a3b", "fp32"),
])
def test_decode_matches_reference(arch, dt):
    jdt, tdt = _DT[dt]
    moe = get_smoke_config(arch).family == "moe"
    kw = {"capacity_factor": 100.0} if moe else {}
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=jdt, **kw)
    tcfg = dataclasses.replace(t_smoke(arch), dtype=tdt, **kw)
    params = jax.tree.map(np.asarray, T.init_params(jcfg,
                                                    jax.random.PRNGKey(1)))
    rng = np.random.default_rng(5)
    if jcfg.qkv_bias:                     # init zeroes them; use them
        attn = params["units"]["l0"]["attn"]
        for b in ("bq", "bk", "bv"):
            attn[b] = (0.5 * rng.standard_normal(attn[b].shape)).astype(
                attn[b].dtype)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = from_numpy_tree(params)

    step, _, _ = dec.make_decode_step(
        jcfg, make_host_mesh(), jax.eval_shape(lambda: jparams),
        return_logits=True)
    ds = dec.make_dstate(jcfg, batch=B, max_seq=64, dp_shards=1)
    ts = tdec.make_dstate(tcfg, batch=B, max_seq=64, device="cpu")
    assert _leaves(ts).keys() == _leaves(ds).keys()
    for k, a in _leaves(ds).items():
        assert tuple(_leaves(ts)[k].shape) == tuple(a.shape), k
    Pn = ds["block_table"].shape[1]
    bt = np.arange(B * Pn, dtype=np.int32).reshape(B, Pn)
    ds["block_table"] = jnp.asarray(bt)
    ts["block_table"] = torch.as_tensor(bt)

    full, _ = T.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    full = np.asarray(full, np.float32)
    scale = float(np.abs(full).max()) + 1e-9
    for t in range(S):
        ds, jtok, jlg = step(jparams, ds, jnp.asarray(toks[:, t]))
        ts, ttok, tlg = tdec.decode_step(tcfg, tparams, ts,
                                         torch.as_tensor(toks[:, t]),
                                         return_logits=True)
        jlg = np.asarray(jlg, np.float32)
        tlg = tlg.numpy()
        if dt == "fp32":
            assert np.abs(jlg - tlg).max() < 1e-3, t
            np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
            assert np.abs(tlg - full[:, t]).max() / scale < 1e-3, t
        else:
            assert np.abs(jlg - tlg).max() / scale < 3e-2, t
            assert np.abs(tlg - full[:, t]).max() / scale < 3e-2, t
    np.testing.assert_array_equal(np.asarray(ds["pos"]), ts["pos"].numpy())
    np.testing.assert_array_equal(np.asarray(ds["kv_pos"]),
                                  ts["kv_pos"].numpy())
    if dt == "fp32":
        # the recurrent states (h, conv histories) after S steps
        for k, a in _leaves(ds).items():
            if k.split("/")[-1] in ("h", "conv", "conv_x", "conv_bc"):
                got = _leaves(ts)[k].numpy()
                assert np.abs(got - np.asarray(a)).max() < 1e-4, k
