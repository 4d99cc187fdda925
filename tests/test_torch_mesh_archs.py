"""The port's sharded decode step on gloo ranks (CPU, fp32) against the
reference's ``make_decode_step`` on one device, beyond the dense model:

- recurrentgemma-9b's smoke config (page 4, window 8, vocab 128, as
  ``tests/test_multidevice.py``'s sequence-parallel case) at batch 1 on a
  (2, 2) mesh, sequence-parallel: its table's columns split over the data
  axis, the RG-LRU state replicated, the attention merged over both axes.
  10 steps, past the window; logits within 1e-4 of the reference's and
  1e-3 of ``T.forward``.
- granite-moe-3b-a800m (experts, padded, over ``model``; a vocabulary of
  129, which does not split over 2 shards, so the tables are replicated
  as the published 49155 are) and mamba2-370m (SSD heads over ``model``,
  the gated norm's sum of squares psum'd) on (1, 2): logits within 1e-4,
  identical tokens, the recurrent states.
- qwen2.5-32b with the int8 KV cache on (1, 2): logits within 1e-3."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import transformer as T  # noqa: E402
from torch_mesh_common import assert_arenas_match, configs, port_decode, \
    reference_decode, weights  # noqa: E402


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def test_sequence_parallel_hybrid_matches_reference_and_forward():
    jcfg, tcfg = configs("recurrentgemma_9b", vocab_size=128, page_size=4,
                         window=8)
    params = weights(jcfg, seed=2)
    toks = np.random.default_rng(3).integers(0, 128, (1, 10)).astype(
        np.int32)
    jl, jt, jst, jbt = reference_decode(jcfg, params, toks, dp=2,
                                        batch_sharded=False, max_seq=16)
    res = port_decode(tcfg, params, toks, mesh=(2, 2), batch_sharded=False,
                      max_seq=16)
    assert _rel(res["logits"], jl) < 1e-4
    full, _ = T.forward(jcfg, jax_tree(params), {"tokens": jnp.asarray(toks)})
    full = np.asarray(full, np.float32).transpose(1, 0, 2)
    assert _rel(res["logits"], full) < 1e-3
    np.testing.assert_array_equal(res["tokens"], jt)
    st = res["state"]
    np.testing.assert_array_equal(st["kv_pos"], jst["kv_pos"])
    assert_arenas_match(jst, st, jbt, 2, False, 1e-4)
    for k in ("h", "conv"):
        for name, s in st["units"].items():
            if k in s:
                assert _rel(s[k], jst["units"][name][k]) < 1e-4, (name, k)


def jax_tree(params):
    import jax
    return jax.tree.map(jnp.asarray, params)


@pytest.mark.parametrize("arch,over,tol", [
    ("granite_moe_3b_a800m", {"capacity_factor": 100.0, "vocab_size": 129},
     1e-4),
    ("mamba2_370m", {"vocab_size": 128}, 1e-4),
    ("qwen2_5_32b", {"kv_dtype": "int8", "vocab_size": 128}, 1e-3),
])
def test_sharded_archs_match_reference(arch, over, tol):
    jcfg, tcfg = configs(arch, **over)
    params = weights(jcfg, seed=4)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             (2, 8)).astype(np.int32)
    jl, jt, jst, jbt = reference_decode(jcfg, params, toks, dp=1,
                                        batch_sharded=True, max_seq=32)
    res = port_decode(tcfg, params, toks, mesh=(1, 2), batch_sharded=True,
                      max_seq=32)
    assert _rel(res["logits"], jl) < tol
    st = res["state"]
    np.testing.assert_array_equal(st["pos"], jst["pos"])
    np.testing.assert_array_equal(st["kv_pos"], jst["kv_pos"])
    if tol == 1e-4:
        np.testing.assert_array_equal(res["tokens"], jt)
    if jcfg.attn_layers and jcfg.kv_dtype != "int8":
        assert_arenas_match(jst, st, jbt, 1, True, 1e-4)
    for name, s in st["units"].items():
        for k in ("h", "conv_x", "conv_bc"):
            if k in s:
                assert _rel(s[k], jst["units"][name][k]) < 1e-4, (name, k)
