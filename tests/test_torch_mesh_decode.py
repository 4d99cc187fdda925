"""The port's sharded decode step (``serving/decode.py``
``make_decode_step`` on a ``torch.distributed`` mesh of gloo ranks, on the
CPU) against the reference's ``make_decode_step`` on one device: the
port's counterpart of ``tests/test_multidevice.py``'s decode parity.

The qwen2.5-32b smoke config (vocab 128, as that test; fp32), 4 lanes, 12
steps, on a (2, 2) and a (1, 2) mesh at its page of 128 -- where the 12
positions all lie on model shard 0, so the other shards attend over no
slot and the merge must give them weight 0 -- and at page 8 on (2, 2)
and (1, 4), where the positions cross pages and every model shard's
slots (2 a page at TP 4).  Each data shard's lanes use its own arena with
shard-local page ids.  Logits within 1e-4 of the largest, identical
greedy tokens; after gathering, ``pos`` and ``kv_pos`` equal and every
lane's K/V pages within 1e-4 of the arenas' largest value."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_mesh_common import assert_arenas_match, configs, port_decode, \
    reference_decode, weights  # noqa: E402

B, S, MAX_SEQ = 4, 12, 32


@pytest.mark.parametrize("mesh,page", [((2, 2), 128), ((1, 2), 128),
                                       ((2, 2), 8), ((1, 4), 8)])
def test_sharded_decode_matches_reference(mesh, page):
    jcfg, tcfg = configs("qwen2_5_32b", vocab_size=128, page_size=page)
    params = weights(jcfg, seed=0)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    dp = mesh[0]
    jl, jt, jst, jbt = reference_decode(jcfg, params, toks, dp=dp,
                                        batch_sharded=True, max_seq=MAX_SEQ)
    res = port_decode(tcfg, params, toks, mesh=mesh, batch_sharded=True,
                      max_seq=MAX_SEQ)
    err = np.abs(res["logits"] - jl).max() / (np.abs(jl).max() + 1e-9)
    assert err < 1e-4, err
    np.testing.assert_array_equal(res["tokens"], jt)
    st = res["state"]
    np.testing.assert_array_equal(st["pos"], jst["pos"])
    np.testing.assert_array_equal(st["kv_pos"], jst["kv_pos"])
    assert_arenas_match(jst, st, jbt, dp, True, 1e-4)
    # the launch counts: no kernel on the CPU
    assert all(v == 0 for v in res["launches"].values())


@pytest.mark.parametrize("arch,mesh,seq", [
    ("qwen2_5_32b", (2, 2), False), ("recurrentgemma_9b", (2, 2), True)])
def test_mesh_goes_on_from_a_one_device_state(arch, mesh, seq, tmp_path):
    """A state decoded on one device, laid out for the mesh
    (``to_mesh_layout``: its pages moved to the shard-local tables) and
    sharded, decodes on as the one-device step does (fp32, 1e-4; the
    tokens equal): how ``chip_smoke.py`` starts its mesh runs past a
    page or a window."""
    from repro_torch.launch.mesh_decode import decode_rank, to_mesh_layout
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.serving.decode import decode_step, make_dstate
    over = dict(vocab_size=128, page_size=4)
    if seq:
        over["window"] = 8
    jcfg, tcfg = configs(arch, **over)
    params = weights(jcfg, seed=6)
    tparams = from_numpy_tree(params)
    b = 1 if seq else 4
    # 12 steps: the windowed table (3 pages of 4 on one device, 4 on the
    # mesh) holds every position, and the window of 8 is crossed
    toks = np.random.default_rng(7).integers(0, 128, (b, 12)).astype(
        np.int32)
    ds = make_dstate(tcfg, batch=b, max_seq=MAX_SEQ, device="cpu")
    Pn = ds["block_table"].shape[1]
    ds["block_table"] = torch.arange(b * Pn, dtype=torch.int32).reshape(
        b, Pn)
    logits = []
    for t in range(12):
        if t == 6:
            path = tmp_path / "state.pt"
            torch.save(to_mesh_layout(tcfg, ds, max_seq=MAX_SEQ,
                                      dp=mesh[0], batch_sharded=not seq),
                       path)
        ds, _, lg = decode_step(tcfg, tparams, ds, torch.as_tensor(
            toks[:, t]), return_logits=True)
        logits.append(lg.numpy())
    want = np.stack(logits[6:])
    res = run_ranks(decode_rank, 4, {
        "cfg": tcfg, "mesh": (mesh, ("data", "model")), "device": "cpu",
        "batch_sharded": not seq, "params": params, "max_seq": MAX_SEQ,
        "tokens": toks[:, 6:], "state_file": str(path)}, device="cpu")[0]
    err = np.abs(res["logits"] - want).max() / (np.abs(want).max() + 1e-9)
    assert err < 1e-4, err
    np.testing.assert_array_equal(res["tokens"], want.argmax(-1))
