"""The two front-end stubs of the reference on the port: hubert-xlarge (an
audio encoder: bidirectional attention, LayerNorm, GELU, no RoPE, a frame
classification loss without the causal shift) and internvl2-26b (a
decoder fed patch embeddings).  Both take precomputed ``embeds`` [B, S, D]
in place of tokens, as the reference's ``tests/test_models.py`` feeds
them; the same numpy weights and embeddings go through both packages
(fp32: 1e-4, the reference's chunked-vs-naive bound)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import from_numpy_tree  # noqa: E402

FRONTENDS = ["hubert-xlarge", "internvl2-26b"]


def _setup(arch, B=2, S=24, seed=0):
    jcfg = dataclasses.replace(j_smoke(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_smoke(arch), dtype=torch.float32)
    jp = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                 jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jb = {"embeds": jnp.asarray(x), "labels": jnp.asarray(labels)}
    tb = {"embeds": torch.as_tensor(x), "labels": torch.as_tensor(labels)}
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), from_numpy_tree(jp), \
        jb, tb


def _err(t, j) -> float:
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_forward_and_loss_match_reference(arch):
    """The reference's ``test_arch_smoke_forward_and_loss`` on the port,
    held to the reference: logits, collected K/V, hidden states and the
    loss from ``embeds``."""
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch)
    assert tcfg.frontend is not None
    jl, jaux, jkv = JT.forward(jcfg, jp, jb, collect_kv=True)
    tl, taux, tkv = TT.forward(tcfg, tp, tb, collect_kv=True)
    assert tuple(tl.shape) == jl.shape and _err(tl, jl) < 1e-4
    assert float(taux) == float(jaux) == 0.0
    for name, (jk, jv) in jkv["units"].items():
        tk, tv = tkv["units"][name]
        assert _err(tk, jk) < 1e-4 and _err(tv, jv) < 1e-4
    jx, _ = JT.hidden_states(jcfg, jp, jb)
    tx, _ = TT.hidden_states(tcfg, tp, tb)
    assert _err(tx, jx) < 1e-4
    jloss, jparts = JT.loss_fn(jcfg, jp, jb)
    tloss, tparts = TT.loss_fn(tcfg, tp, tb)
    assert abs(float(tloss) - float(jloss)) < 1e-4
    assert abs(float(tparts["ce"]) - float(jparts["ce"])) < 1e-4


def test_hubert_frame_loss_has_no_shift():
    """hubert is an encoder: position t is scored against label t (the
    reference's ``loss_fn`` shifts only when ``cfg.causal``), and every
    label counts."""
    _, tcfg, _, tp, _, tb = _setup("hubert-xlarge")
    assert not tcfg.causal
    logits, _ = TT.forward(tcfg, tp, tb)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tb["labels"][..., None].long())[..., 0]
    _, parts = TT.loss_fn(tcfg, tp, tb)
    assert abs(float(parts["ce"]) - float((lse - gold).mean())) < 1e-5


@pytest.mark.parametrize("arch", FRONTENDS)
def test_attention_sees_the_future_only_in_the_encoder(arch):
    """Changing the last frame moves the first position's logits in the
    encoder (hubert: no causal mask, through every attention path) and
    leaves them alone in the decoder (internvl2)."""
    _, tcfg, _, tp, _, tb = _setup(arch)
    late = dict(tb, embeds=tb["embeds"].clone())
    # not a constant shift, which hubert's LayerNorm would remove
    g = torch.Generator().manual_seed(9)
    late["embeds"][:, -1] = torch.randn(late["embeds"][:, -1].shape,
                                        generator=g)
    for impl in ("naive", "chunked", "pallas"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        a, _ = TT.forward(cfg, tp, tb)
        b, _ = TT.forward(cfg, tp, late)
        moved = float((a[:, 0] - b[:, 0]).abs().max())
        if tcfg.causal:
            assert moved == 0.0, impl
        else:
            assert moved > 1e-3, impl
        base = dataclasses.replace(tcfg, attn_impl="naive")
        assert float((a - TT.forward(base, tp, tb)[0]).abs().max()) < 1e-4


@pytest.mark.parametrize("arch", FRONTENDS)
def test_embeds_take_the_config_dtype(arch):
    """fp32 embeddings into a bf16 model are cast to bf16 first, as the
    reference's ``batch["embeds"].astype(cfg.dtype)``: the same logits as
    feeding the bf16 embeddings."""
    _, tcfg, _, tp, _, tb = _setup(arch)
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)

    def cast(tree):               # every stacked or matrix leaf to bf16
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.bfloat16() if tree.dim() >= 2 else tree
    p = cast(tp)
    a, _ = TT.forward(cfg, p, tb)
    b, _ = TT.forward(cfg, p, dict(tb, embeds=tb["embeds"].bfloat16()))
    assert torch.equal(a, b)


def test_encode_run_feeds_frame_embeddings():
    """``profile_forward``'s hubert-xlarge run (the one ``chip_smoke.py``
    times) is fed frame embeddings and frame labels, the granite-moe
    prefill tokens; both at their published widths and whole depth."""
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_forward import RUNS, run_batch, \
        run_config
    for arch, want in (("hubert-xlarge", (8, 2048, 48)),
                       ("granite-moe-3b-a800m", (1, 4096, 32))):
        run = RUNS[arch]
        assert (run.batch, run.seq, run.layers) == want
        cfg = run_config(arch)
        assert cfg == get_config(arch)              # the whole model
        small = dataclasses.replace(run, batch=2, seq=16)
        batch = run_batch(cfg, small, torch.device("cpu"))
        if cfg.frontend:
            assert "tokens" not in batch
            assert batch["embeds"].shape == (2, 16, cfg.d_model)
        else:
            assert batch["tokens"].shape == (2, 16)
        assert batch["labels"].shape == (2, 16)
        assert 0 <= int(batch["labels"].min()) and \
            int(batch["labels"].max()) < cfg.vocab_size
