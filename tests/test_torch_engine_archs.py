"""The port's serving engine against the reference engine, call for call,
on the smoke configurations of granite-20b (MQA, one KV head),
recurrentgemma-9b (RG-LRU + local attention, a tail of RG-LRU layers),
mamba2-370m (attention-free) and granite-moe-3b-a800m (MoE, 8 real and 8
padded experts; ``capacity_factor=100``, as the reference's MoE decode
cases), in fp32 from the same weights.  After every
call ``test_torch_twin.Twin`` compares tokens, block tables, ``kv_pos``,
``AllocState``, prefix records and span records; the recurrent states are
compared too (1e-4).

Two behaviours of the reference are mirrored, not fixed, and pinned here
(ROADMAP C10, C11):
(a) ``reset_lane`` does not zero a lane's recurrent state: a reused lane
    starts from the last sequence's ``h`` and conv history;
(b) an exact prefix hit sets ``pos`` to the prompt's length without
    replaying the prompt, so a hybrid's RG-LRU state lacks the prompt."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models.params import from_numpy_tree  # noqa: E402
from test_torch_twin import PAGE, Twin, _prompt  # noqa: E402
from test_torch_twin import jit_reference_recover  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("jit_reference_recover")
_STATE_KEYS = ("h", "conv", "conv_x", "conv_bc")


def _models(arch, **kw):
    jcfg = dataclasses.replace(get_smoke_config(arch), page_size=PAGE,
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(t_smoke(arch), page_size=PAGE,
                               dtype=torch.float32, **kw)
    params = jax.tree.map(np.asarray, T.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params), \
        from_numpy_tree(params)


@pytest.fixture(scope="module")
def granite():
    return _models("granite_20b")


@pytest.fixture(scope="module")
def hybrid():
    return _models("recurrentgemma_9b")


@pytest.fixture(scope="module")
def ssm():
    return _models("mamba2_370m")


@pytest.fixture(scope="module")
def moe():
    return _models("granite_moe_3b_a800m", capacity_factor=100.0)


def _recurrent(dstate):
    """{path: array} of every recurrent-state leaf (units and tail)."""
    out = {}
    for part in ("units", "tail"):
        for name, st in dstate[part].items():
            for k, v in st.items():
                if k in _STATE_KEYS:
                    out[f"{part}/{name}/{k}"] = np.asarray(
                        v.numpy() if isinstance(v, torch.Tensor) else v)
    return out


def _lane(dstate, lane):
    """The recurrent state of one lane (lanes are the axis after the
    stacked units)."""
    return {k: (v[:, lane] if k.startswith("units") else v[lane]).copy()
            for k, v in _recurrent(dstate).items()}


def _check_states(tw, where):
    j, t = _recurrent(tw.j.dstate), _recurrent(tw.t.dstate)
    assert j.keys() == t.keys(), where
    for k in j:
        assert np.abs(j[k] - t[k]).max() < 1e-4, (where, k)


def test_engine_mqa_matches(granite):
    tw = Twin(granite, lanes=3, max_seq=64, pages_per_sb=2)
    prompt = _prompt(1, 24)
    a = tw("add_request", prompt, share_prefix=True)       # span path
    assert a in tw.t.large_spans
    b = tw("add_request", [5, 9, 3])                        # lazy pages
    tw.steps(len(prompt))
    tw("publish_prefix", a)
    c = tw("add_request", prompt[:16] + _prompt(2, 6), share_prefix=True)
    assert tw.t.lane_states.partial_hits[c] == 2
    tw.steps(8)
    tw("crash_and_recover")
    tw.steps(4)
    tw("finish", b)
    assert tw("add_request", [7, 7, 1]) == b                # lane reuse
    tw.steps(6)
    tw("finish", a)


def test_engine_hybrid_matches_with_reuse_and_exact_hit(hybrid):
    tw = Twin(hybrid, lanes=3, max_seq=64, pages_per_sb=2)
    prompt = _prompt(3, 2 * PAGE)                 # two whole pages
    a = tw("add_request", prompt, share_prefix=True)
    b = tw("add_request", [4, 8, 15, 16])
    tw.steps(len(prompt))
    _check_states(tw, "after the prompt")
    tw("publish_prefix", a)
    assert len(tw.t._prefix_cache) == 1

    # (b): an exact hit on a lane never admitted before: pos jumps to the
    # prompt's length and the lane's recurrent state stays what its idle
    # steps left there: the prompt is not replayed into it
    lane = tw.t.free_lanes[-1]
    before = _lane(tw.t.dstate, lane)
    c = tw("add_request", prompt, share_prefix=True)
    assert c == lane and c in tw.t.sessions
    assert int(tw.t.dstate["pos"][c]) == len(prompt)
    after = _lane(tw.t.dstate, c)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    tw.steps(6)
    _check_states(tw, "after the exact hit")

    tw("crash_and_recover")
    tw.steps(3)

    # (a): lane reuse keeps the last sequence's recurrent state
    tw("finish", b)
    held = _lane(tw.t.dstate, b)
    assert any(v.any() for v in held.values())
    assert tw("add_request", [2, 3]) == b
    now = _lane(tw.t.dstate, b)
    for k in held:
        np.testing.assert_array_equal(now[k], held[k], err_msg=k)
    assert int(tw.t.dstate["pos"][b]) == 0
    tw.steps(5)
    _check_states(tw, "after the reuse")


def test_engine_attention_free_matches_with_reuse(ssm):
    tw = Twin(ssm, lanes=2, max_seq=64, pages_per_sb=2)
    a = tw("add_request", _prompt(4, 10))
    b = tw("add_request", [6, 1])
    tw.steps(12)
    tw("crash_and_recover")
    tw.steps(3)
    tw("finish", a)
    held = _lane(tw.t.dstate, a)
    assert tw("add_request", [9, 9, 9]) == a                # (a)
    now = _lane(tw.t.dstate, a)
    for k in held:
        np.testing.assert_array_equal(now[k], held[k], err_msg=k)
    tw.steps(5)
    _check_states(tw, "after the reuse")
    tw("finish", b)


def test_engine_moe_matches_with_crash_and_reuse(moe):
    """The MoE decode (every expert over the lanes, gates masking the
    combine) through every engine path: span prompt, lazy pages, publish,
    exact and partial hits, a crash and recovery, a reused lane."""
    tw = Twin(moe, lanes=3, max_seq=64, pages_per_sb=2)
    prompt = _prompt(5, 20)
    a = tw("add_request", prompt, share_prefix=True)        # span path
    assert a in tw.t.large_spans
    b = tw("add_request", [3, 1, 4])                        # lazy pages
    tw.steps(len(prompt))
    tw("publish_prefix", a)
    c = tw("add_request", prompt, share_prefix=True)        # exact hit
    assert c in tw.t.shared_spans
    tw.steps(5)
    tw("finish", c)
    c = tw("add_request", prompt[:PAGE] + _prompt(6, 5), share_prefix=True)
    assert tw.t.lane_states.partial_hits[c] == 1            # partial hit
    tw.steps(6)
    tw("crash_and_recover")
    tw.steps(4)
    tw("finish", b)
    assert tw("add_request", [2, 7, 1, 8]) == b             # lane reuse
    tw.steps(6)
    tw("finish", a)
