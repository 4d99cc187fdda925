"""The port's serving engine against the reference engine, step for step
(lazy pages, spans, partial prefix hits).  ``test_torch_twin.Twin`` compares tokens, block
tables, ``kv_pos``, ``AllocState``, prefix records and recovery stats
after every call."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_twin import PAGE, Twin, _prompt  # noqa: E402,F401
from test_torch_twin import jit_reference_recover, models  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("jit_reference_recover")


def test_engine_generate_evict_recover_matches(models):
    tw = Twin(models, lanes=4, max_seq=64)
    l0 = tw("add_request", [5, 9, 3])
    tw("add_request", [7, 7])
    tw.steps(16)
    stats = tw("crash_and_recover")
    assert stats["live_before"] == stats["live_after"] == stats["marked"]
    tw.steps(5)
    tw("finish", l0)
    tw("add_request", [1, 2, 3])
    tw.steps(6)


def test_engine_oversized_prompt_span_matches(models):
    tw = Twin(models, lanes=2, max_seq=256, pages_per_sb=16)
    lane = tw("add_request", _prompt(0, 200))
    assert lane in tw.t.large_spans
    other = tw("add_request", [5, 9, 3])
    tw.steps(20)
    tw("crash_and_recover")
    tw.steps(5)
    tw("finish", lane)
    tw("finish", other)


def test_partial_hit_leases_only_matched_superblocks_matches(models):
    tw = Twin(models, lanes=3, max_seq=64, pages_per_sb=2)
    rng = np.random.default_rng(3)
    prompt = [int(t) for t in rng.integers(1, 128, size=40)]
    a = tw("add_request", prompt, share_prefix=True)
    tw.steps(len(prompt))
    tw("publish_prefix", a)
    p2 = prompt[:16] + [int(t) for t in rng.integers(1, 128, size=20)]
    b = tw("add_request", p2, share_prefix=True)
    assert tw.t.lane_states.partial_hits[b] == 2
    assert len(tw.t.prefix_store.walk()) == 2
    tw.steps(len(p2) - 2 * PAGE + 4)
    assert tw.t.sessions[b].tokens[:len(p2)] == p2
