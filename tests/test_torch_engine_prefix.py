"""The port's serving engine against the reference engine, step for step
(published span prefixes across crashes).  ``test_torch_twin.Twin`` compares tokens, block
tables, ``kv_pos``, ``AllocState``, prefix records and recovery stats
after every call."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_twin import PAGE, Twin, _prompt  # noqa: E402,F401
from test_torch_twin import jit_reference_recover, models  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("jit_reference_recover")


def test_engine_span_prefix_sharing_matches(models):
    tw = Twin(models, lanes=3, max_seq=64, pages_per_sb=4)
    prompt = _prompt(3, 40)
    a = tw("add_request", prompt, share_prefix=True)
    tw.steps(len(prompt))
    tw("publish_prefix", a)
    tw("publish_prefix", a)
    b = tw("add_request", prompt, share_prefix=True)
    assert b in tw.t.shared_spans
    tw.steps(10)
    assert tw("crash_and_recover")["index_records"] == 1
    tw.steps(3)
    tw("publish_prefix", b)
    tw("drop_prefix_cache")
    tw("publish_prefix", b)
    tw("drop_prefix_cache")
    tw("finish", a)
    tw("finish", b)


def test_engine_prefix_index_survives_crash_matches(models):
    tw = Twin(models, lanes=4, max_seq=64, pages_per_sb=2)
    prompt = _prompt(11, 24)
    a = tw("add_request", prompt, share_prefix=True)
    tw.steps(len(prompt))
    tw("publish_prefix", a)
    b = tw("add_request", prompt, share_prefix=True)
    c = tw("add_request", prompt)
    tw.steps(len(prompt) + 4)
    assert tw("crash_and_recover")["index_records"] == 1
    d = tw("add_request", prompt, share_prefix=True)
    assert d in tw.t.shared_spans
    tw.steps(4)
    tw("finish", a)
    tw("crash_and_recover")
    for lane in (b, c, d):
        tw("finish", lane)
    tw("drop_prefix_cache")
    assert tw.t.prefix_store.walk() == []
