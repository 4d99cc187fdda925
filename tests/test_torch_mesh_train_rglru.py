"""The RG-LRU mixer's TP form in the sharded train step, against the
reference's one-device ``jax.jit(make_train_step)`` (the bounds of
``tests/test_torch_train.py``, gradient leaf by leaf).

A rank computes its channels of the width by the plan (``unit_ranges``):
in_x / in_g their columns, the convolution, lam and the scan on them, the
convolved input gathered over ``model`` for wa / wx's columns, ``out``
row-parallel.  recurrentgemma-9b's smoke config (lru_width 64, 4 query
heads on one KV head, d_ff 256) on (1, 2) and (2, 2) splits evenly; on
(1, 3) the width (21 / 21 / 22), the heads (1 / 1 / 2) and d_ff (85 /
85 / 86) all split unevenly and every projection is replicated by
``_fit`` and sliced.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

from torch_mesh_train_common import check_against_reference, port, \
    reference, setup  # noqa: E402

TIMEOUT = 120.0     # seconds for one start-up of the ranks


@functools.lru_cache(maxsize=1)
def _case():
    """The port's config, the weights, the batch and the reference's
    result, shared by the three meshes."""
    jcfg, tcfg, jp, nb = setup("recurrentgemma-9b")
    return tcfg, jp, nb, reference(jcfg, jp, nb)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 3)],
                         ids=lambda m: "x".join(map(str, m)))
def test_rglru_tp_matches_reference(mesh):
    tcfg, jp, nb, ref = _case()
    check_against_reference(ref, port(tcfg, jp, nb, mesh, timeout=TIMEOUT))
