"""The sharded train step where heads, d_ff or SSD heads do not split
evenly over ``model``, against the reference's one-device
``jax.jit(make_train_step)`` (the bounds of ``tests/test_torch_train.py``,
gradient leaf by leaf).

Each rank computes its range of the plan (``unit_ranges``: rank r the
units [r n / tp, (r + 1) n / tp)), taking a leaf's block where every
rank's block is its range and else the leaf gathered over ``model`` (or,
replicated by ``_fit``, marked) and sliced:

- qwen2.5-32b smoke with 6 query heads on (1, 4): wq's 96 columns split
  (24 a rank) but the heads do not (1 / 2 / 1 / 2), so wq, wk, wv and wo
  are gathered over ``model`` and sliced;
- qwen2.5-32b smoke with 10 query heads on 2 KV heads on (1, 3): wq's
  160 columns do not divide, so ``_fit`` replicates them; rank 1's heads
  3, 4 read KV head 0 and head 5 KV head 1 (wk / wv's columns repeated
  a query head); d_ff 256 splits 85 / 85 / 86;
- mamba2-370m smoke on (1, 3): 8 SSD heads as 2 / 3 / 3, and the gated
  norm divided by the whole d_inner.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_mesh_train_common import check_against_reference, port, \
    reference, setup  # noqa: E402

TIMEOUT = 120.0     # seconds for one start-up of the ranks


@pytest.mark.parametrize("arch,mesh,over", [
    ("qwen2.5-32b", (1, 4), {"num_heads": 6}),
    ("qwen2.5-32b", (1, 3), {"num_heads": 10}),
    ("mamba2-370m", (1, 3), {})],
    ids=["qwen2.5-32b-h6-1x4", "qwen2.5-32b-h10-1x3", "mamba2-370m-1x3"])
def test_uneven_split_matches_reference(arch, mesh, over):
    jcfg, tcfg, jp, nb = setup(arch, **over)
    check_against_reference(reference(jcfg, jp, nb),
                            port(tcfg, jp, nb, mesh, timeout=TIMEOUT))
