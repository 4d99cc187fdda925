"""The port's sharded train step (``make_train_step(..., mesh=)``) on gloo
ranks against the reference's one-device ``jax.jit(make_train_step)``.

Each case runs three fp32 steps on one start-up of the ranks (~5 s here)
from the reference's weights and batch, and holds the port to
``tests/test_torch_train.py``'s bounds, gradient leaf by leaf (the blocks
gathered with ``gather_tree``): the dense attention and MLP with heads
over ``model``, qwen2.5-32b's 2 KV heads at tp 4 (each rank's query head
reads half of a gathered KV head), starcoder2-3b's LayerNorm, GELU,
biases and tied vocab-parallel table, and Mamba-2's heads over ``model``
(the gated norm's sum, in_bc replicated).  The reference's own test shows
its (2, 2) pjit step equal to the one-device step
(``tests/test_multidevice.py``).
"""

import pytest

torch = pytest.importorskip("torch")

from torch_mesh_train_common import check_against_reference, port, \
    reference, setup  # noqa: E402


@pytest.mark.parametrize("arch,mesh", [
    ("qwen2.5-32b", (2, 2)), ("qwen2.5-32b", (1, 4)),
    ("starcoder2-3b", (2, 2)), ("mamba2-370m", (2, 2))],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_mesh_train_step_matches_reference(arch, mesh):
    jcfg, tcfg, jp, nb = setup(arch)
    check_against_reference(reference(jcfg, jp, nb),
                            port(tcfg, jp, nb, mesh))
