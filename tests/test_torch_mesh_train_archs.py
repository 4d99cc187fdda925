"""The sharded train step on more layouts, against the reference's
one-device step (the bounds of ``tests/test_torch_train.py``):

- recurrentgemma-9b on (4, 1): FSDP only (the RG-LRU mixer and its tail
  layer on leaves gathered over ``data``; with ``model`` > 1 it is
  ROADMAP A8b (2));
- hubert-xlarge on (2, 2): no causal mask, the unshifted frame loss,
  frame embeddings for input;
- internvl2-26b on (2, 2) with its vocabulary set to 127 in both
  packages: 127 does not divide ``model``, so the tables stay replicated
  over it (as the published 92553 does) and the CE runs whole on every
  model rank;
- starcoder2-3b on (2, 2) with two microbatches and the int8 gradient
  codec, held to the reference's un-jitted step as
  ``test_int8_codec_train_steps_carry_the_residual`` holds the one-device
  step (ROADMAP C16): each leaf's scale from the leaf's global max over
  the mesh, the residual per block.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import compression as jcomp  # noqa: E402
from torch_mesh_train_common import check_against_reference, get, port, \
    reference, setup  # noqa: E402


@pytest.mark.parametrize("arch,mesh,over", [
    ("recurrentgemma-9b", (4, 1), {}), ("hubert-xlarge", (2, 2), {}),
    ("internvl2-26b", (2, 2), {"vocab_size": 127})],
    ids=["recurrentgemma-9b-4x1", "hubert-xlarge-2x2",
         "internvl2-26b-v127-2x2"])
def test_mesh_train_step_matches_reference_archs(arch, mesh, over):
    jcfg, tcfg, jp, nb = setup(arch, **over)
    check_against_reference(reference(jcfg, jp, nb),
                            port(tcfg, jp, nb, mesh))


class _Recorded:
    """A codec that keeps what it returned at each call."""

    def __init__(self, codec):
        self.codec, self.out = codec, []

    def __call__(self, grads):
        self.out.append(self.codec(grads))
        return self.out[-1]


def test_mesh_microbatches_with_int8_codec_match_reference():
    """Two microbatches (each rank splits its batch shard) and the int8
    codec on (2, 2), three steps, against the reference's un-jitted step
    with both: loss and grad norm at every step, parameters after three,
    within the train bounds -- loose (2 x the summed learning rates)
    where the reference's first gradient is noise, or where the two
    codecs' int8 roundings land on either side of a grid point at some
    step."""
    jcfg, tcfg, jp, nb = setup("starcoder2-3b")
    codec = _Recorded(jcomp.Int8ErrorFeedback(jax.tree.map(jnp.asarray,
                                                           jp)))
    ref = reference(jcfg, jp, nb, microbatches=2, compressor=codec,
                    jit=False)
    got = port(tcfg, jp, nb, (2, 2), microbatches=2, compress="record")
    assert len(got["codec_out"]) == len(codec.out) == 3

    def loose(path):
        out = None
        for t_out, j_out in zip(got["codec_out"], codec.out):
            want = np.asarray(get(j_out, path), np.float32)
            grid = np.abs(want).max() / 127
            off = np.abs(get(t_out, path) - want) > 0.5 * grid
            out = off if out is None else out | off
        return out
    check_against_reference(ref, got, loose)
