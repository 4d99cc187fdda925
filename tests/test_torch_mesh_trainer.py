"""``Trainer(..., mesh=)`` on gloo ranks: the elastic restore and the
failure of one rank.

- The counterpart of ``tests/test_checkpoint_and_train.py::
  test_elastic_restore_across_meshes``: a (2, 2) trainer saves its state
  (whole arrays, gathered to rank 0's heap file) after three steps; a
  (1, 4) trainer -- or a (1, 3) one, where the smoke config's heads and
  d_ff do not split -- and a one-device trainer over the same heap
  restore it,
  every leaf bit-equal to what was saved, and two more steps on each
  equal an uninterrupted one-device run within the train bounds (1e-5,
  or 2 x the summed learning rates where the first gradient is below
  1e-6 of its leaf's max: ``tests/test_torch_train.py``'s rule).
- A step made to raise on one rank of (2, 2) (after its gradient
  phase's collectives): every rank raises before the update, restores
  the last checkpoint and replays, and the final state equals an
  uninterrupted (2, 2) run's bit for bit.
- On one device, a store set on a trainer after it is built is used
  (how ``chip_smoke.py`` times its saves).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core.ralloc import Ralloc  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.launch.mesh_train import jobs, leaf_checksums, \
    numpy_tree  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

HEAP = 64 << 20
WARMUP = 2
NAMES = ("data", "model")


def _cfg():
    return dataclasses.replace(t_smoke("qwen2.5-32b"), dtype=torch.float32)


def _job(cfg, mesh, steps, **kw):
    return dict({"kind": "trainer", "cfg": cfg, "mesh": (mesh, NAMES),
                 "device": "cpu", "seed": 0,
                 "stream": (cfg.vocab_size, 4, 32, 3), "steps": steps,
                 "opt": {"warmup_steps": WARMUP}}, **kw)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("restored_on", [(1, 4), (1, 3)],
                         ids=lambda m: "x".join(map(str, m)))
def test_elastic_restore_across_meshes(tmp_path, restored_on):
    cfg = _cfg()
    ckpt = {"path": str(tmp_path / "ckpt.heap"), "size": HEAP}
    saved = run_ranks(jobs, 4, [
        _job(cfg, (2, 2), 3, ckpt=ckpt, ckpt_every=3, checksums=True)],
        device="cpu", timeout=120)[0][0]
    resumed = run_ranks(jobs, restored_on[0] * restored_on[1], [
        _job(cfg, restored_on, 5, ckpt=ckpt, ckpt_every=100,
             checksums=True, gather="params")], device="cpu",
        timeout=120)[0][0]
    assert saved["start_step"] == 0 and resumed["start_step"] == 3
    (step, digests), = saved["checksums_saved"]
    assert step == 3 and resumed["checksums_at_start"] == digests

    heap = Ralloc(ckpt["path"], HEAP)
    try:
        one = Trainer(cfg, AdamWConfig(warmup_steps=WARMUP),
                      ckpt=CheckpointManager(heap), ckpt_every=100,
                      device="cpu")
        assert one.start_step == 3
        assert leaf_checksums(one.whole_state()) == digests
        stream = TokenStream(cfg.vocab_size, 4, 32, seed=3)
        one.run(stream, steps=5)
    finally:
        heap.close()
    clean = Trainer(cfg, AdamWConfig(warmup_steps=WARMUP), device="cpu")
    _, g0 = loss_and_grads(cfg, clean.params, {
        k: torch.as_tensor(v) for k, v in stream.batch_at(0).items()})
    g0 = numpy_tree(g0)
    clean.run(stream, steps=5)
    lr_sum = sum(min(s / WARMUP, 1.0) * 3e-4 for s in range(1, 6))
    for path, want in tree_leaves(numpy_tree(clean.params)):
        g = np.abs(_get(g0, path))
        noise = g < 1e-6 * g.max()
        for got in (_get(resumed["state"], path),
                    _get(numpy_tree(one.params), path)):
            d = np.abs(got - want)
            assert (d[~noise] <= 1e-5).all(), (path, d[~noise].max())
            assert (d <= 2 * lr_sum).all(), path


def test_failure_on_one_rank_restores_every_rank(tmp_path, capfd):
    cfg = _cfg()
    ckpt = {"path": str(tmp_path / "ckpt.heap"), "size": HEAP}
    res = run_ranks(jobs, 4, [
        # rank 1's fourth gradient phase (step 3) raises
        _job(cfg, (2, 2), 5, ckpt=ckpt, ckpt_every=2, fail_at=(1, 4),
             gather="state"),
        _job(cfg, (2, 2), 5, gather="state")], device="cpu")
    assert "step 3 failed" in capfd.readouterr().out
    for rank in res:
        assert rank[0]["restored_at"] == 2
    failed, clean = res[0]
    # steps 0-2, then 2-4 replayed from the step-2 checkpoint
    assert len(failed["losses"]) == 6
    assert failed["losses"][:3] == clean["losses"][:3]
    assert failed["losses"][3:] == clean["losses"][2:]
    for path, want in tree_leaves(clean["state"]):
        assert np.array_equal(_get(failed["state"], path), want), path


def test_store_set_after_the_trainer_is_built_is_used():
    cfg = _cfg()
    tr = Trainer(cfg, AdamWConfig(warmup_steps=WARMUP), device="cpu")
    assert not tr.has_ckpt
    tr.ckpt, tr.ckpt_every = CheckpointManager(Ralloc(None, HEAP)), 2
    tr.run(TokenStream(cfg.vocab_size, 4, 32, seed=3), steps=2)
    restored, step = tr.ckpt.load_latest()
    assert step == 2
    for (_, got), want in zip(tree_leaves(tr.whole_state()), restored):
        assert torch.equal(got, want)
