"""The port's checkpoint store against the reference's.

The same trees -- smoke params (through the numpy bridge) and seeded
AdamW-shaped moments -- saved by both managers give heap images equal
word for word, in fast mode (the port's bulk path) and in sim mode (the
per-word path), manifest bytes and ``treedef_str`` included; heap files
written by either package load in the other bit for bit; a save torn
between its fences and the root swing, then a crash, recovers to the
previous checkpoint with the torn shards swept, in both packages, with
the same images.  Then the reference's own checkpoint, trainer and
system cases run on the port, and the train CLI with ``--ckpt``."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core.ralloc import Ralloc as JRalloc  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core.ralloc import Ralloc  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.params import from_numpy_tree  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.tree import tree_leaves, treedef_str  # noqa: E402

MB = 1 << 20
TIMINGS = ("mark_seconds", "sweep_seconds", "total_seconds")


def _state(arch: str, seed: int = 0):
    """The reference's smoke params (numpy; bf16 as ml_dtypes) and fp32
    moments from a seeded rng: one tree for each package."""
    jp = jax.tree.map(np.asarray, JT.init_params(j_smoke(arch),
                                                 jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 1e-3, jp)
    v = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(
        np.float32) * 1e-6, jp)
    jtree = {"p": jp, "o_m": m, "o_v": v}
    return jtree, {k: from_numpy_tree(t) for k, t in jtree.items()}


def _bits(x) -> np.ndarray:
    """A leaf's bytes (a numpy array, ml_dtypes bf16 too, or a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _same_bits(a, b) -> bool:
    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    return la.keys() == lb.keys() and all(
        np.array_equal(_bits(la[k]), _bits(lb[k])) for k in la)


def _untimed(stats: dict) -> dict:
    out = {k: v for k, v in stats.items() if k not in TIMINGS}
    out["phases"] = {k: v["items"] for k, v in stats["phases"].items()}
    return out


def _manifest_json(heap, root: int) -> bytes:
    mblk = heap.get_root(root)
    n = heap.read_word(mblk)
    jlen = heap.read_word(mblk + 1 + n)
    words = [heap.read_word(mblk + 2 + n + k) for k in range(-(-jlen // 8))]
    return np.array(words, np.int64).tobytes()[:jlen]


@pytest.mark.parametrize("sim", [False, True])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "recurrentgemma-9b"])
def test_saved_images_match_reference(arch, sim):
    """Two saves (the second frees the first): after each, equal images,
    flush and fence counts and manifest bytes; the manifest's treedef is
    JAX's."""
    jtree, ttree = _state(arch)
    jh, th = (cls(None, 32 * MB, sim_nvm=sim, seed=3)
              for cls in (JRalloc, Ralloc))
    jm, tm = JManager(jh), CheckpointManager(th)
    for step, root in ((1, 0), (2, 1)):
        jm.save(jtree, step=step)
        tm.save(ttree, step=step)
        assert np.array_equal(jh.mem.nvm, th.mem.nvm)
        assert (jh.mem.n_flush, jh.mem.n_fence) == \
            (th.mem.n_flush, th.mem.n_fence)
        raw = _manifest_json(th, root)
        assert raw == _manifest_json(jh, root)
        meta = json.loads(raw)
        assert meta["step"] == step
        assert meta["treedef"] == str(jax.tree.flatten(jtree)[1])
    got, step = tm.load_latest(ttree)
    assert step == 2 and _same_bits(got, jtree)


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_treedef_str_matches_jax(arch):
    jp = jax.eval_shape(lambda: JT.init_params(j_smoke(arch),
                                               jax.random.PRNGKey(0)))
    tree = {"p": jp, "o_m": jp, "o_v": jp}
    assert treedef_str(tree) == str(jax.tree.flatten(tree)[1])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_file_heaps_load_across_packages(tmp_path, writer):
    """A heap file written and closed by one package opens clean in the
    other, which loads the checkpoint bit for bit (bf16 included)."""
    path = str(tmp_path / "ckpt.heap")
    jtree, ttree = _state("starcoder2-3b", seed=1)
    W, R = (JRalloc, Ralloc) if writer == "reference" else (Ralloc, JRalloc)
    heap = W(path, 32 * MB)
    (JManager if W is JRalloc else CheckpointManager)(heap).save(
        jtree if W is JRalloc else ttree, step=7)
    heap.close()
    heap = R(path, 32 * MB)
    assert not heap.dirty_restart
    if R is Ralloc:
        got, step = CheckpointManager(heap).load_latest(ttree)
        assert all(g.dtype == t.dtype for (_, g), (_, t) in
                   zip(tree_leaves(got), tree_leaves(ttree)))
    else:
        got, step = JManager(heap).load_latest(jtree)
    assert step == 7 and _same_bits(got, jtree)
    heap.close()


def _torn_save(heap, manager, tree, step):
    """``save`` with the root swing raising once: the shards and the
    manifest are durable, the commit never happens."""
    real = heap.set_root

    def fail(*args, **kw):
        heap.set_root = real
        raise RuntimeError("crash before the root swing")
    heap.set_root = fail
    with pytest.raises(RuntimeError, match="root swing"):
        manager.save(tree, step=step)


@pytest.mark.parametrize("sim", [False, True])
def test_crash_mid_save_keeps_the_previous_checkpoint(sim):
    jtree, ttree = _state("recurrentgemma-9b")
    jtree2, ttree2 = _state("recurrentgemma-9b", seed=5)
    heaps = [cls(None, 32 * MB, sim_nvm=sim, seed=9)
             for cls in (JRalloc, Ralloc)]
    mgrs = [JManager(heaps[0]), CheckpointManager(heaps[1])]
    for mgr, tree in zip(mgrs, (jtree, ttree)):
        mgr.save(tree, step=1)
    for heap, mgr, tree in zip(heaps, mgrs, (jtree2, ttree2)):
        _torn_save(heap, mgr, tree, 2)
        heap.heap.crash()
    assert np.array_equal(heaps[0].mem.nvm, heaps[1].mem.nvm)
    images = [h.mem.nvm.copy() for h in heaps]
    reopened = [cls(None, 32 * MB, sim_nvm=sim, seed=10, backing=img)
                for cls, img in zip((JRalloc, Ralloc), images)]
    mgrs = [JManager(reopened[0]), CheckpointManager(reopened[1])]
    stats = []
    for heap in reopened:
        assert heap.dirty_restart
        heap.get_root(0, "ckpt_manifest")
        heap.get_root(1, "ckpt_manifest")
        stats.append(heap.recover())
    assert _untimed(stats[0]) == _untimed(stats[1])
    n_leaves = len(list(tree_leaves(ttree)))
    assert stats[1]["reachable_blocks"] == n_leaves + 1   # + the manifest
    assert np.array_equal(reopened[0].mem.nvm, reopened[1].mem.nvm)
    got, step = mgrs[1].load_latest(ttree)
    assert step == 1 and _same_bits(got, jtree)
    assert mgrs[0].load_latest(jtree)[1] == 1      # (both next save root 1)
    # the torn save's blocks went back: a new save reuses them
    for heap, mgr, tree in zip(reopened, mgrs, (jtree2, ttree2)):
        mgr.save(tree, step=3)
    assert np.array_equal(reopened[0].mem.nvm, reopened[1].mem.nvm)
    got, step = mgrs[1].load_latest(ttree)
    assert step == 3 and _same_bits(got, jtree2)


def test_bulk_and_per_word_paths_give_the_same_image():
    _, ttree = _state("starcoder2-3b")
    images = []
    for sim in (False, True):
        heap = Ralloc(None, 32 * MB, sim_nvm=sim, seed=2)
        assert heap.mem.bulk is not sim
        mgr = CheckpointManager(heap)
        mgr.save(ttree, step=1)
        mgr.save(ttree, step=2)
        heap.close()                   # sim: every line written back
        images.append(heap.mem.nvm)
    assert np.array_equal(*images)


def test_loaded_leaves_are_copies():
    heap = Ralloc(None, 8 * MB)
    mgr = CheckpointManager(heap)
    tree = {"w": torch.arange(10, dtype=torch.float32),
            "s": torch.tensor(3, dtype=torch.int32)}
    mgr.save(tree, step=1)
    leaves, step = mgr.load_latest()
    got, _ = mgr.load_latest({"w": torch.zeros(10, dtype=torch.float64),
                              "s": torch.zeros((), dtype=torch.int32)})
    mgr.save({"w": tree["w"] * 5, "s": tree["s"]}, step=2)
    mgr.save({"w": tree["w"] * 7, "s": tree["s"]}, step=3)   # reuses blocks
    assert step == 1 and torch.equal(leaves[1], tree["w"])
    assert got["w"].dtype == torch.float64
    assert torch.equal(got["w"], tree["w"].double())
    assert got["s"].shape == () and int(got["s"]) == 3
    assert CheckpointManager(Ralloc(None, 8 * MB)).load_latest() == (None,
                                                                    -1)


# ---------------------------------------------------------------------------
# the reference's checkpoint, trainer and system cases, on the port
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_and_crash(tmp_path):
    path = str(tmp_path / "h")
    heap = Ralloc(path, 64 * MB, sim_nvm=True, seed=3)
    cm = CheckpointManager(heap)
    tree = {"w": torch.arange(1000, dtype=torch.float32).reshape(10, 100),
            "b": torch.ones((7,), dtype=torch.int64)}
    cm.save(tree, step=10)
    tree2 = {k: v * 2 for k, v in tree.items()}
    cm.save(tree2, step=20)
    for _ in range(5):                 # crash mid-"checkpoint": leaked shards
        heap.malloc(8000)
    heap.heap.crash()
    del heap, cm

    heap2 = Ralloc(path, 64 * MB, sim_nvm=True, seed=4)
    assert heap2.dirty_restart
    cm2 = CheckpointManager(heap2)
    heap2.get_root(0, "ckpt_manifest")
    heap2.get_root(1, "ckpt_manifest")
    heap2.recover()
    restored, step = cm2.load_latest(tree)
    assert step == 20 and torch.equal(restored["w"], tree2["w"])
    cm2.save({k: v * 3 for k, v in tree.items()}, step=30)
    r3, s3 = cm2.load_latest(tree)
    assert s3 == 30 and torch.equal(r3["w"], tree["w"] * 3)
    heap2.close()


def _tiny_cfg(**kw):
    return dataclasses.replace(t_smoke("starcoder2-3b"), num_layers=2,
                               vocab_size=64, **kw)


def _params_equal(a, b):
    lb = dict(tree_leaves(b))
    return all(torch.equal(x, lb[k]) for k, x in tree_leaves(a))


def test_trainer_resumes_from_checkpoint(tmp_path):
    cfg = _tiny_cfg()
    heap = Ralloc(str(tmp_path / "h"), 256 * MB)
    cm = CheckpointManager(heap)
    stream = TokenStream(cfg.vocab_size, 2, 32, seed=1)
    tr = Trainer(cfg, AdamWConfig(warmup_steps=2), ckpt=cm, ckpt_every=5,
                 device="cpu")
    tr.run(stream, steps=7, log_every=1000)
    # "crash": a new trainer over the same heap resumes at the ckpt step
    tr2 = Trainer(cfg, AdamWConfig(warmup_steps=2), ckpt=cm, ckpt_every=5,
                  device="cpu")
    assert tr2.start_step == 5 and tr2.opt["step"] == 5
    assert all(t.dtype == p.dtype for (_, t), (_, p) in
               zip(tree_leaves(tr2.params), tree_leaves(tr.params)))
    # deterministic data => re-running steps 5..7 reproduces the state
    tr2.run(stream, steps=7, log_every=1000)
    assert _params_equal(tr2.params, tr.params)
    heap.close()


def test_train_crash_restart_then_serve(tmp_path):
    """Train with a checkpoint every 4 steps, crash the heap, recover,
    resume at step 4, then serve the result with the paged engine, crash
    its allocator, recover, and keep generating."""
    cfg = _tiny_cfg(page_size=8)
    path = str(tmp_path / "h")
    heap = Ralloc(path, 256 << 20, sim_nvm=True, seed=7)
    cm = CheckpointManager(heap)
    stream = TokenStream(cfg.vocab_size, 2, 32, seed=3)
    tr = Trainer(cfg, AdamWConfig(warmup_steps=2), ckpt=cm, ckpt_every=4,
                 device="cpu")
    tr.run(stream, steps=6, log_every=1000)
    heap.heap.crash()                      # full-system crash, no close()
    del tr, cm, heap

    heap2 = Ralloc(path, 256 << 20, sim_nvm=True, seed=8)
    assert heap2.dirty_restart
    cm2 = CheckpointManager(heap2)
    heap2.get_root(0, "ckpt_manifest")
    heap2.get_root(1, "ckpt_manifest")
    stats = heap2.recover()
    assert stats["reachable_blocks"] > 0
    tr2 = Trainer(cfg, AdamWConfig(warmup_steps=2), ckpt=cm2, ckpt_every=4,
                  device="cpu")
    assert tr2.start_step == 4             # resumed from the committed root
    tr2.run(stream, steps=8, log_every=1000)

    with torch.inference_mode():
        eng = ServingEngine(cfg, tr2.params, lanes=2, max_seq=48,
                            device="cpu")
        lane = eng.add_request([1, 2, 3])
        for _ in range(12):
            eng.step()
        assert len(eng.sessions[lane].tokens) > 6
        rec = eng.crash_and_recover()
        assert rec["live_before"] == rec["live_after"]
        before = list(eng.sessions[lane].tokens)
        for _ in range(4):
            eng.step()
        assert eng.sessions[lane].tokens[:len(before)] == before
    heap2.close()


def test_train_cli_ckpt_resumes(tmp_path, capsys):
    heap = str(tmp_path / "train.heap")
    args = ["--arch", "starcoder2-3b", "--smoke", "--ckpt-every", "2",
            "--ckpt", heap, "--device", "cpu"]
    first = train_cli.main(args + ["--steps", "4"])
    assert len(first) == 4
    second = train_cli.main(args + ["--steps", "6"])
    assert len(second) == 2              # steps 4 and 5 only
    out = capsys.readouterr().out
    assert "resumed from the checkpoint at step 4" in out
    h = Ralloc(heap, 1 << 30)
    assert not h.dirty_restart           # closed cleanly at the end
    _, step = CheckpointManager(h).load_latest()
    assert step == 6
    h.close()
