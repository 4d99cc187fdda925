"""Recoverable checkpoint store on a Ralloc persistent heap.

Port of the reference's ``checkpoint/manager.py``.  Every checkpoint
shard (one tensor leaf) is a block malloc'd from the heap; a *manifest*
block lists the shard pptrs plus JSON metadata, and a persistent root
points at the manifest — the root update is the atomic commit.  No
write-ahead log, no ordering between shard writes: if a crash lands
mid-checkpoint, the half-written shards are simply unreachable and
recovery GC reclaims them (paper §3 — exactly the allocate-then-attach
leak the paper's recoverability criterion covers).

Two roots alternate so the previous checkpoint stays reachable until the
new one commits.  All references are pptrs ⇒ the heap file can be
remapped anywhere, and tensors are stored whole (unsharded).

Manifest block layout (words):
  [0] n_shards   [1..n] pptr to shard block   [n+1] json byte length
  [n+2..] JSON metadata (leaf shapes, dtypes, word counts, step and the
  tree's structure as JAX prints it) packed LE.

The persist order is the reference's: each shard written and flushed,
one fence; the manifest written and flushed, a fence; the root swing;
the other root cleared; the old manifest and its shards freed.  What
differs is how the words move.  The reference stores and loads one word
per Python call; here, on a fast-mode heap (``NVMArray.bulk``), a shard is
one copy of the tensor's bytes into its block (from the card with no
staging copy; the last word's tail zero, as ``bytes.ljust`` pads it), a
flush of its lines adds their count, and a load copies a view of the
block to the leaf's device and dtype.  On a sim-mode heap the words go
through the per-word path, so the eviction RNG and a crash see what the
reference's stores would give.  Given the same trees the heap image and
the manifest's bytes equal the reference's, word for word.  Dtype names
are numpy's (``"bfloat16"``, ``"float32"``, ``"int32"``); bf16 moves as
raw bytes in both directions, with no numpy bf16 type.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from ..core import pptr as pp
from ..core.layout import WORD
from ..core.ralloc import Ralloc
from ..tree import tree_leaves, tree_unflatten, treedef_str

ROOT_A, ROOT_B = 0, 1


def dtype_name(dtype: torch.dtype) -> str:
    """The name numpy prints for the same element type."""
    return str(dtype).removeprefix("torch.")


_DTYPES = {dtype_name(d): d for d in (
    torch.bfloat16, torch.float16, torch.float32, torch.float64,
    torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
    torch.bool)}


def manifest_filter(reader, block_word, size_bytes):
    """Filter function (paper §4.5.1): enumerate shard pptrs precisely."""
    n = reader.read_word(block_word)
    for k in range(int(n)):
        w = block_word + 1 + k
        tgt = pp.decode(w, reader.read_word(w))
        if tgt is not None:
            yield tgt, None          # shard blocks contain raw data, no refs


def register_filters(heap: Ralloc) -> None:
    heap.filters.register("ckpt_manifest", manifest_filter)


def _leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a 1-D uint8 tensor on its device."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


class CheckpointManager:
    def __init__(self, heap: Ralloc):
        self.heap = heap
        register_filters(heap)
        self._flip = 0

    # ------------------------------------------------------------------ save
    def _store(self, blk: int, nwords: int, raw: torch.Tensor) -> None:
        """Application stores of ``raw``'s bytes at words
        ``[blk, blk + nwords)``, the tail of the last word zero."""
        mem = self.heap.mem
        if mem.bulk:
            dst = mem.byte_view(blk, nwords)
            dst[-WORD:] = 0
            if raw.numel():
                torch.from_numpy(dst[:raw.numel()]).copy_(raw)
            return
        padded = raw.cpu().numpy().tobytes().ljust(nwords * WORD, b"\0")
        self.heap.write_words(blk, np.frombuffer(padded, dtype=np.int64))

    def save(self, tree: dict, step: int) -> None:
        heap = self.heap
        meta, shard_ptrs = [], []
        for _, leaf in tree_leaves(tree):
            t = torch.as_tensor(leaf)
            raw = _leaf_bytes(t)
            nwords = max(1, -(-raw.numel() // WORD))
            blk = heap.malloc(nwords * WORD)
            if blk is None:
                raise MemoryError("checkpoint heap exhausted")
            self._store(blk, nwords, raw)     # application stores + flush
            heap.flush_range(blk, nwords)
            shard_ptrs.append(blk)
            meta.append({"shape": list(t.shape),
                         "dtype": dtype_name(t.dtype), "words": nwords})
        heap.fence()                          # shards durable before manifest

        mjson = json.dumps({"step": step, "leaves": meta,
                            "treedef": treedef_str(tree)}).encode()
        n = len(shard_ptrs)
        jwords = -(-len(mjson) // WORD)
        mblk = heap.malloc((2 + n + jwords) * WORD)
        if mblk is None:
            raise MemoryError("checkpoint heap exhausted")
        words = np.empty(2 + n + jwords, np.int64)
        words[0] = n
        words[1:1 + n] = [pp.encode(mblk + 1 + k, sp)
                          for k, sp in enumerate(shard_ptrs)]
        words[1 + n] = len(mjson)
        words[2 + n:] = np.frombuffer(mjson.ljust(jwords * WORD, b"\0"),
                                      np.int64)
        heap.write_words(mblk, words)
        heap.flush_range(mblk, 2 + n + jwords)
        heap.fence()                          # manifest durable before root

        root = (ROOT_A, ROOT_B)[self._flip]
        heap.set_root(root, mblk, "ckpt_manifest")   # atomic commit point
        other = (ROOT_B, ROOT_A)[self._flip]
        old = heap.get_root(other)
        heap.set_root(other, None)            # retire the older checkpoint
        self._flip ^= 1
        # the old manifest + shards are now unreachable; free eagerly in
        # normal operation (GC would also reclaim them after a crash)
        if old is not None:
            self._free_manifest(old)

    def _free_manifest(self, mblk: int) -> None:
        heap = self.heap
        n = int(heap.read_word(mblk))
        for k in range(n):
            w = mblk + 1 + k
            tgt = pp.decode(w, heap.read_word(w))
            if tgt is not None:
                heap.free(tgt)
        heap.free(mblk)

    # --------------------------------------------------------------- restore
    def _load_shard(self, blk: int, m: dict, like) -> torch.Tensor:
        """A shard as a new tensor: on ``like``'s device and in its dtype
        when given, else on the CPU in the stored dtype."""
        dtype = _DTYPES[m["dtype"]]
        nbytes = math.prod(m["shape"]) * dtype.itemsize
        words = torch.from_numpy(self.heap.read_words(blk, m["words"]))
        src = words.view(torch.uint8)[:nbytes].view(dtype).reshape(
            m["shape"])
        if like is None:
            return src.clone()
        like = torch.as_tensor(like)
        out = torch.empty(m["shape"], dtype=like.dtype, device=like.device)
        return out.copy_(src)

    def load_latest(self, tree_like=None):
        """Returns (tree or leaf list, step) from the newest live root,
        (None, -1) if none: with ``tree_like`` a tree shaped like it whose
        leaves lie on its leaves' devices in their dtypes, else the leaves
        on the CPU in their stored dtypes.  Every leaf is a copy: a later
        save cannot change it."""
        best = None
        for root in (ROOT_A, ROOT_B):
            mblk = self.heap.get_root(root, "ckpt_manifest")
            if mblk is None:
                continue
            info = self._read_manifest(mblk)
            if best is None or info[2]["step"] > best[2]["step"]:
                best = info
                self._flip = 1 - root         # next save goes to the other
        if best is None:
            return None, -1
        _, shard_ptrs, meta = best
        likes = ([x for _, x in tree_leaves(tree_like)]
                 if tree_like is not None else [None] * len(shard_ptrs))
        leaves = [self._load_shard(sp, m, like) for sp, m, like
                  in zip(shard_ptrs, meta["leaves"], likes)]
        if tree_like is not None:
            return tree_unflatten(tree_like, leaves), meta["step"]
        return leaves, meta["step"]

    def _read_manifest(self, mblk: int):
        heap = self.heap
        n = int(heap.read_word(mblk))
        ptrs = []
        for k in range(n):
            w = mblk + 1 + k
            ptrs.append(pp.decode(w, heap.read_word(w)))
        jlen = int(heap.read_word(mblk + 1 + n))
        jwords = -(-jlen // WORD)
        raw = np.array(heap.read_words(mblk + 2 + n, jwords)).tobytes()
        return mblk, ptrs, json.loads(raw[:jlen].decode())
