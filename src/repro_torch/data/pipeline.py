"""Deterministic synthetic data pipeline (+ optional file-backed tokens).

The port's copy of the reference's ``data/pipeline.py`` (numpy only, the
same seed formula, so the same batches bit for bit); the trainer moves
each batch to its device.

Seeded per (step, host) so every data shard draws a disjoint,
reproducible stream — restart-safe: resuming from step k regenerates
exactly the batches k, k+1, … (no pipeline state to checkpoint).
"""

from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, host: int = 0, frontend_dim: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.host = host
        self.frontend_dim = frontend_dim

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.host) * 1_000_003 + step)
        if self.frontend_dim:
            emb = rng.standard_normal(
                (self.batch, self.seq, self.frontend_dim)).astype(np.float32)
            labels = rng.integers(0, self.vocab,
                                  (self.batch, self.seq)).astype(np.int32)
            return {"embeds": emb, "labels": labels}
        toks = rng.integers(0, self.vocab,
                            (self.batch, self.seq)).astype(np.int32)
        return {"tokens": toks, "labels": toks}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FileTokenStream(TokenStream):
    """Tokens memmapped from a flat int32 file, sliced deterministically."""

    def __init__(self, path: str, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, host: int = 0):
        super().__init__(vocab_size, batch, seq_len, seed, host)
        self.data = np.memmap(path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> dict:
        n = self.batch * self.seq
        total = len(self.data) - n - 1
        off = ((self.seed + step * 16_777_619 + self.host) % max(total, 1))
        toks = np.asarray(self.data[off:off + n]).reshape(
            self.batch, self.seq) % self.vocab
        return {"tokens": toks.astype(np.int32),
                "labels": toks.astype(np.int32)}
