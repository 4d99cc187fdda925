"""Stable token hashes shared by the prefix cache and the durable store.

Copies of the reference's ``core.prefix_index.hash_tokens`` and
``core.prefix_trie.page_hashes`` / ``fingerprint``: their outputs are
stored in durable prefix records, so they must stay bit-identical to the
reference (pinned by the port's tests).
"""

from __future__ import annotations

_KEY_MASK = (1 << 48) - 1
_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def hash_tokens(tokens) -> int:
    """Deterministic 48-bit FNV-1a over a token sequence (Python's
    builtin ``hash`` is salted per process and useless across a crash)."""
    h = _FNV_OFFSET
    for t in tokens:
        h ^= int(t) & _M64
        h = (h * _FNV_PRIME) & _M64
    return h & _KEY_MASK


def page_hashes(tokens, page: int) -> list[int]:
    """Cumulative 48-bit prefix hash at every whole-page boundary:
    ``out[j] == hash_tokens(tokens[:(j + 1) * page])`` — one pass."""
    h = _FNV_OFFSET
    out: list[int] = []
    for j in range((len(tokens) // page) * page):
        h ^= int(tokens[j]) & _M64
        h = (h * _FNV_PRIME) & _M64
        if (j + 1) % page == 0:
            out.append(h & _KEY_MASK)
    return out


def fingerprint(first_tok: int, last_tok: int) -> int:
    """Pack the edge's first token (low 32 bits) and the prefix's last
    token (low 16 bits) into one 48-bit word."""
    return (int(first_tok) & _M32) | ((int(last_tok) & 0xFFFF) << 32)
