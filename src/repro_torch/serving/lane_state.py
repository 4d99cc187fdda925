"""Per-lane transient state for the serving engine.

A *lane* is one decode stream; the engine batches every active lane
through a single decode step.  Everything here is transient — sessions,
the lane pool, span bookkeeping and current tokens die with a crash and
are rebuilt by ``ServingEngine.crash_and_recover`` from the durable
image.  Split out of the engine so admission policy
(``serving.scheduler``) and publish bookkeeping
(``serving.prefix_trie_cache``) can reason about lane lifetime without the
decode plumbing.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Session:
    lane: int
    tokens: list
    done: bool = False


class LaneStates:
    """Lane pool + per-lane session/span records.

    ``large_spans``: lanes holding a contiguous multi-superblock page
    span (oversized prompts): lane -> (span head offset, n_pages); the
    owner holds a full-extent lease released via ``free_large`` —
    unleased tail superblocks (decode-ahead slack nobody's prefix lease
    covers) free right then, not at the last holder's exit.

    ``shared_spans``: lanes that *acquired* a prefix lease on another
    lane's published span (shared-prefix hits — exact whole-prompt hits
    AND longest-prefix partial hits alike; a partial hit leases the
    matched trie node's span prefix and decodes its suffix on its own
    lazily-allocated pages): lane -> (off, n_backed_pages, lease_sbs);
    finish releases exactly that prefix range.

    ``partial_hits``: the subset of shared-span lanes admitted through a
    *partial* (longest-prefix) trie match: lane -> matched whole pages.
    Pure observability — the span bookkeeping above is authoritative for
    every release path — but it is what the hierprompt benchmark and the
    trie serving tests read to assert O(suffix) footprints.
    """

    def __init__(self, lanes: int):
        self.lanes = lanes
        self.sessions: dict[int, Session] = {}
        self.free_lanes: list[int] = list(range(lanes))
        self.large_spans: dict[int, tuple[int, int]] = {}
        self.shared_spans: dict[int, tuple[int, int, int]] = {}
        self.partial_hits: dict[int, int] = {}
        self.cur_tokens = np.zeros((lanes,), np.int32)

    def acquire(self) -> int | None:
        """Claim a free lane — ``None`` when every lane is busy.  The
        caller turns that into admission control (a typed ``EngineBusy``
        or a wait-queue park), never a bare pop failure."""
        return self.free_lanes.pop() if self.free_lanes else None

    def release(self, lane: int) -> None:
        self.free_lanes.append(lane)

    def active(self) -> np.ndarray:
        """Boolean mask of lanes with a live, unfinished session."""
        act = np.zeros((self.lanes,), bool)
        for lane, s in self.sessions.items():
            if not s.done:
                act[lane] = True
        return act


def reset_lane(dstate: dict, lane: int) -> dict:
    """Neutralize one lane's decode state — fresh admission, or backing
    out a failed reservation: pos 0, no backing pages, no prefix KV.
    Writes the decode-state tensors in place and returns the dict."""
    dstate["pos"][lane] = 0
    dstate["block_table"][lane] = -1
    dstate["kv_pos"][lane] = -1
    return dstate
