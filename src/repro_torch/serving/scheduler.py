"""Admission control, continuous batching, and the group-commit queue.

The engine (``serving.engine``) is the mechanism: lanes, pages, spans,
one batched decode step.  This module is the policy that turns it into a
serving loop:

  * **admission** — ``submit`` claims a free lane immediately or parks
    the request in a bounded wait queue; a full queue raises the typed
    :class:`EngineBusy` instead of the old bare ``IndexError`` from
    ``free_lanes.pop()``;
  * **continuous batching** — every ``step`` first admits waiting
    arrivals onto lanes freed by finished requests, then runs one
    batched decode step for all active lanes, then collects finishes
    (publishing their prefixes when requested) — arrivals and exits
    interleave with decode instead of draining the whole batch;
  * **group commit** — span-path publications park their durable record
    append (``ServingEngine.queue_publish``) and the scheduler flushes
    them in batches (``ServingEngine.flush_publishes``): N records land
    behind ONE chained append and ONE root swing, the device mirror of
    ``PrefixIndex.publish_batch``, so publish persistence amortizes
    across requests instead of costing one fence pair each.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

from .. import obs


class EngineBusy(RuntimeError):
    """Admission failed: every lane is busy (and, from ``submit``, the
    wait queue is full).  Typed so callers can shed load or retry
    instead of pattern-matching a bare ``IndexError``."""


# Serving-path metrics (cached at import; see repro_torch.obs conventions).
_OBS_REJECTS = obs.counter("sched.rejects")
_OBS_PARK_RETRY = obs.counter("sched.park_retries")
_OBS_QUEUE_DEPTH = obs.gauge("sched.queue_depth")
_OBS_QUEUE_DEPTH_H = obs.histogram("sched.queue_depth_at_submit")
_OBS_TTFT = obs.histogram("serve.ttft_seconds")
_OBS_LATENCY = obs.histogram("serve.latency_seconds")


@dataclasses.dataclass
class PendingPublish:
    """One span-path publication parked in the group-commit queue.

    The transient half already happened at queue time — cache entry
    inserted, trie node attached, prefix lease acquired — so sharers can
    hit immediately; only the durable record append waits for the batch
    flush, exactly like ``PrefixTrie._commit_new`` chains records behind
    one fence and one root swing.

    The trie fields (``start_page`` / ``parent_key`` / ``fprint``)
    default to the flat depth-1 shape: the node covers ``[0, n_pages)``
    under the root.  ``parent_key`` is the parent *node key* — the
    record offset is resolved at flush time (the parent may itself still
    be parked earlier in the queue)."""
    key: int
    span: int
    n_pages: int
    span_pages: int
    next_tok: int
    lease_sbs: int
    start_page: int = 0
    parent_key: int = -1
    fprint: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    share_prefix: bool
    max_new_tokens: int | None
    publish: bool
    lane: int | None = None
    session: object = None
    t_submit: float = 0.0        # perf_counter at submit (latency metrics)
    t_first: float | None = None  # perf_counter at first emitted token


class Scheduler:
    """Continuous-batching driver over one :class:`ServingEngine`.

    ``max_waiting`` bounds the wait queue (admission control);
    ``publish_every`` is the group-commit cadence — parked publishes
    flush every that-many steps, or sooner when a full batch
    (``engine.publish_capacity``) accumulates.
    """

    def __init__(self, engine, *, max_waiting: int = 64,
                 publish_every: int = 4):
        self.engine = engine
        self.max_waiting = max_waiting
        self.publish_every = max(1, publish_every)
        self.waiting: deque[Request] = deque()
        self.active: dict[int, Request] = {}     # lane -> request
        self.results: dict[int, list] = {}       # rid -> final tokens
        self._next_rid = 0
        self._steps = 0

    # ------------------------------------------------------------ admission
    def submit(self, prompt, *, share_prefix: bool = False,
               max_new_tokens: int | None = None,
               publish: bool = False) -> int:
        """Admit now if a lane is free, else enqueue; raises
        :class:`EngineBusy` when the wait queue is full too."""
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, list(prompt), share_prefix, max_new_tokens,
                      publish, t_submit=time.perf_counter())
        if not self._admit(req):
            if len(self.waiting) >= self.max_waiting:
                _OBS_REJECTS.inc()
                raise EngineBusy(
                    f"all {self.engine.lanes} lanes busy and the wait "
                    f"queue is full ({self.max_waiting})")
            self.waiting.append(req)
        _OBS_QUEUE_DEPTH.set(len(self.waiting))
        _OBS_QUEUE_DEPTH_H.observe(len(self.waiting))
        return rid

    def _admit(self, req: Request) -> bool:
        eng = self.engine
        if not eng.free_lanes:
            return False
        try:
            req.lane = eng.add_request(req.prompt,
                                       share_prefix=req.share_prefix)
        except EngineBusy:
            return False
        except MemoryError:
            # span reservation failed; the engine neutralized the lane.
            # Spans free as other requests finish, so park and retry —
            # unless nothing is running, in which case it can never fit.
            if not self.active:
                raise
            _OBS_PARK_RETRY.inc()
            return False
        req.session = eng.sessions[req.lane]
        self.active[req.lane] = req
        return True

    def _admit_waiting(self) -> None:
        while self.waiting and self.engine.free_lanes:
            if not self._admit(self.waiting[0]):
                break
            self.waiting.popleft()

    # ----------------------------------------------------------------- loop
    def step(self) -> dict[int, int]:
        """One continuous-batching tick: admit → decode → collect
        finishes → maybe flush the publish queue.  Returns
        ``rid -> emitted token`` for lanes that sampled this step."""
        eng = self.engine
        self._admit_waiting()
        emitted = eng.step()
        self._steps += 1
        out: dict[int, int] = {}
        for lane, req in list(self.active.items()):
            if lane in emitted:
                out[req.rid] = emitted[lane]
                if req.t_first is None:
                    req.t_first = time.perf_counter()
                    _OBS_TTFT.observe(req.t_first - req.t_submit)
            sess = eng.sessions.get(lane)
            if sess is None or sess.done:
                self._complete(lane, req)        # engine auto-finished it
            elif (req.max_new_tokens is not None
                    and len(sess.tokens)
                    >= len(req.prompt) + req.max_new_tokens):
                if req.publish:
                    eng.queue_publish(lane)
                eng.finish(lane)
                self._complete(lane, req)
        if (eng.pending_publishes >= eng.publish_capacity
                or (eng.pending_publishes
                    and self._steps % self.publish_every == 0)):
            eng.flush_publishes()
        return out

    def _complete(self, lane: int, req: Request) -> None:
        del self.active[lane]
        self.results[req.rid] = list(req.session.tokens)
        _OBS_LATENCY.observe(time.perf_counter() - req.t_submit)
        _OBS_QUEUE_DEPTH.set(len(self.waiting))

    def drain(self, max_steps: int = 100_000) -> dict[int, list]:
        """Step until every submitted request completes, then flush any
        parked publishes; returns ``rid -> final tokens``."""
        steps = 0
        while (self.active or self.waiting) and steps < max_steps:
            self.step()
            steps += 1
        if self.active or self.waiting:
            raise RuntimeError("scheduler drain did not converge")
        self.engine.flush_publishes()
        return self.results
