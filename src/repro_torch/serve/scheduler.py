"""Continuous-batching scheduler: slot bookkeeping for the serving engine.

Own copy of ``repro/serve/scheduler.py`` for the port. Pure-Python
request/slot logic: the engine owns the device tensors.
The decode batch is a fixed grid of ``max_batch`` slots; every scheduler
"tick" (a) admits waiting requests into free slots, grouped into prefill
batches by bucketed prompt length, and (b) after the engine's decode step,
records sampled tokens, applies per-sequence stopping (EOS / token budget /
context limit), and evicts finished requests so their slots free up for
the next admission — requests join and leave the batch mid-flight, no
generation ever waits for the longest member of a static batch.

Prompt-length bucketing: requests are grouped by exact prompt length by
default (one prefill shape per distinct length — fine when lengths
repeat). With ``bucket_lengths=True`` the engine additionally rounds
lengths up to the next power of two and LEFT-pads the prompts, bounding
prefill shapes to O(log max_len) — only exact for pad-safe configs (see
``repro_torch.models.model.pad_safe``), which is why the engine, not this
module, decides to enable it.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.metrics import Metrics


class QueueFullError(RuntimeError):
    """Admission queue is at ``max_queue`` — the caller should back off
    and retry (reject-on-full backpressure)."""


def bucket_length(n: int, *, minimum: int = 16) -> int:
    """Next power of two >= n (floored at ``minimum``)."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class Request:
    """One generation request and its runtime state."""

    uid: int
    prompt: np.ndarray                  # (L,) int32
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0
    stream: int = 0                     # RNG stream id (seed, stream) -> key

    tokens: List[int] = field(default_factory=list)   # generated so far
    slot: int = -1
    done: bool = False
    finish_reason: Optional[str] = None               # eos | length | deadline
    deadline: Optional[float] = None                  # absolute clock() time
    finished_at: Optional[float] = None               # set on eviction

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def record(self, tok: int) -> bool:
        """Append a sampled token; returns True if the request finished."""
        self.tokens.append(tok)
        if self.eos_id is not None and tok == self.eos_id:
            self.done, self.finish_reason = True, "eos"
        elif len(self.tokens) >= self.max_new_tokens:
            self.done, self.finish_reason = True, "length"
        return self.done


@dataclass
class PrefillBatch:
    """One admission group: same padded prompt length, assigned slots."""

    requests: List[Request]
    prompts: np.ndarray                 # (n, Lb) int32, left-padded
    pad_lens: np.ndarray                # (n,) int32 (zeros when exact)
    slots: np.ndarray                   # (n,) int32

    @property
    def padded(self) -> bool:
        return bool(self.pad_lens.any())


class ContinuousScheduler:
    """Admit/evict requests over a fixed grid of decode slots.

    ``metrics`` (a :class:`repro_torch.obs.metrics.Metrics` registry, usually the
    engine's) receives the scheduler-side telemetry: ``submitted`` /
    ``admitted`` / ``evicted`` / ``finished_<reason>`` / ``rejected``
    counters and the ``queue_depth`` gauge (+peak).

    Graceful degradation under overload:

    * ``max_queue`` bounds the waiting list — ``submit`` raises
      :class:`QueueFullError` when full, so upstream load sheds at the
      door instead of growing an unbounded backlog;
    * per-request deadlines (``submit(..., deadline_s=...)``): each
      :meth:`expire` pass evicts waiting AND active requests past their
      deadline with ``finish_reason="deadline"``, freeing their slots;
    * ``finished_timeout`` bounds the ``finished`` dict — results not
      collected within the timeout are dropped by :meth:`expire`, so a
      long-lived engine cannot leak memory on abandoned requests."""

    def __init__(self, max_batch: int, max_len: int, *,
                 bucket_lengths: bool = False, pad_token: int = 0,
                 metrics: Optional[Metrics] = None,
                 max_queue: Optional[int] = None,
                 finished_timeout: Optional[float] = None,
                 clock=time.monotonic):
        self.max_batch = max_batch
        self.max_len = max_len
        self.bucket_lengths = bucket_lengths
        self.pad_token = pad_token
        self.max_queue = max_queue
        self.finished_timeout = finished_timeout
        self.clock = clock
        self.metrics = metrics if metrics is not None else Metrics()
        self.waiting: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.finished: Dict[int, Request] = {}
        self._uid = itertools.count()

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, temperature: float = 0.0,
               eos_id: Optional[int] = None, seed: int = 0,
               stream: int = 0, deadline_s: Optional[float] = None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the first token "
                             "is sampled from the prefill logits)")
        if prompt.shape[0] + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.shape[0]}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len={self.max_len}")
        if self.max_queue is not None \
                and len(self.waiting) >= self.max_queue:
            self.metrics.inc("rejected")
            raise QueueFullError(
                f"admission queue full ({len(self.waiting)}/"
                f"{self.max_queue} waiting, {len(self.active)} active) — "
                "back off and retry")
        req = Request(uid=next(self._uid), prompt=prompt,
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      eos_id=eos_id, seed=seed, stream=stream,
                      deadline=(self.clock() + deadline_s
                                if deadline_s is not None else None))
        self.waiting.append(req)
        self.metrics.inc("submitted")
        self.metrics.gauge("queue_depth", len(self.waiting))
        return req.uid

    # -- state queries ------------------------------------------------------

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slots)

    # -- admission ----------------------------------------------------------

    def admit(self) -> List[PrefillBatch]:
        """Move waiting requests into free slots, FIFO within each group;
        one :class:`PrefillBatch` per (bucketed) prompt length."""
        free = self.free_slots()
        if not free or not self.waiting:
            return []
        take = self.waiting[:len(free)]
        self.waiting = self.waiting[len(take):]
        self.metrics.inc("admitted", len(take))
        self.metrics.gauge("queue_depth", len(self.waiting))

        groups: Dict[int, List[Request]] = {}
        for r in take:
            lb = min(bucket_length(r.prompt_len), self.max_len) \
                if self.bucket_lengths else r.prompt_len
            groups.setdefault(lb, []).append(r)

        batches = []
        for lb, reqs in groups.items():
            n = len(reqs)
            prompts = np.full((n, lb), self.pad_token, np.int32)
            pads = np.zeros((n,), np.int32)
            slots = np.empty((n,), np.int32)
            for j, r in enumerate(reqs):
                pads[j] = lb - r.prompt_len
                prompts[j, pads[j]:] = r.prompt
                r.slot = slots[j] = free.pop(0)
                self.slots[r.slot] = r
            batches.append(PrefillBatch(reqs, prompts, pads, slots))
        return batches

    # -- per-step bookkeeping ----------------------------------------------

    def record_step(self, sampled: np.ndarray) -> List[Request]:
        """Record one decode step's sampled token per active slot; evict
        and return the requests that finished."""
        out = []
        for i, r in enumerate(self.slots):
            if r is None or r.done:
                continue
            if r.record(int(sampled[i])):
                out.append(self._evict(r))
        return out

    def record_prefill(self, batch: PrefillBatch,
                       sampled: np.ndarray) -> List[Request]:
        """Record the first token (sampled from prefill logits) for each
        request of an admission group; evicts immediate EOS hits."""
        out = []
        for j, r in enumerate(batch.requests):
            if r.record(int(sampled[j])):
                out.append(self._evict(r))
        return out

    def _evict(self, req: Request) -> Request:
        if req.slot >= 0:
            self.slots[req.slot] = None
        req.finished_at = self.clock()
        self.finished[req.uid] = req
        self.metrics.inc("evicted")
        self.metrics.inc(f"finished_{req.finish_reason}")
        return req

    # -- degradation: deadlines + finished-result eviction ------------------

    def expire(self, now: Optional[float] = None) -> List[Request]:
        """One degradation pass (call once per engine tick): evict
        waiting and active requests past their deadline
        (``finish_reason="deadline"``, partial tokens kept) and drop
        finished results older than ``finished_timeout``. Returns the
        newly deadline-evicted requests so the engine can emit their
        records."""
        now = self.clock() if now is None else now
        out: List[Request] = []
        expired_waiting = [r for r in self.waiting
                           if r.deadline is not None and now >= r.deadline]
        if expired_waiting:
            self.waiting = [r for r in self.waiting
                            if r not in expired_waiting]
            self.metrics.gauge("queue_depth", len(self.waiting))
        for r in expired_waiting + [
                r for r in self.slots
                if r is not None and r.deadline is not None
                and now >= r.deadline]:
            r.done, r.finish_reason = True, "deadline"
            out.append(self._evict(r))
        if self.finished_timeout is not None:
            stale = [uid for uid, r in self.finished.items()
                     if r.finished_at is not None
                     and now - r.finished_at > self.finished_timeout]
            for uid in stale:
                del self.finished[uid]
            if stale:
                self.metrics.inc("finished_expired", len(stale))
        return out
