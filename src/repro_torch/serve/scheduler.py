"""Host-side continuous-batching scheduler — the pure-Python half of the
serving engine.

The scheduler owns everything that is *not* device math: request queueing,
slot admission and eviction, prompt streaming (chunk-less prefill through
the shared decode step), per-slot generation budgets, and the sequence
budget. It never imports torch: each tick it plans a fixed-shape
``(tokens, active, sampling)`` batch for whatever backend executes the
step, and afterwards commits the sampled tokens. The same scheduler drives
the dense single-host backend and the ring-sharded backend
interchangeably (serve/sharded_cache.py).

Budgets: a request reserves ``prompt_len + max_new_tokens`` cache slots
(the engine writes prompt and all-but-the-last sampled token, so this
over-reserves by one — the safe side). ``submit`` truncates
``max_new_tokens`` to whatever fits in ``max_seq_len`` and rejects prompts
that leave no room to generate, so a slot's cache position can never run
past the cache and silently corrupt attention. Empty prompts are admitted
directly into sampling by seeding them with ``bos_token``.

Request lifecycle: ``queued -> running -> done | error | failed``. ``done``
is the only success state (``finish_reason`` says whether the generation
budget ran out, "length", or the request sampled ``eos_token``, "eos");
``error`` means the request itself was evicted as poisoned and
``failed`` means the engine gave up on it (tick budget exhausted,
unrecoverable fault). :meth:`Scheduler.snapshot`/:meth:`Scheduler.restore`
roll a planned-but-unhealthy tick back as if it never happened.

Optionally takes an :class:`repro_torch.obs.metrics.Registry` (stdlib only)
and keeps the request-lifecycle counters/gauges current:
``repro_requests_{submitted,done,error,failed}_total``,
``repro_evictions_total``, ``repro_active_slots``, ``repro_pending_requests``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.obs import metrics as obs_metrics

STATUS_QUEUED = "queued"
STATUS_RUNNING = "running"
STATUS_DONE = "done"
STATUS_ERROR = "error"       # evicted as poisoned
STATUS_FAILED = "failed"     # engine gave up
TERMINAL_STATUSES = (STATUS_DONE, STATUS_ERROR, STATUS_FAILED)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # [P] token ids
    max_new_tokens: int = 16
    out_tokens: list = field(default_factory=list)
    done: bool = False
    truncated: bool = False               # max_new clipped by the seq budget
    status: str = STATUS_QUEUED
    finish_reason: str = ""               # length | eos | error | failed


class Scheduler:
    """Slot bookkeeping for a fixed decode batch of ``max_batch`` rows."""

    def __init__(self, max_batch: int, max_seq_len: int, bos_token: int = 0,
                 eos_token: int = -1,
                 metrics: "obs_metrics.Registry | None" = None):
        self.max_batch = max_batch
        self.max_seq = max_seq_len
        self.bos_token = bos_token
        self.eos_token = eos_token        # < 0 disables EOS-based stopping
        self.metrics = metrics if metrics is not None \
            else obs_metrics.Registry()
        self._next_rid = 0
        self.pending: list[Request] = []
        self.slot_req: list[Optional[Request]] = [None] * max_batch
        self.slot_prompt_left = np.zeros(max_batch, np.int64)
        self.slot_new_left = np.zeros(max_batch, np.int64)

    def _sync_gauges(self) -> None:
        self.metrics.gauge(
            "repro_active_slots", "slots with a running request").set(
            sum(r is not None for r in self.slot_req))
        self.metrics.gauge(
            "repro_pending_requests", "queued, not yet admitted").set(
            len(self.pending))

    # ------------------------------------------------------------- client
    def submit(self, prompt, max_new_tokens: int = 16) -> Request:
        """Queue a request. Enforces the sequence budget: the prompt plus
        the generation budget must fit ``max_seq_len`` — ``max_new_tokens``
        is truncated to the room left, and a prompt with no room at all
        (``len(prompt) >= max_seq_len``) is rejected."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            # empty prompt: seed with BOS so the first tick samples
            prompt = np.array([self.bos_token], np.int32)
        if len(prompt) >= self.max_seq:
            raise ValueError(
                f"prompt of {len(prompt)} tokens leaves no room to generate "
                f"within max_seq_len={self.max_seq}")
        budget = self.max_seq - len(prompt)
        truncated = max_new_tokens > budget
        req = Request(self._next_rid, prompt,
                      min(max_new_tokens, budget), truncated=truncated)
        self._next_rid += 1
        self.pending.append(req)
        self.metrics.counter("repro_requests_submitted_total",
                             "requests accepted by submit()").inc()
        self._sync_gauges()
        return req

    @property
    def busy(self) -> bool:
        return bool(self.pending) or any(
            r is not None for r in self.slot_req)

    # ---------------------------------------------------------- scheduler
    def admit(self) -> list[tuple[int, Request]]:
        """Fill free slots from the pending queue; returns the newly
        admitted (slot, request) pairs so the backend can recycle (zero)
        each freed slot's cache before its first step."""
        admitted = []
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.pending:
                continue
            req = self.pending.pop(0)
            req.status = STATUS_RUNNING
            self.slot_req[slot] = req
            self.slot_prompt_left[slot] = len(req.prompt)
            self.slot_new_left[slot] = req.max_new_tokens
            admitted.append((slot, req))
        if admitted:
            self._sync_gauges()
        return admitted

    def note_prefilled(self, slot: int, n_tokens: int) -> None:
        """Record that the backend block-prefilled the first ``n_tokens``
        prompt tokens of ``slot`` (the rest still stream per tick)."""
        if self.slot_req[slot] is None:
            raise ValueError(f"note_prefilled on empty slot {slot}")
        if n_tokens <= 0:
            raise ValueError(
                f"note_prefilled needs a positive token count, got "
                f"{n_tokens} for slot {slot}")
        if n_tokens >= self.slot_prompt_left[slot]:
            raise ValueError(
                f"block prefill of {n_tokens} tokens would consume the "
                f"whole remaining prompt ({int(self.slot_prompt_left[slot])} "
                f"tokens) of slot {slot}; the final prompt token must "
                f"stream through the decode step so sampling stays uniform")
        self.slot_prompt_left[slot] -= n_tokens

    def plan(self):
        """Plan one tick: (tokens [B,1] int32, active [B], sampling [B]).

        Slots still consuming their prompt feed the next prompt token;
        slots whose prompt is exhausted feed their last sampled token and
        sample again from the step's logits."""
        tokens = np.zeros((self.max_batch, 1), np.int32)
        active = np.zeros(self.max_batch, bool)
        sampling = np.zeros(self.max_batch, bool)
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            active[slot] = True
            if self.slot_prompt_left[slot] > 0:
                idx = len(req.prompt) - self.slot_prompt_left[slot]
                tokens[slot, 0] = req.prompt[idx]
                self.slot_prompt_left[slot] -= 1
                sampling[slot] = self.slot_prompt_left[slot] == 0
            else:
                tokens[slot, 0] = req.out_tokens[-1]
                sampling[slot] = True
        return tokens, active, sampling

    def commit(self, sampling: np.ndarray, next_tok: np.ndarray) -> None:
        """Append this tick's sampled tokens; retire exhausted slots and
        slots that sampled ``eos_token``."""
        for slot, req in enumerate(self.slot_req):
            if req is None or not sampling[slot]:
                continue
            tok = int(next_tok[slot])
            req.out_tokens.append(tok)
            self.slot_new_left[slot] -= 1
            if self.eos_token >= 0 and tok == self.eos_token:
                self._retire(slot, "eos")
            elif self.slot_new_left[slot] <= 0:
                self._retire(slot, "length")

    def _retire(self, slot: int, reason: str) -> None:
        req = self.slot_req[slot]
        req.done = True
        req.status = STATUS_DONE
        req.finish_reason = reason
        self.slot_req[slot] = None
        self.slot_prompt_left[slot] = 0
        self.slot_new_left[slot] = 0
        self.metrics.counter("repro_requests_done_total",
                             "requests finished successfully").inc()
        self._sync_gauges()

    # ------------------------------------------------------ fault surface
    def evict(self, slot: int, status: str = STATUS_ERROR,
              reason: str = "") -> Request:
        """Terminally evict a running request (poisoned or given up on):
        it keeps whatever tokens were committed but is marked ``status``
        (never ``done``) and its slot frees for the next admission."""
        req = self.slot_req[slot]
        if req is None:
            raise ValueError(f"evict on empty slot {slot}")
        req.status = status
        req.finish_reason = reason or status
        req.done = False
        self.slot_req[slot] = None
        self.slot_prompt_left[slot] = 0
        self.slot_new_left[slot] = 0
        self.metrics.counter("repro_evictions_total",
                             "running requests terminally evicted").inc()
        self.metrics.counter(f"repro_requests_{status}_total",
                             f"requests ending in status {status}").inc()
        self._sync_gauges()
        return req

    def fail_all(self, reason: str) -> list[Request]:
        """Mark every in-flight and pending request terminally failed
        (engine shutdown paths: tick budget exhausted, unrecoverable
        fault). Returns the failed requests."""
        failed = []
        for slot, req in enumerate(self.slot_req):
            if req is not None:
                failed.append(self.evict(slot, STATUS_FAILED, reason))
        for req in self.pending:
            req.status = STATUS_FAILED
            req.finish_reason = reason
            failed.append(req)
            self.metrics.counter("repro_requests_failed_total",
                                 "requests ending in status failed").inc()
        self.pending.clear()
        self._sync_gauges()
        return failed

    def snapshot(self) -> dict:
        """Capture the mutable tick state. ``plan`` mutates
        ``slot_prompt_left`` before the backend runs, so a tick that turns
        out unhealthy must be rolled back with :meth:`restore` before it
        is re-planned (Request objects are only mutated at commit/retire
        time, which the health monitor withholds until the step is known
        healthy)."""
        return {
            "slot_req": list(self.slot_req),
            "pending": list(self.pending),
            "prompt_left": self.slot_prompt_left.copy(),
            "new_left": self.slot_new_left.copy(),
        }

    def restore(self, snap: dict) -> None:
        self.slot_req = list(snap["slot_req"])
        self.pending = list(snap["pending"])
        self.slot_prompt_left = snap["prompt_left"].copy()
        self.slot_new_left = snap["new_left"].copy()
