"""Continuous batching: admissions between decode steps, never flushes.

A queued request is admitted into a freed decode slot between two
decode steps: it is prefilled into its slot, and the next decode step
carries one more live slot. In-flight sequences keep their slots and
their cache; a long generation never holds short ones back.

Policy knobs:

* ``max_admit_per_step``: prefills admitted between two decode steps
  (``HOROVOD_SERVE_MAX_BATCH``). Prefill runs on the decode thread, so
  each admission delays every in-flight token by one prefill: this is
  the TTFT-versus-TPOT trade.
* per-request deadlines: queued requests expire before a prefill is
  spent on them; running ones are evicted at the deadline with their
  partial output (status ``"deadline"``).

Paged memory plane (the default): admission is also gated on free KV
pages above the reserve watermark. If the pool still runs dry
mid-decode, the youngest running request is paused (re-queued at the
front with its pages kept for a pointer resume) and, as a last resort,
a paused request's pages are reclaimed, nearest deadline first; it then
re-prefills its prompt and the tokens generated so far.

``drain()`` (wired to SIGTERM through ``preemption.register_drain``)
stops admitting new submissions but runs the queue and in-flight work
to completion; with ``migrate_after=`` and an ``on_deadline`` hook, the
sequences still in flight past the deadline are exported
(:meth:`ContinuousBatcher.export_inflight`) for live migration instead.

Roles (the disaggregated fleet, ``serving/kv_transfer.py``): a
``prefill`` worker reserves pages on a decode worker before it spends a
prefill, prefills, detaches the slot's pages and hands them to its
:class:`~.kv_transfer.TransferCoordinator` (``start_handoff``); the
result comes back through :meth:`ContinuousBatcher.complete_handoff`,
or the request comes home for a local decode
(:meth:`ContinuousBatcher.requeue_fallback`, counted in
``serve.transfer_fallbacks``). With no decode capacity anywhere the
request takes the local path at once (``serve.transfer_local``). A
``decode`` worker takes no prompts: its requests arrive through
:meth:`ContinuousBatcher.submit_ingested` and their pages land in the
pool at admission, on the scheduler thread. Both roles need the paged
plane. A live-migrated sequence arrives mid-decode through
:meth:`ContinuousBatcher.submit_migrated`: its whole token history and
the sender's sampling state, its pages landed at admission with no
prefill. The ``serve.worker_kill`` fault site fires at the top of every
round (:meth:`ContinuousBatcher.step`): a transport kind crashes the
scheduler, which aborts every accepted request, the dark worker the
fleet's Router replays around.

The scheduler thread runs all device work and binds itself to the
engine's device; submitting threads only touch host bookkeeping.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..common import tracing as _tracing
from ..common.logging import get_logger
from ..common.metrics import registry as _metrics
from ..testing import chaos as _chaos
from .paged_kv import PagePoolExhausted
from .slo import LatencyRecorder

_log = get_logger("serve.batcher")

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
DEADLINE = "deadline"
ERROR = "error"


class Rejected(RuntimeError):
    """Request refused at submission (draining, or it can never fit)."""


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray
    max_new_tokens: int
    deadline_ts: Optional[float]  # monotonic; None = no deadline
    submitted: float = dataclasses.field(default_factory=time.monotonic)
    status: str = QUEUED
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_ms: float = 0.0
    gen_ms: float = 0.0
    # pause/resume on pool exhaustion: kept_pages holds the page-table
    # snapshot for a pointer resume, or None once reclaimed (then the
    # resume re-prefills prompt + generated-so-far)
    paused: bool = False
    kept_pages: Optional[list] = None
    resume_length: int = 0
    admit_seq: int = -1
    # sampling: temperature 0 = greedy, top_k 0 = no truncation, seed
    # None = the request id
    temperature: float = 0.0
    top_k: int = 0
    seed: Optional[int] = None
    trace: Optional[object] = dataclasses.field(default=None, repr=False)
    # a KV-transfer ingest's payload (host pages, logical ids, length,
    # prompt hashes), landed in the pool when the request is admitted
    ingest: Optional[dict] = dataclasses.field(default=None, repr=False)
    # the admit-to-retire ``serve.decode`` span of a traced request
    span: Optional[object] = dataclasses.field(default=None, repr=False)
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def finished(self) -> bool:
        return self._done.is_set()

    def result(self) -> Dict:
        out = {
            "id": self.id,
            "status": self.status,
            "tokens": list(self.out_tokens),
            "prompt_len": int(self.prompt.size),
            "ttft_ms": round(self.ttft_ms, 3),
            "gen_ms": round(self.gen_ms, 3),
        }
        if self.trace is not None:
            out["trace_id"] = self.trace.trace_id
        return out

    def end_span(self, **tags) -> None:
        """Close the ``serve.decode`` span, if one is open."""
        if self.span is not None:
            self.span.end(**tags)
            self.span = None


class ContinuousBatcher:
    """Single decode-thread scheduler over an InferenceEngine."""

    def __init__(
        self,
        engine,
        *,
        max_admit_per_step: int = 4,
        default_max_new_tokens: int = 64,
        default_deadline_ms: float = 0.0,
        eos_id: Optional[int] = None,
        recorder: Optional[LatencyRecorder] = None,
        role: str = "unified",
    ) -> None:
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"unknown serve role {role!r}")
        if role != "unified" and not engine.paged:
            raise ValueError(
                "prefill/decode roles need the paged KV plane: the "
                "transfer wire moves pool pages, not slab slots"
            )
        self.engine = engine
        self.role = role
        # the TransferCoordinator of a prefill worker (serve() wires it);
        # None: every request decodes here
        self.transfer = None
        self._handoffs = 0  # requests streamed out, result not back yet
        self._drain_active = False  # a drain() loop is stepping
        self.max_admit_per_step = max(int(max_admit_per_step), 1)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.default_deadline_ms = float(default_deadline_ms)
        self.eos_id = eos_id
        self.recorder = recorder or LatencyRecorder()
        self._ids = itertools.count()
        self._admit_ids = itertools.count()
        self._cond = threading.Condition()
        self._queue: "deque[Request]" = deque()
        self._slot_req: Dict[int, Request] = {}
        self._draining = False
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._decode_steps = 0
        self._last_publish = 0.0

    # ------------------------------------------------------------ submission

    def submit(
        self,
        prompt,
        max_new_tokens: Optional[int] = None,
        deadline_ms: Optional[float] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: Optional[int] = None,
        trace=None,
    ) -> Request:
        if self.role == "decode":
            _metrics.counter("serve.rejected")
            raise Rejected(
                "decode-role worker takes KV transfers, not prompts"
            )
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            _metrics.counter("serve.rejected")
            raise Rejected("empty prompt")
        max_new = (
            self.default_max_new_tokens
            if max_new_tokens is None
            else int(max_new_tokens)
        )
        # the generation must fit the slot: clamp, and reject prompts
        # that leave no room for even the first token
        max_new = min(max_new, self.engine.max_len - int(prompt.size))
        if max_new < 1:
            _metrics.counter("serve.rejected")
            raise Rejected(
                f"prompt of {prompt.size} tokens leaves no room in a "
                f"{self.engine.max_len}-token KV slot"
            )
        if self.engine.paged:
            mgr = self.engine.manager
            worst = mgr.pages_needed(int(prompt.size) + max_new)
            if worst > mgr.num_pages:
                _metrics.counter("serve.rejected")
                raise Rejected(
                    f"request needs {worst} KV pages but the pool has "
                    f"only {mgr.num_pages}"
                )
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        req = Request(
            id=next(self._ids),
            prompt=prompt,
            max_new_tokens=max_new,
            deadline_ts=(
                time.monotonic() + deadline_ms / 1e3
                if deadline_ms and deadline_ms > 0
                else None
            ),
            temperature=float(temperature),
            top_k=int(top_k),
            seed=seed,
            trace=trace,
        )
        with self._cond:
            # drain check and enqueue under one lock: a submit racing
            # the drain is either served or rejected, never lost
            if self._draining:
                _metrics.counter("serve.rejected")
                raise Rejected("worker is draining (shutdown in progress)")
            self._queue.append(req)
            self._cond.notify_all()
        _metrics.counter("serve.requests_total")
        self._publish_gauges()
        return req

    # ------------------------------------------------- transfer plane hooks

    def submit_ingested(
        self,
        prompt,
        first_token: int,
        max_new_tokens: int,
        logical,
        arrays,
        length: int,
        hashes=(),
        deadline_ms: Optional[float] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: Optional[int] = None,
        trace=None,
    ) -> Request:
        """Admit a KV-transferred request (the decode worker's side of
        ``serving/kv_transfer.py``). Called from an HTTP thread: only
        host bookkeeping here; the pages land in the pool at admission,
        on the scheduler thread. The remote prefill emitted the first
        token, so ``out_tokens`` starts with it."""
        if not self.engine.paged:
            raise Rejected("KV ingest needs the paged plane")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pages = [int(lp) for lp in logical]
        if len(pages) > self.engine.manager.num_pages:
            _metrics.counter("serve.rejected")
            raise Rejected(
                f"ingest of {len(pages)} pages exceeds the "
                f"{self.engine.manager.num_pages}-page pool"
            )
        req = Request(
            id=next(self._ids),
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            deadline_ts=(
                time.monotonic() + float(deadline_ms) / 1e3
                if deadline_ms and float(deadline_ms) > 0
                else None
            ),
            temperature=float(temperature),
            top_k=int(top_k),
            seed=seed,
            trace=trace,
        )
        req.out_tokens.append(int(first_token))
        req.ingest = {"logical": pages, "arrays": arrays,
                      "length": int(length), "hashes": list(hashes)}
        with self._cond:
            if self._draining:
                _metrics.counter("serve.rejected")
                raise Rejected("worker is draining (shutdown in progress)")
            self._queue.append(req)
            self._cond.notify_all()
        _metrics.counter("serve.requests_total")
        self._publish_gauges()
        return req

    def submit_migrated(
        self,
        prompt,
        tokens,
        max_new_tokens: int,
        logical,
        arrays,
        length: int,
        deadline_ms: Optional[float] = None,
        sample: Optional[dict] = None,
        trace=None,
    ) -> Request:
        """Admit a live-migrated sequence (the ``migrate`` frame of
        ``serving/kv_transfer.py``). It arrives mid-decode: its whole
        generated history seeds ``out_tokens`` (the newest token, whose
        k/v is not in the pages, feeds the next decode step, so
        ``length`` is prompt + generated − 1), and ``sample`` is the
        sender's armed sampling state with its generator's raw state,
        so a sampled sequence draws on where it stopped. No prefix is
        published: the pages hold generated tokens. Called from an HTTP
        thread: host bookkeeping only."""
        if not self.engine.paged:
            raise Rejected("migration needs the paged plane")
        toks = [int(t) for t in tokens]
        if not toks:
            raise Rejected("migrated sequence carries no tokens")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pages = [int(lp) for lp in logical]
        if len(pages) > self.engine.manager.num_pages:
            _metrics.counter("serve.rejected")
            raise Rejected(
                f"migration of {len(pages)} pages exceeds the "
                f"{self.engine.manager.num_pages}-page pool"
            )
        req = Request(
            id=next(self._ids),
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            deadline_ts=(
                time.monotonic() + float(deadline_ms) / 1e3
                if deadline_ms and float(deadline_ms) > 0
                else None
            ),
            trace=trace,
        )
        req.out_tokens.extend(toks)
        req.ingest = {"logical": pages, "arrays": arrays,
                      "length": int(length), "hashes": [],
                      "sample": sample}
        with self._cond:
            if self._draining:
                _metrics.counter("serve.rejected")
                raise Rejected("worker is draining (shutdown in progress)")
            self._queue.append(req)
            self._cond.notify_all()
        _metrics.counter("serve.requests_total")
        self._publish_gauges()
        return req

    def requeue_fallback(self, req: Request, kept, length: int) -> None:
        """The transfer failed after the prefill (retries exhausted, or
        the decode worker answered with an error status): bring the
        request home. Its pages are still held, so it re-queues paused
        at the front for a pointer resume and a local decode, even while
        draining (it was accepted). Called from the handoff thread."""
        req.kept_pages = kept
        req.resume_length = int(length)
        req.paused = True
        req.status = QUEUED
        with self._cond:
            self._handoffs -= 1
            if (self._draining and not self._drain_active
                    and not self._running and self._thread is None):
                # nothing will ever serve the queue: fail loudly
                req.kept_pages = None
                self.engine.manager.release_kept(kept)
                req.status = ERROR
                req.end_span(outcome="error")
                req._done.set()
                _metrics.counter("serve.errored")
                return
            self._queue.appendleft(req)
            self._cond.notify_all()
        _metrics.counter("serve.transfer_fallbacks")
        _log.info(
            "request %d fell back to local decode after transfer failure",
            req.id,
        )

    def fail_handoff(self, req: Request, kept) -> None:
        """Packing the pages failed on this worker (a kernel's fault,
        not the wire's): the request fails with status ``error`` and its
        pages go; no local decode hides the fault. Called from the
        handoff thread, which raises the error on."""
        self.engine.manager.release_kept(kept)
        req.status = ERROR
        with self._cond:
            self._handoffs -= 1
            self._cond.notify_all()
        req.end_span(outcome="error")
        req._done.set()
        _metrics.counter("serve.errored")

    def complete_handoff(self, req: Request, result: Dict) -> None:
        """The remote decode finished: take the decode worker's output
        and release the waiter. TTFT stays the one measured here (the
        client's clock); ``gen_ms`` is the decode worker's. Called from
        the handoff thread."""
        req.out_tokens = [int(t) for t in result.get("tokens", ())]
        req.gen_ms = float(result.get("gen_ms", 0.0))
        req.status = DONE if result.get("status") == "done" else DEADLINE
        with self._cond:
            self._handoffs -= 1
            self._cond.notify_all()
        if req.status == DONE:
            _metrics.counter("serve.completed")
        else:
            _metrics.counter("serve.expired")
        _metrics.counter("serve.handed_off")
        req.end_span(outcome=req.status, tokens=len(req.out_tokens))
        req._done.set()

    # ------------------------------------------------------------- the loop

    def start(self) -> None:
        if self._thread is not None:
            return
        self._running = True
        self._thread = threading.Thread(
            target=self._run, name="hvd-serve-batcher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def drain(self, timeout: float = 30.0,
              migrate_after: Optional[float] = None,
              on_deadline=None) -> bool:
        """Stop admitting new submissions; run everything accepted to
        completion. True when the plane is empty. Without a running
        loop the drain steps inline.

        With ``migrate_after`` (seconds) and an ``on_deadline`` hook,
        the sequences still in flight past that point are exported
        (:meth:`export_inflight`) and handed to the hook, the frontend's
        live migration. The records count as handoffs, so the drain
        waits until each one's remote result lands or its fallback,
        requeued here, is stepped to its end."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        start = time.monotonic()
        deadline = start + timeout
        migrate_at = (start + max(float(migrate_after), 0.0)
                      if migrate_after is not None and on_deadline is not None
                      else None)
        self._drain_active = True
        try:
            while time.monotonic() < deadline:
                if self._idle():
                    return True
                if migrate_at is not None and time.monotonic() >= migrate_at:
                    migrate_at = None
                    if self._slot_req:
                        records = self.export_inflight()
                        _log.info("drain deadline: migrating %d in-flight "
                                  "sequence(s)", len(records))
                        on_deadline(records)
                    continue
                if self._running:
                    time.sleep(0.005)
                elif not self.step():
                    # idle but handoffs in flight: they finish (or fall
                    # back into the queue) on their own threads
                    time.sleep(0.005)
            return self._idle()
        finally:
            self._drain_active = False

    def export_inflight(self) -> List[dict]:
        """Detach every in-flight sequence for live migration. Stops the
        scheduler loop first, so the calling thread is the one consumer
        from here on; then, a slot at a time, snapshots the slot's armed
        sampling state (before the detach: the generator's raw state
        mid-stream), detaches its pages with their references, and
        counts the record as a handoff, so :meth:`drain` waits for its
        remote result or its fallback. Records: ``{"req", "kept",
        "length", "sample"}``."""
        self.stop()
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        records: List[dict] = []
        for slot in sorted(self._slot_req):
            req = self._slot_req.pop(slot)
            sample = self.engine.export_sampling(slot)
            kept, length = self.engine.manager.detach_keep(slot)
            self.engine.clear_sampling(slot)
            records.append({"req": req, "kept": kept, "length": length,
                            "sample": sample})
        with self._cond:
            self._handoffs += len(records)
        self._publish_gauges(min_interval=0.0)
        return records

    def _idle(self) -> bool:
        # under the lock: an admission moves its request from the queue
        # to a slot (or a handoff) in one critical section, so it is
        # always in one
        with self._cond:
            return (not self._queue and not self._slot_req
                    and not self._handoffs)

    def _run(self) -> None:
        try:
            if self.engine.device.type == "cuda":
                torch.cuda.set_device(self.engine.device)
            while True:
                with self._cond:
                    if not self._running:
                        return
                if not self.step():
                    with self._cond:
                        if self._running and not self._queue:
                            self._cond.wait(timeout=0.02)
        except Exception:
            # the scheduler thread must never die silently: abort
            # everything accepted (waiters unblock with status "error"),
            # refuse new work, and report not-ok
            _log.exception("serve scheduler failed; aborting accepted requests")
            self._abort_all()
            with self._cond:
                self._draining = True
                self._running = False

    def _abort_all(self) -> None:
        """Fail every queued and in-flight request (status ``error``)."""
        with self._cond:
            failed = list(self._queue)
            self._queue.clear()
        for slot in list(self._slot_req):
            req = self._slot_req.pop(slot)
            self.engine.manager.free(slot)
            failed.append(req)
        for req in failed:
            if req.kept_pages:
                self.engine.manager.release_kept(req.kept_pages)
                req.kept_pages = None
            req.status = ERROR
            req.end_span(outcome="error")
            req._done.set()
            _metrics.counter("serve.errored")
        self._publish_gauges(min_interval=0.0)

    # ------------------------------------------------------------- one step

    def step(self) -> bool:
        """One round: expire → admit → decode → retire. False when there
        was nothing to do. The ``serve.worker_kill`` fault site fires
        first: a transport kind raises into the loop's crash handler,
        ``kill`` SIGKILLs the worker."""
        _chaos.inject("serve.worker_kill")
        now = time.monotonic()
        self._expire_queued(now)
        admitted = self._admit(now)
        stepped = self._decode(now)
        self._publish_gauges()
        return bool(admitted or stepped)

    def _expire_queued(self, now: float) -> None:
        with self._cond:
            keep: "deque[Request]" = deque()
            expired = []
            for req in self._queue:
                if req.deadline_ts is not None and now >= req.deadline_ts:
                    expired.append(req)
                else:
                    keep.append(req)
            self._queue = keep
        for req in expired:
            if req.kept_pages:
                self.engine.manager.release_kept(req.kept_pages)
                req.kept_pages = None
            req.status = DEADLINE
            req._done.set()
            _metrics.counter("serve.expired")

    def _resume_seq(self, req: Request) -> np.ndarray:
        """What a page-dropped paused request re-prefills: the prompt and
        every generated token but the newest, which the next decode step
        feeds."""
        return np.concatenate(
            [req.prompt, np.asarray(req.out_tokens[:-1], np.int32)]
        )

    def _admission_pages_needed(self, req: Request) -> int:
        mgr = self.engine.manager
        if req.kept_pages is not None:
            return 0
        if req.ingest is not None:
            return len(req.ingest["logical"])
        if req.paused and req.out_tokens:
            return mgr.pages_needed(self._resume_seq(req).size)
        return mgr.pages_needed(int(req.prompt.size))

    def _admit(self, now: float) -> int:
        admitted = 0
        mid_decode = bool(self._slot_req)
        while admitted < self.max_admit_per_step:
            with self._cond:
                if not self._queue:
                    break
                req = self._queue[0]
            if self.engine.paged and (
                self._admission_pages_needed(req)
                > self.engine.manager.admission_headroom()
            ):
                break  # the watermark's pages belong to in-flight decodes
            slot = self.engine.manager.alloc(req.id)
            if slot is None:
                break
            # req stays at the queue head until it holds its slot, so a
            # drain never sees the plane empty while it is in prefill
            req.admit_seq = next(self._admit_ids)
            sample_armed = False
            if req.kept_pages is not None:
                # resume from pause: pointer re-attach, no prefill
                self.engine.manager.reattach(
                    slot, req.kept_pages, req.resume_length
                )
                req.kept_pages = None
                req.paused = False
                req.status = RUNNING
                _metrics.counter("serve.resumed")
            elif req.ingest is not None:
                # KV-transfer ingest or migration: the foreign pages land
                # in the pool in place and pointer-attach; data changes,
                # shapes do not, so the captured decode graph serves
                # every one
                ing = req.ingest
                kept = self.engine.ingest_attach(
                    slot, ing["logical"], ing["arrays"], ing["length"],
                    ing["hashes"],
                )
                if kept is None:
                    # the pool ran dry between the gate and the alloc:
                    # the head stays queued; stop admitting this round
                    self.engine.manager.free(slot)
                    break
                if ing.get("sample"):
                    # a migrated resume: the sender's sampling state as
                    # it stood (arming below would re-seed and fork it)
                    self.engine.import_sampling(slot, ing["sample"])
                    sample_armed = True
                npages = len(ing["logical"])
                req.ingest = None
                req.status = RUNNING
                _metrics.counter("serve.transfer_admits")
                _metrics.counter("serve.tokens_out")
                if req.trace is not None:
                    s = _tracing.start_span(
                        "serve.ingest_admit", req.trace, pages=npages,
                        slot=slot, migrated=sample_armed,
                    )
                    if s is not None:
                        s.end()
            elif req.paused and req.out_tokens:
                # pages reclaimed while paused: re-prefill; the token it
                # emits is dropped, the newest real token feeds decode
                self.engine.prefill(slot, self._resume_seq(req),
                                    trace=req.trace)
                req.paused = False
                req.status = RUNNING
                _metrics.counter("serve.resumed")
            else:
                reservation = None
                if (self.role == "prefill" and self.transfer is not None
                        and req.max_new_tokens > 1):
                    # reserve decode capacity before spending the
                    # prefill: pages with nowhere to go are work wasted
                    need = self.engine.manager.pages_needed(
                        int(req.prompt.size) + req.max_new_tokens
                    )
                    reservation = self.transfer.reserve(need,
                                                        trace=req.trace)
                    if reservation is None:
                        # no decode capacity anywhere: decode here
                        _metrics.counter("serve.transfer_local")
                span = _tracing.start_span(
                    "serve.prefill", req.trace,
                    prompt_len=int(req.prompt.size), slot=slot,
                )
                first = self.engine.prefill(slot, req.prompt,
                                            trace=req.trace)
                req.status = RUNNING
                req.ttft_ms = (time.monotonic() - req.submitted) * 1e3
                req.out_tokens.append(int(first))
                if span is not None:
                    span.end(ttft_ms=round(req.ttft_ms, 3))
                self.recorder.record_ttft(req.ttft_ms)
                _metrics.counter("serve.prefill_tokens", int(req.prompt.size))
                _metrics.counter("serve.tokens_out")
                if reservation is not None:
                    # hand the finished pages over: detach_keep frees the
                    # slot (its references move to the handoff); the
                    # stream and the result wait run on a thread of
                    # their own, and this worker never decodes it
                    kept, length = self.engine.manager.detach_keep(slot)
                    with self._cond:
                        self._queue.popleft()  # single consumer: req
                        self._handoffs += 1
                    self.transfer.start_handoff(self, req, kept, length,
                                                reservation)
                    admitted += 1
                    continue
            if mid_decode:
                _metrics.counter("serve.admitted_mid_decode")
            admitted += 1
            if sample_armed:
                pass
            elif req.temperature > 0 or req.top_k > 0:
                self.engine.set_sampling(
                    slot, req.temperature, req.top_k,
                    seed=req.id if req.seed is None else req.seed,
                )
            else:
                self.engine.clear_sampling(slot)
            if req.trace is not None and req.span is None:
                # admit→retire: opened once (a pause keeps it open),
                # closed at retire or abort; no work per decode step
                req.span = _tracing.start_span("serve.decode", req.trace,
                                               slot=slot)
            with self._cond:
                self._queue.popleft()  # single consumer: still req
                self._slot_req[slot] = req
            if self._req_complete(req, now):
                self._retire(slot, req)
        return admitted

    def _pause_youngest(self, now: float) -> bool:
        """Pool exhaustion: take the youngest running request out of its
        slot and re-queue it at the front, keeping its pages. One past
        its deadline expires instead. False when there is no second
        request to pause."""
        if len(self._slot_req) < 2:
            return False
        slot, req = max(
            self._slot_req.items(), key=lambda kv: kv[1].admit_seq
        )
        self._slot_req.pop(slot)
        mgr = self.engine.manager
        if req.deadline_ts is not None and now >= req.deadline_ts:
            mgr.free(slot)
            req.status = DEADLINE
            req.end_span(outcome=DEADLINE, tokens=len(req.out_tokens))
            req._done.set()
            _metrics.counter("serve.expired")
            return True
        req.kept_pages, req.resume_length = mgr.detach_keep(slot)
        req.paused = True
        req.status = QUEUED
        with self._cond:
            self._queue.appendleft(req)
        _metrics.counter("serve.paused")
        _log.debug(
            "page pool exhausted: paused request %d (kept %d pages)",
            req.id, len(req.kept_pages),
        )
        return True

    def _reclaim_paused_pages(self) -> bool:
        """Last resort: drop the kept pages of the paused request with the
        least deadline headroom (no deadline is spared longest). It stays
        queued and re-prefills on resume. Never on a decode worker: it
        cannot prefill, so its kept pages could not be rebuilt, and a
        pause (a pointer resume) is its only remedy."""
        if self.role == "decode":
            return False
        with self._cond:
            holders = [r for r in self._queue if r.kept_pages]
        if not holders:
            return False
        victim = min(
            holders,
            key=lambda r: (
                r.deadline_ts is None,
                r.deadline_ts if r.deadline_ts is not None else 0.0,
            ),
        )
        self.engine.manager.release_kept(victim.kept_pages)
        victim.kept_pages = None
        _metrics.counter("serve.paused_pages_reclaimed")
        return True

    def _make_decodable(self, now: float) -> None:
        """Sweep pages until every remaining slot can take its next
        token, pausing (then reclaiming) as needed."""
        for _ in range(self.engine.slots + len(self._queue) + 2):
            if not self.engine.prepare_decode():
                return
            if self._pause_youngest(now):
                continue
            if self._reclaim_paused_pages():
                continue
            raise PagePoolExhausted(list(self.engine.prepare_decode()))

    def _decode(self, now: float) -> bool:
        if not self._slot_req:
            return False
        if self.engine.paged:
            self._make_decodable(now)
            if not self._slot_req:
                return False
        tokens = np.zeros(self.engine.slots, np.int32)
        for slot, req in self._slot_req.items():
            tokens[slot] = req.out_tokens[-1]
        t0 = time.monotonic()
        nxt = self.engine.decode_step(tokens)
        step_ms = (time.monotonic() - t0) * 1e3
        self._decode_steps += 1
        now = time.monotonic()
        for slot, req in list(self._slot_req.items()):
            self.engine.manager.advance(slot)
            req.out_tokens.append(int(nxt[slot]))
            req.gen_ms = (now - req.submitted) * 1e3 - req.ttft_ms
            self.recorder.record_tpot(step_ms)
            _metrics.counter("serve.tokens_out")
            if self._req_complete(req, now):
                self._retire(slot, req)
        return True

    def _req_complete(self, req: Request, now: float) -> bool:
        if req.deadline_ts is not None and now >= req.deadline_ts:
            req.status = DEADLINE
            return True
        if len(req.out_tokens) >= req.max_new_tokens:
            return True
        if self.eos_id is not None and req.out_tokens[-1] == self.eos_id:
            return True
        return False

    def _retire(self, slot: int, req: Request) -> None:
        self.engine.manager.free(slot)
        self.engine.clear_sampling(slot)
        self._slot_req.pop(slot, None)
        if req.status == DEADLINE:
            _metrics.counter("serve.expired")
        else:
            req.status = DONE
            _metrics.counter("serve.completed")
        req.end_span(outcome=req.status, tokens=len(req.out_tokens))
        req._done.set()

    # --------------------------------------------------------------- stats

    @property
    def draining(self) -> bool:
        """True once no new work is accepted: set by drain() or by the
        scheduler-crash handler."""
        return self._draining

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def stats(self) -> Dict[str, float]:
        out = {
            "queue_depth": self.queue_depth(),
            "decode_steps": self._decode_steps,
            "draining": 1.0 if self._draining else 0.0,
            "handoffs_inflight": float(self._handoffs),
        }
        out.update(self.engine.manager.stats())
        return out

    def _publish_gauges(self, min_interval: float = 0.25) -> None:
        """Registry gauge refresh, rate-limited off the decode hot path."""
        now = time.monotonic()
        if now - self._last_publish < min_interval:
            return
        self._last_publish = now
        _metrics.update("serve", self.stats())
        self.engine.publish()
        self.recorder.publish()
