"""Stage-level continuous-batching scheduler (port of the stage-forming core
of ``repro/serving/scheduler.py``).

``plan_stage`` forms the next stage as one unified token stream: every
decoding request contributes one token, and prefill work comes as chunk
spans — in-flight chunked prefills continue first (FIFO), then queued
prompts are admitted into free slots, within ``prefill_chunk_tokens`` per
stage and at most ``max_prefill_seqs`` spans. With ``prefill_chunk_tokens``
None each admitted prompt comes as one whole-prompt span, within a
``max_prefill_tokens`` budget per stage (a single over-budget prompt still
runs alone). The composition rules are the reference's, step for step: the
stage composition decides the bucketed shapes, the MoE capacities and
therefore which tokens an expert drops. A queued request admits ahead of
lower priorities; a preempted one re-enters just behind the queue head, and
a migrated one (its cache saved on the host) comes back as a ``restored``
admission that takes a slot and no prefill tokens. With prefix sharing the
engine moves a queued request's ``prefill_pos`` to its first unshared
position, and its first span starts there.

Overload: the admission queue may be bounded (``queue_cap``); when a submit
finds it full, ``overload_policy`` decides: ``reject`` raises a typed
:class:`AdmissionRejected`, ``shed-oldest`` drops the oldest request of the
lowest priority band, ``shed-past-deadline`` drops a queued request already
past its deadline (and rejects when the queue is full of live work).
``sweep_expired`` is the per-stage expiry sweep. With ``aging_rounds=K`` a
queued request's effective priority rises by one band per K stages formed
while it waits, so a starved low band eventually admits. The scheduler
only reorganises its own structures; the engine releases the slots, pages
and pins of the requests these paths return.

Stage formation is split for the async loop: ``plan_stage`` is pure (it
reads state, mutates nothing, and takes projected ``prefilling`` /
``running`` / ``queue`` / ``pos`` overrides, so the engine can plan stage
N+1 against the predicted post-commit state of the in-flight stage N), and
``activate`` makes a plan real (purges terminal queued requests, pops the
admissions, freezes their prefill targets, ages the queue). ``next_stage``
composes the two. With speculative decoding the engine passes ``drafts``:
each drafted decode row leaves the decode set and rides as a verify span
after the prefill chunks, outside their row and token budgets.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.opb import StageMix
from repro_torch.serving.request import Request, RequestState

OVERLOAD_POLICIES = ("reject", "shed-oldest", "shed-past-deadline")


class AdmissionRejected(RuntimeError):
    """Typed admission failure: the bounded queue is full (of live work,
    under ``shed-past-deadline``); carries what a client needs to back off."""

    def __init__(self, rid: int, queue_depth: int, queue_cap: int, policy: str):
        super().__init__(
            f"request {rid} rejected: admission queue full "
            f"({queue_depth}/{queue_cap} queued, policy={policy})")
        self.rid = rid
        self.queue_depth = queue_depth
        self.queue_cap = queue_cap
        self.policy = policy


@dataclass
class ChunkSpan:
    """One stage's slice [start, end) of one request's prefill. ``first``
    marks the admission chunk (it claims a KV slot); ``target`` is the
    prefill target frozen into the request at admission.

    With ``draft`` set the span is a speculative verify span of a decoding
    request: positions [start, end) take its last sampled token and then the
    draft (``end - start == len(draft) + 1``), and the engine's commit keeps
    the longest prefix the verifier agrees with. A verify span claims no
    slot, samples no first token and is skipped by ``commit_stage``."""
    req: Request
    start: int
    end: int
    first: bool = False
    target: Optional[int] = None
    draft: Optional[List[int]] = None

    @property
    def tokens(self) -> int:
        return self.end - self.start

    @property
    def is_first(self) -> bool:
        return self.draft is None and (self.first or self.start == 0)

    @property
    def is_last(self) -> bool:
        if self.draft is not None:
            return False
        total = self.target if self.target is not None else self.req.prefill_total
        return self.end >= total


@dataclass
class StageDecision:
    chunks: List[ChunkSpan]
    decoding: List[Request]
    # migrated requests coming back: a slot and their saved cache, no prefill
    restored: List[Request] = field(default_factory=list)

    @property
    def is_mixed(self) -> bool:
        return len(self.chunks) > 0

    def mix(self) -> StageMix:
        return StageMix(
            decode_ctx=tuple(r.l_in + len(r.output) for r in self.decoding),
            chunk_spans=tuple((c.start, c.end) for c in self.chunks if c.draft is None),
            spec_spans=tuple((c.start, c.end) for c in self.chunks if c.draft is not None))


class ContinuousBatchingScheduler:
    def __init__(self, *, max_prefill_seqs: int = 4,
                 prefill_chunk_tokens: Optional[int] = None,
                 max_prefill_target: Optional[int] = None,
                 max_prefill_tokens: int = 8192, queue_cap: Optional[int] = None,
                 overload_policy: str = "reject", aging_rounds: Optional[int] = None):
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError(f"prefill_chunk_tokens must be >= 1, got {prefill_chunk_tokens}")
        if overload_policy not in OVERLOAD_POLICIES:
            raise ValueError(f"overload_policy must be one of {OVERLOAD_POLICIES}, "
                             f"got {overload_policy!r}")
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        if aging_rounds is not None and aging_rounds < 1:
            raise ValueError(f"aging_rounds must be >= 1, got {aging_rounds}")
        self.queue_cap = queue_cap
        self.overload_policy = overload_policy
        self.aging_rounds = aging_rounds
        self.aging_promotions = 0
        self.shed_count = 0
        self.max_prefill_target = max_prefill_target   # the KV capacity
        self.queue: Deque[Request] = deque()
        self.running: List[Request] = []
        self.prefilling: List[Request] = []
        self.max_prefill_seqs = max_prefill_seqs
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.max_prefill_tokens = max_prefill_tokens
        self._submit_seq = 0
        self.stage_counts = {"mixed": 0, "decode_only": 0}

    def effective_priority(self, req: Request) -> int:
        """Admission priority after aging: the band plus one promotion per
        ``aging_rounds`` stages the request spent queued."""
        if self.aging_rounds is None:
            return req.priority
        return req.priority + req.aging_skips // self.aging_rounds

    def submit(self, req: Request, *, now: float = 0.0) -> List[Request]:
        """Enqueue ``req`` ahead of strictly lower (effective) priorities and
        behind its own band. With a bounded queue the overload policy makes
        room first: returns the shed victims (the caller releases what they
        hold) or raises :class:`AdmissionRejected` when nothing may be
        shed."""
        shed: List[Request] = []
        if self.queue_cap is not None:
            while len(self.queue) >= self.queue_cap:
                victim = self._shed_victim(now)
                if victim is None:
                    raise AdmissionRejected(req.rid, len(self.queue), self.queue_cap,
                                            self.overload_policy)
                self.queue.remove(victim)
                self.shed_count += 1
                shed.append(victim)
        self._submit_seq += 1
        req.queue_seq = self._submit_seq
        eff = self.effective_priority(req)
        idx = next((i for i, r in enumerate(self.queue)
                    if self.effective_priority(r) < eff), None)
        if idx is None:
            self.queue.append(req)
        else:
            self.queue.insert(idx, req)
        return shed

    def _shed_victim(self, now: float) -> Optional[Request]:
        if self.overload_policy == "reject":
            return None
        if self.overload_policy == "shed-past-deadline":
            for r in self.queue:
                if r.past_deadline(now):
                    return r
            return None                  # full of live work: a typed reject
        # shed-oldest: the oldest request of the lowest priority band
        return min(self.queue, key=lambda r: (r.priority, r.arrival_time))

    def sweep_expired(self, now: float) -> List[Request]:
        """Per-stage expiry sweep: pull every queued, prefilling or running
        request past its deadline (or TTFT SLO) out and return them."""
        expired = [r for r in list(self.queue) + self.prefilling + self.running
                   if r.past_deadline(now)]
        for r in expired:
            self.remove(r)
        return expired

    def remove(self, req: Request) -> None:
        """Drop ``req`` from whichever structure holds it. Idempotent; the
        caller releases its resources."""
        try:
            self.queue.remove(req)
        except ValueError:
            pass
        if req in self.running:
            self.running.remove(req)
        if req in self.prefilling:
            self.prefilling.remove(req)

    def resubmit_preempted(self, req: Request) -> None:
        """A preempted request re-enters just behind the queue head (ahead of
        everything newer), to prefill from position 0 (or, migrated, to be
        restored)."""
        req.was_preempted = True
        req.prefill_pos = 0
        req.prefill_target = None
        self._submit_seq += 1
        req.queue_seq = -self._submit_seq
        if req in self.running:
            self.running.remove(req)
        if req in self.prefilling:
            self.prefilling.remove(req)
        if self.queue:
            head = self.queue.popleft()
            self.queue.appendleft(req)
            self.queue.appendleft(head)
        else:
            self.queue.appendleft(req)

    @property
    def pending(self) -> int:
        return len(self.queue)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.running) or bool(self.prefilling)

    def plan_stage(self, free_slots: int, *, prefilling: Optional[List[Request]] = None,
                   running: Optional[List[Request]] = None, queue=None,
                   pos: Optional[Dict[int, int]] = None,
                   drafts: Optional[Dict[int, Tuple[int, List[int]]]] = None
                   ) -> Optional[StageDecision]:
        """Form the next stage without mutating any scheduler or request
        state. The overrides replace the live ``prefilling`` list, decode
        set (taken verbatim: its members may still read PREFILL until the
        in-flight commit lands), queue and prefill positions (rid -> pos).
        ``drafts`` maps rid -> (start, proposed tokens): each such decode
        row leaves the decode set and rides as a verify span after the
        prefill chunks (the engine decides who may draft). A plan takes
        effect only through ``activate``."""
        prefill_src = self.prefilling if prefilling is None else prefilling
        queue_src = self.queue if queue is None else queue
        pos = pos or {}
        chunks: List[ChunkSpan] = []
        restored: List[Request] = []
        chunked = self.prefill_chunk_tokens is not None
        budget = self.prefill_chunk_tokens if chunked else self.max_prefill_tokens
        used = 0
        for r in prefill_src:              # in-flight prefills continue first
            if len(chunks) >= self.max_prefill_seqs or used >= budget:
                break
            p = pos.get(r.rid, r.prefill_pos)
            n = min(r.prefill_total - p, budget - used)
            if n <= 0:
                continue
            chunks.append(ChunkSpan(r, p, p + n))
            used += n
        free = free_slots
        for r in queue_src:                # the head blocks everything behind it
            if free <= 0:
                break
            if r.done:                     # cancelled or expired while queued
                continue
            if r.saved_cache is not None:  # migrated back: a slot, no prefill
                restored.append(r)
                free -= 1
                continue
            if len(chunks) >= self.max_prefill_seqs:
                break
            total = len(r.prompt) + len(r.output)
            if self.max_prefill_target is not None:
                total = min(total, self.max_prefill_target)
            p = pos.get(r.rid, r.prefill_pos)
            start = min(p, total - 1) if total > 0 else 0
            if chunked:
                if used >= budget:
                    break
                span = ChunkSpan(r, start, min(total, start + budget - used),
                                 first=True, target=total)
            else:
                if used + (total - start) > budget and used > 0:
                    break
                span = ChunkSpan(r, start, total, first=True, target=total)
            chunks.append(span)
            used += span.tokens
            free -= 1
        if running is None:
            decoding = [r for r in self.running if r.state == RequestState.DECODE]
        else:
            decoding = list(running)
        if drafts:
            # verify spans after the prefill chunks, outside their budgets:
            # decode work in a chunk span's shape
            undrafted = []
            for r in decoding:
                d = drafts.get(r.rid)
                if d is None:
                    undrafted.append(r)
                    continue
                start, toks = d
                chunks.append(ChunkSpan(r, start, start + len(toks) + 1, draft=list(toks)))
            decoding = undrafted
        if not chunks and not decoding and not restored:
            return None
        return StageDecision(chunks, decoding, restored)

    def _purge_done(self) -> None:
        if any(r.done for r in self.queue):
            self.queue = deque(r for r in self.queue if not r.done)

    def activate(self, decision: StageDecision) -> None:
        """Make a planned stage real: purge terminal queued requests, pop
        the admissions off the queue, freeze their prefill targets, move
        them to PREFILL and age the passed-over queue. Once per dispatched
        plan; a discarded plan is never activated."""
        self._purge_done()
        for c in decision.chunks:
            if not c.first:
                continue
            r = c.req
            try:
                self.queue.remove(r)
            except ValueError:
                pass
            if c.target is not None:
                r.prefill_target = c.target
            r.state = RequestState.PREFILL
        for r in decision.restored:
            try:
                self.queue.remove(r)
            except ValueError:
                pass
        if self.aging_rounds is not None and self.queue:
            # the passed-over queue ages; a promotion re-sorts it by
            # effective priority, FIFO (submit order) within a band
            promoted = False
            for r in self.queue:
                r.aging_skips += 1
                if r.aging_skips % self.aging_rounds == 0:
                    promoted = True
                    self.aging_promotions += 1
            if promoted:
                self.queue = deque(sorted(
                    self.queue, key=lambda r: (-self.effective_priority(r), r.queue_seq)))
        self.stage_counts["mixed" if decision.chunks else "decode_only"] += 1

    def next_stage(self, free_slots: int,
                   drafts: Optional[Dict[int, Tuple[int, List[int]]]] = None
                   ) -> Optional[StageDecision]:
        """Plan the next stage from live state and activate it; an empty
        plan still purges terminal queued requests, so ``has_work`` cannot
        stick on a dead queue."""
        decision = self.plan_stage(free_slots, drafts=drafts)
        if decision is None:
            self._purge_done()
            return None
        self.activate(decision)
        return decision

    def commit_stage(self, decision: StageDecision) -> None:
        """After the engine ran the stage: advance chunk positions, promote
        finished prefills to decode, retire completed requests."""
        for c in decision.chunks:
            if c.draft is not None:
                continue                 # a verify span: the engine's commit
            r = c.req
            r.prefill_pos = c.end
            if r.prefill_done:
                if r in self.prefilling:
                    self.prefilling.remove(r)
                if not r.done:
                    r.state = RequestState.DECODE
                self.running.append(r)
            elif r.done:
                # cancelled or expired while its stage was in flight:
                # ``remove`` already pulled it, do not bring it back
                if r in self.prefilling:
                    self.prefilling.remove(r)
            elif r not in self.prefilling:
                self.prefilling.append(r)
        for r in decision.restored:
            if not r.done:
                r.state = RequestState.DECODE
            self.running.append(r)
        self.running = [r for r in self.running if not r.done]
