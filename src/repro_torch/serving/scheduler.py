"""Stage-level continuous-batching scheduler (port of the stage-forming core
of ``repro/serving/scheduler.py``).

``next_stage`` forms the next stage as one unified token stream: every
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
position, and its first span starts there. Shedding, the deadline sweep,
aging, drafts and the async plan/activate split are not ported yet.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

from repro_torch.core.opb import StageMix
from repro_torch.serving.request import Request, RequestState


@dataclass
class ChunkSpan:
    """One stage's slice [start, end) of one request's prefill. ``first``
    marks the admission chunk (it claims a KV slot); ``target`` is the
    prefill target frozen into the request at admission."""
    req: Request
    start: int
    end: int
    first: bool = False
    target: Optional[int] = None

    @property
    def tokens(self) -> int:
        return self.end - self.start

    @property
    def is_last(self) -> bool:
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
            chunk_spans=tuple((c.start, c.end) for c in self.chunks))


class ContinuousBatchingScheduler:
    def __init__(self, *, max_prefill_seqs: int, prefill_chunk_tokens: Optional[int],
                 max_prefill_target: int, max_prefill_tokens: int):
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError(f"prefill_chunk_tokens must be >= 1, got {prefill_chunk_tokens}")
        self.max_prefill_target = max_prefill_target   # the KV capacity
        self.queue: Deque[Request] = deque()
        self.running: List[Request] = []
        self.prefilling: List[Request] = []
        self.max_prefill_seqs = max_prefill_seqs
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.max_prefill_tokens = max_prefill_tokens
        self._submit_seq = 0

    def submit(self, req: Request) -> None:
        """Enqueue ``req`` ahead of strictly lower-priority queued work and
        behind its own priority band."""
        self._submit_seq += 1
        req.queue_seq = self._submit_seq
        idx = next((i for i, r in enumerate(self.queue) if r.priority < req.priority),
                   None)
        if idx is None:
            self.queue.append(req)
        else:
            self.queue.insert(idx, req)

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
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.running) or bool(self.prefilling)

    def next_stage(self, free_slots: int) -> Optional[StageDecision]:
        """Form the next stage and admit its new requests."""
        chunks: List[ChunkSpan] = []
        restored: List[Request] = []
        chunked = self.prefill_chunk_tokens is not None
        budget = self.prefill_chunk_tokens if chunked else self.max_prefill_tokens
        used = 0
        for r in self.prefilling:          # in-flight prefills continue first
            if len(chunks) >= self.max_prefill_seqs or used >= budget:
                break
            n = min(r.prefill_total - r.prefill_pos, budget - used)
            if n <= 0:
                continue
            chunks.append(ChunkSpan(r, r.prefill_pos, r.prefill_pos + n))
            used += n
        free = free_slots
        for r in self.queue:               # the head blocks everything behind it
            if free <= 0:
                break
            if r.saved_cache is not None:  # migrated back: a slot, no prefill
                restored.append(r)
                free -= 1
                continue
            if len(chunks) >= self.max_prefill_seqs:
                break
            total = min(len(r.prompt) + len(r.output), self.max_prefill_target)
            start = min(r.prefill_pos, total - 1) if total > 0 else 0
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
        decoding = [r for r in self.running if r.state == RequestState.DECODE]
        if not chunks and not decoding and not restored:
            return None
        for c in chunks:                   # admission
            if c.first:
                self.queue.remove(c.req)
                c.req.prefill_target = c.target
                c.req.state = RequestState.PREFILL
        for r in restored:
            self.queue.remove(r)
        return StageDecision(chunks, decoding, restored)

    def commit_stage(self, decision: StageDecision) -> None:
        """After the engine ran the stage: advance chunk positions, promote
        finished prefills to decode, retire completed requests."""
        for c in decision.chunks:
            r = c.req
            r.prefill_pos = c.end
            if r.prefill_done:
                if r in self.prefilling:
                    self.prefilling.remove(r)
                if not r.done:
                    r.state = RequestState.DECODE
                self.running.append(r)
            elif r not in self.prefilling:
                self.prefilling.append(r)
        for r in decision.restored:
            if not r.done:
                r.state = RequestState.DECODE
            self.running.append(r)
        self.running = [r for r in self.running if not r.done]
