"""A fault-tolerant fleet of serving engines (port of
``repro/serving/fleet.py``).

N ``ServingEngine`` replicas behind a router, where a dead replica is a
routed-around event, not a lost request:

  * **routing** (``serving/router.py``): round-robin, or prefix affinity
    over the token-keyed page index minus load;
  * **health state machine**, per replica: HEALTHY -> DEGRADED (an injected
    whole-replica latency spike; routed around, recovers after
    ``degrade_ticks`` ticks) -> DEAD (an injected or operator kill;
    permanent). Each replica draws its faults from its own forked injector
    stream (``FaultInjector.fork``), so one fleet seed reproduces every
    replica's schedule;
  * **failover**: a dead replica's live requests are reset to the
    recompute-replay shape (prompt plus the tokens already delivered
    prefill again; delivered output is never generated twice) and routed to
    survivors with a priority boost, under rid-keyed ownership, so each
    request ends exactly once. With ``failover=False`` they end "lost";
  * **drain, join and leave**: ``drain`` stops new work to a replica, lets
    its work finish and retires it, releasing its pool; ``join`` adds a
    fresh replica; ``leave`` is a drain;
  * **watchdog**: ``run`` folds each replica's ``stats(reset=True)``
    window into the fleet's ``counters`` (``poll``) and raises
    :class:`FleetStalledError` after ``stall_ticks`` ticks without
    fleet-wide progress.

The fleet is host-side and synchronous: one ``step`` is one tick across the
live replicas, each a ``step`` or, with ``async_steps``, a pipelined
``step_async``. On the card a killed replica's stage in flight is abandoned
with its engine, whose pool tensors go when the engine does; a retired
replica's pool is dropped with ``kv.cache = None``, and the caching
allocator reuses its memory only after the work already queued on the
stream, so no host sync is needed.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.router import Router, make_router
from repro_torch.serving.scheduler import AdmissionRejected


class ReplicaHealth(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"   # latency-spiking; routed around, recovers
    DEAD = "dead"           # permanent; failover has run


class FleetStalledError(RuntimeError):
    """The fleet watchdog: no replica advanced any request for
    ``stall_ticks`` ticks (every replica dead, a fleet-wide capacity
    livelock, or a fault schedule that never relents). The message carries
    each replica's health and queue depth and the window counters."""


class Replica:
    """One engine in the fleet: id, health state and its forked injector."""

    def __init__(self, rid: int, engine: ServingEngine,
                 injector: Optional[FaultInjector] = None):
        self.id = rid
        self.engine = engine
        self.injector = injector
        self.health = ReplicaHealth.HEALTHY
        self.draining = False
        self.spike_ticks = 0       # DEGRADED ticks remaining
        self.drain_clean: Optional[bool] = None   # set at retire time

    @property
    def load(self) -> int:
        """Queue depth plus in-flight work: the router's load signal."""
        sch = self.engine.scheduler
        return sch.pending + len(sch.prefilling) + len(sch.running)

    @property
    def degraded(self) -> bool:
        return self.health is ReplicaHealth.DEGRADED

    @property
    def dead(self) -> bool:
        return self.health is ReplicaHealth.DEAD

    @property
    def admittable(self) -> bool:
        """May the router send new work here? (A degraded replica stays in
        rotation; the router's score penalizes it.)"""
        return not self.dead and not self.draining

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Replica({self.id}, {self.health.value}, load={self.load}"
                f"{', draining' if self.draining else ''})")


class Fleet:
    """N ``ServingEngine`` replicas behind a router, with failover.

    ``engine_factory(replica_id, injector)`` builds each replica's engine;
    the fleet forks its injector per replica and passes the child in
    (factories of injector-free fleets ignore it). ``min_live`` suppresses
    an injected kill that would leave fewer live replicas (an orchestrator
    would respawn; the ``kill`` API is not suppressed). ``async_steps``
    ticks each replica with ``step_async``: reports lag a tick, and a killed
    replica drops its stage in flight with nothing durable advanced, so the
    exactly-once ledger is untouched.
    """

    def __init__(self, engine_factory, n_replicas: int, *,
                 router="affinity",
                 injector: Optional[FaultInjector] = None,
                 failover: bool = True, failover_priority: int = 1,
                 degrade_ticks: int = 2, min_live: int = 1,
                 async_steps: bool = False):
        assert n_replicas >= 1
        self.engine_factory = engine_factory
        self.injector = injector
        self.async_steps = async_steps
        self.router: Router = (router if isinstance(router, Router)
                               else make_router(router))
        self.failover = failover
        self.failover_priority = failover_priority
        self.degrade_ticks = degrade_ticks
        self.min_live = min_live
        self.replicas: List[Replica] = []      # live and dead
        self.retired: List[Replica] = []       # drained or left
        self._next_id = 0
        # the exactly-once ledger, keyed by rid: every request the fleet
        # accepted, its current owner and its terminal transition
        self._requests: Dict[int, Request] = {}
        self._owner: Dict[int, Replica] = {}
        self._terminal: Dict[int, tuple] = {}  # rid -> (replica_id, reason)
        self.kills = 0
        self.kills_suppressed = 0
        self.failovers = 0
        self.lost = 0
        self.rejected = 0
        self.duplicate_submits = 0     # exactly-once guard; must stay 0
        self.counters: Dict[str, int] = {}   # poll()-aggregated windows
        self.ticks = 0
        for _ in range(n_replicas):
            self.join()

    # ------------------------------------------------------------- elasticity
    def join(self) -> Replica:
        """Spawn a fresh replica into the rotation (scale up)."""
        i = self._next_id
        self._next_id += 1
        child = self.injector.fork(i) if self.injector is not None else None
        rep = Replica(i, self.engine_factory(i, child), child)
        self.replicas.append(rep)
        return rep

    def drain(self, replica_id: int) -> Replica:
        """Stop admitting new work to this replica; its queued and running
        requests finish normally, and it retires at the first tick it is
        idle."""
        rep = self._replica(replica_id)
        rep.draining = True
        return rep

    def leave(self, replica_id: int) -> Replica:
        """Scale down: drain now, retire at idle."""
        return self.drain(replica_id)

    def _replica(self, replica_id: int) -> Replica:
        for rep in self.replicas:
            if rep.id == replica_id:
                return rep
        raise KeyError(f"no live replica {replica_id}")

    @staticmethod
    def _idle(rep: Replica) -> bool:
        """Nothing queued, prefilling or running, and no stage in flight: a
        pipelined stage that admitted the last queued requests holds them
        outside the scheduler's lists until it commits (the reference checks
        the lists alone and retires such a replica with its requests)."""
        return not rep.engine.scheduler.has_work and rep.engine._inflight is None

    def _retire(self, rep: Replica) -> None:
        """A drained replica leaves: check that it drained clean and release
        its KV pool."""
        kv = rep.engine.kv
        rep.drain_clean = bool(
            kv.free_slots == kv.max_slots
            and (not kv.paged or kv.live_pages == 0)
            and not kv.audit())
        rep.engine.kv.cache = None           # release the page pool
        self.replicas.remove(rep)
        self.retired.append(rep)

    # -------------------------------------------------------------- admission
    @property
    def live(self) -> List[Replica]:
        return [rep for rep in self.replicas if not rep.dead]

    @property
    def admittable(self) -> List[Replica]:
        return [rep for rep in self.replicas if rep.admittable]

    def submit(self, req: Request, now: Optional[float] = None) -> Replica:
        """Route ``req`` to the best admittable replica (router order); a
        bounded queue's rejection falls through to the next. Raises
        AdmissionRejected only when every admittable replica rejected (or
        there is none)."""
        prev = self._owner.get(req.rid)
        if prev is not None and not prev.dead and not req.done:
            # exactly-once guard: this rid is live on a healthy replica
            self.duplicate_submits += 1
            raise ValueError(f"request {req.rid} is already live on replica {prev.id}")
        cands = self.admittable
        for rep in self.router.order(cands, req):
            try:
                rep.engine.submit(req, now=now)
            except AdmissionRejected:
                continue
            self._requests[req.rid] = req
            self._owner[req.rid] = rep
            return rep
        self.rejected += 1
        raise AdmissionRejected(req.rid, sum(r.load for r in cands), len(cands), "fleet")

    # --------------------------------------------------------------- failover
    def kill(self, replica_id: int, now: Optional[float] = None) -> Replica:
        """Kill a replica (an operator's or a test's; chaos runs draw kills
        from each replica's injector). Its engine is abandoned as it is (a
        dead device's pool is not unwound) and its live requests fail
        over."""
        rep = self._replica(replica_id)
        self._kill(rep, now)
        return rep

    def _kill(self, rep: Replica, now: Optional[float]) -> None:
        rep.health = ReplicaHealth.DEAD
        self.kills += 1
        self._harvest()
        victims = [r for r in rep.engine._requests.values() if not r.done]
        for r in victims:
            if self._owner.get(r.rid) is not rep:
                continue        # rid-keyed dedupe: already moved elsewhere
            if not self.failover:
                r.finish("lost", now if now is not None else 0.0)
                self.lost += 1
                continue
            self._resubmit_failover(r, now)
        self._harvest()

    def _resubmit_failover(self, r: Request, now: Optional[float]) -> None:
        """Reset a dead replica's request to the recompute-replay shape and
        route it again: prompt plus delivered tokens prefill on the
        survivor, then decoding continues; the priority boost keeps a loaded
        survivor from evicting it at once."""
        r.slot = -1
        r.state = RequestState.QUEUED
        r.prefill_pos = 0
        r.prefill_target = None
        r.saved_cache = None
        r.shared_pages = None    # the pins lived in the dead pool
        r.match_version = -1
        r.was_preempted = True
        r.priority = max(r.priority, self.failover_priority)
        try:
            self.submit(r, now=now)
            self.failovers += 1
        except AdmissionRejected:
            # every survivor's bounded queue is full of live work: fail fast
            r.finish("rejected", now if now is not None else 0.0)

    # ------------------------------------------------------------------ steps
    def step(self, now: Optional[float] = None) -> Dict[int, object]:
        """One fleet tick: each live replica's fault draws (kill, latency
        spike), its health transition, one engine stage, then the terminal
        transitions harvested and idle draining replicas retired. Returns
        {replica_id: StageReport or None}."""
        self.ticks += 1
        reports: Dict[int, object] = {}
        for rep in list(self.replicas):
            if rep.dead:
                continue
            inj = rep.injector
            if inj is not None:
                if inj.replica_kill():
                    if len(self.live) > self.min_live:
                        self._kill(rep, now)
                        continue
                    self.kills_suppressed += 1
                spike = inj.replica_spike()
                if spike > 0.0:
                    rep.engine.fault_delay += spike
                    rep.health = ReplicaHealth.DEGRADED
                    rep.spike_ticks = self.degrade_ticks
                elif rep.degraded:
                    rep.spike_ticks -= 1
                    if rep.spike_ticks <= 0:
                        rep.health = ReplicaHealth.HEALTHY
            reports[rep.id] = (rep.engine.step_async(now=now) if self.async_steps
                               else rep.engine.step(now=now))
            if rep.draining and self._idle(rep):
                self._retire(rep)
        self._harvest()
        return reports

    def _harvest(self) -> None:
        """Record each request's terminal transition exactly once."""
        for rid, r in self._requests.items():
            if r.done and rid not in self._terminal:
                owner = self._owner.get(rid)
                self._terminal[rid] = (owner.id if owner else None, r.finish_reason)

    # ------------------------------------------------------------ aggregation
    def poll(self) -> Dict[str, int]:
        """Fold every replica's ``stats(reset=True)`` window into the
        fleet's ``counters``; returns this window's sums."""
        win: Dict[str, int] = {}
        for rep in self.replicas + self.retired:
            delta = rep.engine.stats(reset=True)["delta"]
            for k, v in delta.items():
                win[k] = win.get(k, 0) + v
        for k, v in win.items():
            self.counters[k] = self.counters.get(k, 0) + v
        return win

    def stats(self) -> dict:
        """Fleet roll-up: the health census, the exactly-once ledger, the
        fleet counters, and each replica's own ``stats()`` under its id."""
        self._harvest()
        reasons: Dict[str, int] = {}
        for _, reason in self._terminal.values():
            reasons[reason] = reasons.get(reason, 0) + 1
        return {
            "n_replicas": len(self.replicas),
            "healthy": sum(1 for rep in self.replicas
                           if rep.health is ReplicaHealth.HEALTHY and not rep.draining),
            "degraded": sum(1 for rep in self.replicas if rep.degraded),
            "dead": sum(1 for rep in self.replicas if rep.dead),
            "draining": sum(1 for rep in self.replicas if rep.draining),
            "retired": len(self.retired),
            "ticks": self.ticks,
            "kills": self.kills,
            "kills_suppressed": self.kills_suppressed,
            "failovers": self.failovers,
            "lost": self.lost,
            "rejected": self.rejected,
            "duplicate_submits": self.duplicate_submits,
            "submitted": len(self._requests),
            "terminal": len(self._terminal),
            "finish_reasons": reasons,
            "counters": dict(self.counters),
            "per_replica": {rep.id: {"health": rep.health.value,
                                     "draining": rep.draining,
                                     **rep.engine.stats()}
                            for rep in self.replicas + self.retired},
        }

    # -------------------------------------------------------------- run loop
    @property
    def has_work(self) -> bool:
        return (any(rep.engine.scheduler.has_work for rep in self.live)
                or any(not r.done for r in self._requests.values()))

    def _progress(self) -> int:
        """Fleet-wide monotone progress: tokens delivered plus terminal
        transitions (failover keeps delivered output, so it never falls)."""
        return (sum(len(r.output) for r in self._requests.values())
                + sum(1 for r in self._requests.values() if r.done))

    def _stall_msg(self, why: str) -> str:
        census = ", ".join(
            f"r{rep.id}={rep.health.value}"
            f"{'(draining)' if rep.draining else ''}:load={rep.load}"
            for rep in self.replicas)
        stuck = sorted(rid for rid, r in self._requests.items() if not r.done)
        shown = ", ".join(map(str, stuck[:16])) + (", ..." if len(stuck) > 16 else "")
        return (f"fleet stalled: {why}; replicas[{census}], "
                f"stuck rids=[{shown}], counters={self.counters}")

    def run(self, requests: List[Request], *, max_ticks: int = 10_000,
            stall_ticks: int = 500, poll_every: int = 50) -> List[Request]:
        """Drive ``requests`` to drain across the fleet. A request every
        admittable replica rejects ends "rejected" and the batch goes on.
        The watchdog polls the replicas' stats windows every ``poll_every``
        ticks and raises FleetStalledError when ``max_ticks`` run out or
        ``stall_ticks`` ticks pass without fleet-wide progress."""
        for r in requests:
            try:
                self.submit(r)
            except AdmissionRejected:
                r.finish("rejected", 0.0)
                self._requests[r.rid] = r
        ticks = idle = 0
        last = self._progress()
        while self.has_work:
            if not self.live:
                self._harvest()
                raise FleetStalledError(self._stall_msg(
                    "no live replicas remain with work pending"))
            if ticks >= max_ticks:
                raise FleetStalledError(self._stall_msg(
                    f"max_ticks={max_ticks} exhausted with work pending"))
            self.step()
            ticks += 1
            if ticks % poll_every == 0:
                self.poll()
            prog = self._progress()
            if prog > last:
                last, idle = prog, 0
            else:
                idle += 1
                if idle >= stall_ticks:
                    raise FleetStalledError(self._stall_msg(
                        f"no fleet-wide progress across {idle} ticks"))
        self.poll()
        self._harvest()
        return requests
