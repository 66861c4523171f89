"""Deterministic fault injection for the serving stack (port of
``repro/serving/faults.py``; numpy only, so the same seed draws the same
schedule in both packages).

A seeded schedule the engine and the KV manager consult at fixed points, so
the failure paths run and a chaos run replays from one integer:

* **page-allocation failures**: ``KVManager._alloc_page`` raises
  :class:`InjectedPageFault` instead of handing out a page; the engine
  unwinds the stage (``_abort_stage``: its admissions return to the queue
  head) and forms the next one.
* **forced evictions**: the engine evicts a preemption victim although the
  pool has room, exercising the replay path and the survival of shared
  prefix pages under their other owners.
* **transient step errors**: a stage's device step "fails" and is retried
  with a bounded backoff; ``max_retries`` consecutive failures raise
  :class:`InjectedStepError` and abort the stage like a page fault.
* **latency spikes**: the engine's clock jumps forward, exercising the
  deadline and TTFT-SLO machinery without sleeping.

Replica faults (``replica_kill``, ``replica_spike``) default to probability
0; ``fork(index)`` derives an independent, reproducible child stream per
replica (``numpy.random.SeedSequence``). Every draw comes from one
``numpy.random.default_rng(seed)`` generator, one draw per consultation, so
the schedule depends only on the seed and the order of the consultations.
The port's KV cache is written in place, so the engine draws every fault of
a stage before the stage's first device step.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class InjectedFault(RuntimeError):
    """Base of all injector-raised faults (never raised organically)."""


class InjectedPageFault(InjectedFault):
    """A page allocation the injector decided should fail."""


class InjectedStepError(InjectedFault):
    """A stage step that kept failing past the retry budget."""


class FaultInjector:
    """Seeded schedule of faults; see the module docstring for the kinds.

    Probabilities are per consultation site (one draw per potential fault
    point). All decisions come from one ``numpy`` generator: the same seed
    against the same workload replays the same schedule.
    """

    def __init__(self, seed: int = 0, *,
                 p_page_alloc_fail: float = 0.02,
                 p_forced_evict: float = 0.05,
                 p_step_error: float = 0.03,
                 p_latency_spike: float = 0.03,
                 spike_s: float = 0.05,
                 max_retries: int = 4,
                 backoff_s: float = 0.0,
                 p_replica_kill: float = 0.0,
                 p_replica_spike: float = 0.0,
                 replica_spike_s: float = 0.25):
        if max_retries < 1:
            raise ValueError(f"max_retries must be >= 1, got {max_retries}")
        self.seed = seed
        self.p_page_alloc_fail = p_page_alloc_fail
        self.p_forced_evict = p_forced_evict
        self.p_step_error = p_step_error
        self.p_latency_spike = p_latency_spike
        self.spike_s = spike_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.p_replica_kill = p_replica_kill
        self.p_replica_spike = p_replica_spike
        self.replica_spike_s = replica_spike_s
        self._rng = np.random.default_rng(seed)
        self.counts: Dict[str, int] = {
            "page_alloc_fail": 0, "forced_evict": 0, "step_error": 0,
            "latency_spike": 0, "replica_kill": 0, "replica_spike": 0}

    def _draw(self, p: float, name: str) -> bool:
        if p <= 0.0:
            return False
        hit = bool(self._rng.random() < p)
        if hit:
            self.counts[name] += 1
        return hit

    # ---- consultation points (one per fault kind) ---------------------------
    def page_alloc_fails(self) -> bool:
        """Consulted by ``KVManager._alloc_page`` before handing out a page."""
        return self._draw(self.p_page_alloc_fail, "page_alloc_fail")

    def forced_eviction(self) -> bool:
        """Consulted once per engine stage (preemption enabled only)."""
        return self._draw(self.p_forced_evict, "forced_evict")

    def step_error(self) -> bool:
        """Consulted before each attempt of a stage's device step;
        consecutive True draws are consecutive transient failures."""
        return self._draw(self.p_step_error, "step_error")

    def latency_spike(self) -> float:
        """Seconds to advance the engine clock this stage (0.0 = none)."""
        return self.spike_s if self._draw(self.p_latency_spike,
                                          "latency_spike") else 0.0

    def replica_kill(self) -> bool:
        """Consulted once per fleet tick per replica: the replica dies."""
        return self._draw(self.p_replica_kill, "replica_kill")

    def replica_spike(self) -> float:
        """Consulted once per fleet tick per replica: virtual seconds of
        whole-replica slowdown (0.0 = none)."""
        return self.replica_spike_s if self._draw(self.p_replica_spike,
                                                  "replica_spike") else 0.0

    def backoff(self, attempt: int) -> float:
        """Linear retry backoff (virtual seconds) after ``attempt`` fails."""
        return self.backoff_s * attempt

    def fork(self, index: int) -> "FaultInjector":
        """The deterministic child injector for replica ``index``: the same
        probabilities, an independent stream seeded from (seed, index)."""
        child_seed = int(np.random.SeedSequence(
            (self.seed, index)).generate_state(1)[0])
        return FaultInjector(
            child_seed,
            p_page_alloc_fail=self.p_page_alloc_fail,
            p_forced_evict=self.p_forced_evict,
            p_step_error=self.p_step_error,
            p_latency_spike=self.p_latency_spike,
            spike_s=self.spike_s, max_retries=self.max_retries,
            backoff_s=self.backoff_s,
            p_replica_kill=self.p_replica_kill,
            p_replica_spike=self.p_replica_spike,
            replica_spike_s=self.replica_spike_s)

    @property
    def total_faults(self) -> int:
        return sum(self.counts.values())

    def __repr__(self) -> str:
        return f"FaultInjector(seed={self.seed}, counts={self.counts})"
