"""Continuous-batching serving simulator (paper §VI). Port of
``repro/sim/engine_sim.py``.

Event loop at stage granularity: each iteration forms a stage (admitting
queued requests into free KV slots => a mixed stage), asks ``layermodel``
for the stage latency + energy under the chosen policy, advances virtual
time, and records per-request T2FT / TBT / E2E (paper Fig. 2). Throughput =
generated tokens / total time; energy is tallied per stage.

``simulate_split`` (Fig. 16, Splitwise) partitions the devices into a
prefill pool and a decode pool; prompts run on the prefill pool (its own
queue), the KV migrates (an NVLink transfer), decode stages run on the
decode pool: no mixed stages, but each pool holds a full weight copy and
only half the compute serves each phase.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.opb import StageMix
from repro_torch.sim.cluster import SystemSpec, kv_bytes_per_token, max_batch_size
from repro_torch.sim.layermodel import stage_exec
from repro_torch.sim.workload import SimRequest


@dataclass
class SimResult:
    requests: List[SimRequest]
    total_time: float
    total_energy: float
    stages: int
    mixed_stages: int
    tokens_out: int

    @property
    def throughput(self) -> float:
        return self.tokens_out / max(self.total_time, 1e-12)

    @property
    def energy_per_token(self) -> float:
        return self.total_energy / max(self.tokens_out, 1)


def simulate(system: SystemSpec, cfg: ModelConfig, policy: str,
             requests: List[SimRequest], *, max_batch: Optional[int] = None,
             max_prefill_per_stage: int = 1, seed: int = 0,
             weight_copies: int = 1, max_stages: int = 2_000_000
             ) -> SimResult:
    """Serve ``requests`` (filled in place) on ``system`` under ``policy``:
    at most ``max_batch`` (else what memory holds) running, up to
    ``max_prefill_per_stage`` whole prompts admitted a stage."""
    rng = np.random.default_rng(seed)
    max_ctx = max(r.l_in + r.l_out for r in requests)
    cap = max_batch_size(system, cfg, max_ctx, weight_copies=weight_copies)
    batch_limit = min(max_batch or cap, cap) or 1

    queue = sorted(requests, key=lambda r: r.arrival)
    qi = 0
    running: List[SimRequest] = []
    progress: Dict[int, int] = {}         # rid -> tokens generated
    now = 0.0
    energy = 0.0
    stages = mixed = tokens_out = 0

    while (qi < len(queue) or running) and stages < max_stages:
        # admit arrived requests into free slots
        admitted: List[SimRequest] = []
        while (qi < len(queue) and queue[qi].arrival <= now
               and len(running) + len(admitted) < batch_limit
               and len(admitted) < max_prefill_per_stage):
            admitted.append(queue[qi])
            qi += 1
        if not running and not admitted:
            if qi < len(queue):
                now = queue[qi].arrival   # idle until the next arrival
                continue
            break

        mix = StageMix(
            decode_ctx=tuple(r.l_in + progress[r.rid] for r in running),
            prefill_len=tuple(r.l_in for r in admitted))
        ex = stage_exec(system, cfg, mix, policy, rng=rng)
        now += ex.time
        energy += ex.energy
        stages += 1
        mixed += 1 if mix.is_mixed else 0

        # every participant emits one token
        for r in admitted:
            progress[r.rid] = 1
            r.first_token_time = now
            r.token_times.append(now)
            tokens_out += 1
            running.append(r)
        for r in list(running):
            if r in admitted:
                continue
            progress[r.rid] += 1
            r.token_times.append(now)
            tokens_out += 1
        for r in list(running):
            if progress[r.rid] >= r.l_out:
                r.finish_time = now
                running.remove(r)
    return SimResult(requests, now, energy, stages, mixed, tokens_out)


def simulate_split(system_prefill: SystemSpec, system_decode: SystemSpec,
                   cfg: ModelConfig, policy: str,
                   requests: List[SimRequest], *, seed: int = 0
                   ) -> SimResult:
    """Splitwise-style phase-split system (paper Fig. 16): prefill pool +
    decode pool, KV migration in between, each pool with its own weights."""
    rng = np.random.default_rng(seed)
    max_ctx = max(r.l_in + r.l_out for r in requests)
    cap_dec = max_batch_size(system_decode, cfg, max_ctx, weight_copies=1)
    kv_tok = kv_bytes_per_token(cfg)

    # prefill pool: sequential prompt processing (its own little queue)
    t_pre = 0.0
    energy = 0.0
    ready: List[SimRequest] = []
    for r in sorted(requests, key=lambda x: x.arrival):
        mix = StageMix(prefill_len=(r.l_in,))
        ex = stage_exec(system_prefill, cfg, mix, policy, rng=rng)
        t_pre = max(t_pre, r.arrival) + ex.time
        energy += ex.energy
        # KV migration to the decode pool
        t_pre += kv_tok * r.l_in / system_prefill.nvlink_bw
        r.first_token_time = t_pre
        r.token_times.append(t_pre)
        ready.append(r)

    # decode pool: continuous batching over decode-only stages
    now = 0.0
    running: List[SimRequest] = []
    progress: Dict[int, int] = {}
    tokens_out = len(ready)
    stages = 0
    idx = 0
    ready_sorted = sorted(ready, key=lambda r: r.first_token_time)
    while idx < len(ready_sorted) or running:
        while (idx < len(ready_sorted)
               and ready_sorted[idx].first_token_time <= now
               and len(running) < max(cap_dec, 1)):
            r = ready_sorted[idx]
            progress[r.rid] = 1
            running.append(r)
            idx += 1
        if not running:
            now = ready_sorted[idx].first_token_time
            continue
        mix = StageMix(decode_ctx=tuple(r.l_in + progress[r.rid]
                                        for r in running))
        ex = stage_exec(system_decode, cfg, mix, policy, rng=rng)
        now += ex.time
        energy += ex.energy
        stages += 1
        for r in list(running):
            progress[r.rid] += 1
            r.token_times.append(max(now, r.first_token_time))
            tokens_out += 1
            if progress[r.rid] >= r.l_out:
                r.finish_time = max(now, r.first_token_time)
                running.remove(r)
    total = max(now, t_pre)
    return SimResult(requests, total, energy, stages, 0, tokens_out)
