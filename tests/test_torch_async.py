"""PyTorch port, the async serving loop, mirroring
``tests/test_async_serving.py``:

* the port alone, ``small_test_config`` without the duplex MoE: ``run_async``
  gives ``run``'s greedy tokens on the dense, paged, paged-chunked and
  prefix-sharing flavors, dispatches speculative plans and drains the pool
  with a clean audit; chained stages count as gap stages with no gap; a
  thread submitting, cancelling and polling ``stats`` while the loop runs;
  a cancel between ``step_async`` ticks discards the in-flight row;
* the port's ``run_async`` against the reference's, float32 with the duplex
  MoE on (paged, chunked, with prefix sharing; dense): equal tokens, equal
  per-stage (decode rows, chunk rows, k_cold, aborted) and equal planning
  counters; one seeded ``FaultInjector`` run through both loops of both
  packages;
* ``_select_tokens`` against the reference's in its three modes, and the
  scheduler's ``plan_stage``: pure, and the reference's under projected
  overrides;
* path h of ``chip_smoke.py``: its async run, built by the smoke's own
  functions on a narrow OLMoE on the CPU, forms the schedule the card gates
  (``H_EXPECT``).
"""
import dataclasses
import importlib.util
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig, small_test_config
from repro.models.model import init_model
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.engine import _select_tokens as ref_select_tokens
from repro.serving.faults import FaultInjector as RefInjector
from repro.serving.request import Request as RefRequest
from repro.serving.scheduler import ContinuousBatchingScheduler as RefScheduler
from repro_torch.configs import small_test_config as t_small_test_config
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving.engine import ServingEngine, _select_tokens
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers
ROOT = Path(__file__).resolve().parents[1]

FLAVORS = {
    "dense": dict(kv_layout="dense"),
    "paged": dict(kv_layout="paged", kv_page_size=8),
    "paged_chunked": dict(kv_layout="paged", kv_page_size=8, prefill_chunk_tokens=6),
    "prefix_share": dict(kv_layout="paged", kv_page_size=8, prefill_chunk_tokens=8,
                         prefix_share=True),
}


def _params(cfg_j):
    pj = init_model(jax.random.PRNGKey(0), cfg_j)
    return pj, from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")


@pytest.fixture(scope="module")
def dense_ffn():
    cfg = t_small_test_config("async-test", num_layers=2, d_model=64)
    _, pt = _params(small_test_config("async-test", num_layers=2, d_model=64))
    return cfg, pt


@pytest.fixture(scope="module")
def moe_pkgs():
    moe = dict(num_experts=4, top_k=2, d_ff_expert=64)
    cfg_j = small_test_config("async-moe", family="moe", num_layers=2, d_model=64,
                              moe=MoEConfig(**moe))
    cfg_t = t_small_test_config("async-moe", family="moe", num_layers=2, d_model=64,
                                moe=TMoEConfig(**moe))
    pj, pt = _params(cfg_j)
    return cfg_j, cfg_t, pj, pt


def _requests(R, vocab, n=6, l_out=5, shared_prefix=False):
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, vocab, 16).tolist() if shared_prefix else []
    return [R(rid=i, prompt=prefix + rng.integers(0, vocab, int(rng.integers(4, 20))).tolist(),
              max_new_tokens=l_out) for i in range(n)]


def _port(cfg, params, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 64)
    return ServingEngine(cfg, params, use_kernels=False, device="cpu", **kw)


def _drained(eng):
    return (eng.kv.free_slots == eng.kv.max_slots and eng.kv.live_pages == 0
            and eng.kv.audit(pins={}) == [])


# ---- the port alone ------------------------------------------------------------------
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_async_tokens_equal_sync(dense_ffn, flavor):
    cfg, pt = dense_ffn
    kw = FLAVORS[flavor]
    out = {}
    for loop in ("run", "run_async"):
        eng = _port(cfg, pt, use_duplex=False, **kw)
        reqs = _requests(Request, cfg.vocab_size, shared_prefix=kw.get("prefix_share", False))
        getattr(eng, loop)(reqs)
        out[loop] = {r.rid: list(r.output) for r in reqs}
        assert all(len(t) == 5 for t in out[loop].values())
        assert _drained(eng)
    assert out["run_async"] == out["run"], f"{flavor}: async departed from sync"
    st = eng.stats()
    assert st["spec_hits"] > 0 and st["chained_stages"] > 0


def test_chained_dispatch_has_no_gap(dense_ffn):
    """Chained stages enqueue before their predecessor is read: they count
    as gap stages and add nothing to the host gap."""
    cfg, pt = dense_ffn
    eng = _port(cfg, pt, use_duplex=False, **FLAVORS["paged_chunked"])
    reqs = _requests(Request, cfg.vocab_size)
    eng.run_async(reqs)
    st = eng.stats()
    assert 0 < st["chained_stages"] <= st["spec_hits"]
    assert st["gap_stages"] >= st["chained_stages"]
    assert st["gap_stages"] == st["stages"] - 1     # every stage after the first
    sync = _port(cfg, pt, use_duplex=False, **FLAVORS["paged_chunked"])
    sync.run(_requests(Request, cfg.vocab_size))
    s2 = sync.stats()
    assert (s2["chained_stages"], s2["spec_hits"], s2["gap_stages"]) == (0, 0, s2["stages"] - 1)


def test_threaded_submit_cancel_soak(dense_ffn):
    """A thread submits, cancels and polls ``stats`` while ``run_async``
    runs: every request ends exactly once, the cancelled ones as cancelled,
    the audits stay clean and the pool drains."""
    cfg, pt = dense_ffn
    eng = _port(cfg, pt, use_duplex=False, kv_layout="paged", kv_page_size=8,
                prefill_chunk_tokens=8, prefix_share=True, audit_stages=True)
    rng = np.random.default_rng(11)
    initial = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 12).tolist(),
                       max_new_tokens=8) for i in range(4)]
    late, cancelled, polls = [], [], []

    def feeder():
        for i in range(4, 16):
            r = Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 10).tolist(),
                        max_new_tokens=6)
            late.append(r)
            eng.submit(r)
            if i % 3 == 0 and eng.cancel(i - 2):
                cancelled.append(i - 2)
            polls.append(eng.stats(reset=i % 2 == 0))
            time.sleep(0.002)

    t = threading.Thread(target=feeder)
    t.start()
    eng.run_async(initial, max_stages=5000)
    t.join()
    eng.run_async([], max_stages=5000)      # what landed after the loop saw no work
    everyone = initial + late
    assert all(r.done for r in everyone)
    assert sorted(r.rid for r in everyone if r.finish_reason == "cancelled") == sorted(cancelled)
    assert all(len(r.output) == r.max_new_tokens for r in everyone
               if r.finish_reason == "length")
    assert _drained(eng) and eng.stats()["audit_violations"] == 0
    assert all("spec_hits" in s and "stages" in s and "delta" in s for s in polls)


def test_cancel_between_step_async_ticks(dense_ffn):
    """A cancel landing while a stage is in flight drops that row at the
    commit: no token is recorded for the cancelled request."""
    cfg, pt = dense_ffn
    eng = _port(cfg, pt, use_duplex=False, max_slots=2, max_len=32, kv_layout="dense")
    reqs = [Request(rid=i, prompt=[1, 2, 3, 4], max_new_tokens=20) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step_async()
    assert eng._inflight is not None
    n0 = len(reqs[0].output)
    assert eng.cancel(0)
    while eng.scheduler.has_work:
        eng.step_async()
    eng.step_async()                         # commit the trailing in-flight stage
    assert eng._inflight is None
    assert reqs[0].finish_reason == "cancelled" and len(reqs[0].output) == n0
    assert reqs[1].done and len(reqs[1].output) == 20
    assert eng.kv.free_slots == eng.kv.max_slots


def test_stall_message_notes_the_stage_in_flight(dense_ffn):
    cfg, pt = dense_ffn
    eng = _port(cfg, pt, use_duplex=False)
    msg = eng._stall_msg("why", inflight=True)
    assert msg.startswith("engine stalled: why;") and msg.endswith("(dispatched, uncommitted)")
    assert "in flight" not in eng._stall_msg("why")


# ---- against the reference -----------------------------------------------------------
def _summary(eng, reqs):
    st = eng.stats()
    return dict(tokens=[list(r.output) for r in reqs],
                reasons=[r.finish_reason for r in reqs],
                stages=[(p.num_decode, p.num_prefill, p.k_cold, p.aborted) for p in eng.reports],
                counters={k: st[k] for k in ("stages", "spec_hits", "spec_misses",
                                             "spec_miss_reasons", "chained_stages",
                                             "gap_stages", "preemptions", "stage_aborts",
                                             "retries")})


@pytest.mark.parametrize("kw", [
    dict(kv_layout="paged", kv_page_size=8, prefill_chunk_tokens=8, prefix_share=True),
    dict(kv_layout="dense"),
], ids=["paged_chunked_prefix_share", "dense"])
def test_run_async_matches_the_reference_with_the_duplex_moe(moe_pkgs, kw):
    """float32, the duplex MoE on: the async schedule (whose k_cold reads a
    staler count EMA than the sync loop's) is the reference's, stage for
    stage."""
    cfg_j, cfg_t, pj, pt = moe_pkgs
    share = kw.get("prefix_share", False)
    ref = RefEngine(cfg_j, pj, max_slots=4, max_len=64, **kw)
    ref_reqs = _requests(RefRequest, cfg_j.vocab_size, n=5, l_out=4, shared_prefix=share)
    ref.run_async(ref_reqs)
    eng = _port(cfg_t, pt, **kw)
    reqs = _requests(Request, cfg_t.vocab_size, n=5, l_out=4, shared_prefix=share)
    eng.run_async(reqs)
    got, want = _summary(eng, reqs), _summary(ref, ref_reqs)
    assert got == want
    assert got["counters"]["chained_stages"] > 0
    assert any(s[2] > 0 for s in got["stages"])          # the duplex split ran
    assert _drained(eng)


SOAK_KW = dict(max_slots=4, max_len=64, kv_layout="paged", kv_page_size=8, kv_num_pages=1 + 20,
               prefix_share=True, preemption="recompute", prefill_chunk_tokens=8)
SOAK_FAULTS = dict(p_page_alloc_fail=0.05, p_forced_evict=0.08, p_step_error=0.05,
                   p_latency_spike=0.05, max_retries=4)


def _soak_requests(R, vocab):
    rng = np.random.default_rng(42)
    sys_prefix = rng.integers(0, vocab, 16).tolist()
    return [R(rid=i, prompt=(sys_prefix + rng.integers(0, vocab, 4 + i).tolist() if i % 4 != 3
                             else rng.integers(0, vocab, 19).tolist()), max_new_tokens=5)
            for i in range(8)]


def test_fault_injector_through_both_loops_of_both_packages(dense_ffn):
    """Seed 0 of the chaos soak's injector on the soak's engine (paged,
    sharing, recompute over a tight pool; a dense FFN, as the chaos soak,
    so that the reference compiles few shapes). The sync loop of the port
    draws the reference's fault schedule and forms its stages, counters and
    tokens. In the async loop the reference departs from its own sync
    tokens on request 5: a request evicted while its stage is in flight
    keeps that stage's prefill position (ROADMAP queue 3). The port drops
    such a stale row at the commit and forms the next stage from real
    state (a spec miss, "evicted"), so its async loop emits the sync
    loop's tokens. Both drain cleanly."""
    cfg_t, pt = dense_ffn
    cfg_j = small_test_config("async-test", num_layers=2, d_model=64)
    pj, _ = _params(cfg_j)
    got, want = {}, {}
    for loop in ("run", "run_async"):
        ref_inj, inj = RefInjector(0, **SOAK_FAULTS), FaultInjector(0, **SOAK_FAULTS)
        ref = RefEngine(cfg_j, pj, injector=ref_inj, use_duplex=False, **SOAK_KW)
        ref_reqs = _soak_requests(RefRequest, cfg_j.vocab_size)
        getattr(ref, loop)(ref_reqs, max_stages=2000, stall_stages=1000)
        eng = ServingEngine(cfg_t, pt, use_kernels=False, use_duplex=False, device="cpu",
                            injector=inj, **SOAK_KW)
        reqs = _soak_requests(Request, cfg_t.vocab_size)
        getattr(eng, loop)(reqs, max_stages=2000, stall_stages=1000)
        got[loop], want[loop] = _summary(eng, reqs), _summary(ref, ref_reqs)
        assert inj.total_faults > 0
        assert got[loop]["counters"]["stage_aborts"] > 0
        assert got[loop]["counters"]["preemptions"] > 0
        assert all(r.completed for r in reqs)
        assert _drained(eng) and eng.stats()["audit_violations"] == 0
        if loop == "run":
            assert got[loop] == want[loop]
            assert inj.counts == ref_inj.counts
    departs = [i for i, (a, b) in enumerate(zip(want["run"]["tokens"],
                                                 want["run_async"]["tokens"])) if a != b]
    assert departs == [5]                                     # the reference's fault
    assert got["run_async"]["tokens"] == got["run"]["tokens"] == want["run"]["tokens"]
    assert got["run_async"]["counters"]["spec_miss_reasons"].get("evicted", 0) > 0


# ---- the device gather and the pure planner -------------------------------------------
@pytest.mark.parametrize("mode", ["pure", "nxt_only", "full"])
def test_select_tokens_matches_the_reference(mode):
    rng = np.random.default_rng(3)
    prev_nxt = rng.integers(0, 1000, (8,)).astype(np.int32)
    prev_cn = rng.integers(0, 1000, (4,)).astype(np.int32)
    n = 16
    src_nxt = rng.integers(0 if mode == "pure" else -1, 8, n).astype(np.int32)
    src_cn = (np.where(rng.random(n) < 0.3, rng.integers(0, 4, n), -1).astype(np.int32)
              if mode == "full" else np.full(n, -1, np.int32))
    if mode == "full":
        src_nxt[src_cn >= 0] = -1
    fallback = rng.integers(0, 1000, n).astype(np.int32)
    want = np.asarray(ref_select_tokens(*(jnp.asarray(a) for a in (
        prev_nxt, prev_cn, src_nxt, src_cn, fallback)), mode))
    t = torch.from_numpy
    got = _select_tokens(t(prev_nxt), t(prev_cn), t(src_nxt), t(src_cn), t(fallback), mode)
    assert got.dtype == torch.int32 and got.shape == (n, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def _sched_state(R, S):
    """A scheduler with two decoding, one prefilling (position 6 of 20) and
    four queued requests (one cancelled), chunks of 16."""
    s = S(max_prefill_seqs=3, prefill_chunk_tokens=16, max_prefill_target=64, aging_rounds=2)
    reqs = [R(rid=i, prompt=list(range(1, 13 + i)), max_new_tokens=4) for i in range(7)]
    for r in reqs:
        s.submit(r)
    for r in reqs[:3]:
        s.queue.remove(r)
        r.prefill_target = r.prefill_pos = len(r.prompt)
    for r in reqs[:2]:
        r.state = type(r.state).DECODE
        s.running.append(r)
    reqs[2].state = type(reqs[2].state).PREFILL
    reqs[2].prefill_pos, reqs[2].prefill_target = 6, 20
    s.prefilling.append(reqs[2])
    reqs[4].finish("cancelled", 0.0)
    return s, reqs


def _decision(d):
    return (None if d is None else
            ([(c.req.rid, c.start, c.end, c.first, c.target) for c in d.chunks],
             [r.rid for r in d.decoding], [r.rid for r in d.restored]))


def _snapshot(s, reqs):
    return ([r.rid for r in s.queue], [r.rid for r in s.running], [r.rid for r in s.prefilling],
            [(r.state.value, r.prefill_pos, r.prefill_target, r.aging_skips) for r in reqs],
            s.aging_promotions)


def test_plan_stage_is_pure_and_matches_the_reference():
    s, reqs = _sched_state(Request, ContinuousBatchingScheduler)
    rs, rreqs = _sched_state(RefRequest, RefScheduler)
    before = _snapshot(s, reqs)
    for free in (0, 1, 3):
        assert _decision(s.plan_stage(free)) == _decision(rs.plan_stage(free))
        # projected: request 2's chunk in flight to 14, request 0 finished,
        # request 3 admitted by the stage in flight and at position 8
        kw = dict(prefilling=[reqs[2], reqs[3]], running=[reqs[1]],
                  queue=[reqs[4], reqs[5], reqs[6]], pos={2: 14, 3: 8})
        rkw = dict(prefilling=[rreqs[2], rreqs[3]], running=[rreqs[1]],
                   queue=[rreqs[4], rreqs[5], rreqs[6]], pos={2: 14, 3: 8})
        got = s.plan_stage(free, **kw)
        assert _decision(got) == _decision(rs.plan_stage(free, **rkw))
        assert _snapshot(s, reqs) == before
    d = s.next_stage(2)
    rd = rs.next_stage(2)
    assert _decision(d) == _decision(rd)
    assert _snapshot(s, reqs) == _snapshot(rs, rreqs) != before
    assert s.stage_counts == rs.stage_counts == {"mixed": 1, "decode_only": 0}
    assert reqs[4] not in s.queue                       # activate purged it
    assert [c.req.rid for c in d.chunks if c.first] == [3]
    assert reqs[3].state == RequestState.PREFILL and reqs[3].prefill_target == 15


# ---- path h's gates ---------------------------------------------------------------------
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_h", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_path_h_counters_match_the_smoke_gates():
    """Path h's async run on the port's engine on the CPU, narrow (2 layers,
    d_model 64, OLMoE's 64 experts top-8 and vocabulary), built by the
    smoke's own functions: the schedule counters equal ``H_EXPECT``, every
    request completes with 32 tokens and the pool drains."""
    from repro_torch.configs import resolve_config
    from repro_torch.configs.base import ATTN, MOE, LayerKind, Segment
    from repro_torch.models.params import init_model as t_init_model
    sm = _smoke()
    full = resolve_config("olmoe-1b-7b")
    cfg = dataclasses.replace(
        full, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=32,
        segments=(Segment((LayerKind(ATTN, MOE),), 2),),
        moe=dataclasses.replace(full.moe, d_ff_expert=32), dtype="float32",
        param_dtype="float32").validate()
    params = t_init_model(cfg, seed=0, device="cpu")
    reqs = sm.path_a_requests(cfg)
    eng = ServingEngine(cfg, params, device="cpu", **sm.ASYNC_KW)
    eng.run_async(reqs)
    assert sm.async_counters(eng) == sm.H_EXPECT
    assert all(r.completed and len(r.output) == 32 for r in reqs) and sm.drained(eng)
    assert sm.H_EXPECT["chained_stages"] > 0
