"""PyTorch port, overload hardening (deadlines, first-token SLOs,
cancellation, bounded admission with shedding, priority aging, the
watchdog, ``stats`` windows), mirroring ``tests/test_overload.py``:

* the scheduler and the request on the port alone: the typed reject,
  shed-oldest, shed-past-deadline's fallback to a reject, priority bands and
  aging, finish reasons, ``past_deadline`` with a TTFT SLO;
* the engine, each scenario on one virtual-clock workload through both
  packages on ``small_test_config`` (``use_duplex=False``, the port on the
  CPU without kernels, the same weights): per request the finish reason,
  the state and the tokens, the engine's counters and each stage's report
  equal, and the scenario's own checks (pins released, the pool drained) on
  both;
* path g of ``chip_smoke.py``: its two runs' requests, engine flags,
  injector and virtual clock, built by the smoke's own functions, run on
  the port's engine on the CPU with a narrow OLMoE (2 layers, OLMoE's
  vocabulary), and every counter the card gates equals the smoke's
  constant.
"""
import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import small_test_config
from repro.models.model import init_model
from repro.serving.engine import EngineStalledError as RefStalled
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.faults import FaultInjector as RefInjector
from repro.serving.request import Request as RefRequest
from repro.serving.request import RequestState as RefState
from repro_torch.configs import small_test_config as t_small_test_config
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving import preemption as pre
from repro_torch.serving.engine import EngineStalledError, ServingEngine
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import AdmissionRejected, ContinuousBatchingScheduler

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pkgs():
    cfg_j = small_test_config("ov-test")
    cfg_t = t_small_test_config("ov-test")
    pj = init_model(jax.random.PRNGKey(0), cfg_j)
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")

    def engine(make):
        def build(**kw):
            kw.setdefault("max_slots", 2)
            kw.setdefault("max_len", 32)
            kw.setdefault("kv_layout", "dense")
            return make(use_duplex=False, **kw)
        return build
    ref = SimpleNamespace(
        engine=engine(lambda **kw: RefEngine(cfg_j, pj, **kw)), Request=RefRequest,
        State=RefState, Stalled=RefStalled, Injector=RefInjector)
    port = SimpleNamespace(
        engine=engine(lambda **kw: ServingEngine(cfg_t, pt, use_kernels=False,
                                                 device="cpu", **kw)),
        Request=Request, State=RequestState, Stalled=EngineStalledError,
        Injector=FaultInjector)
    return cfg_t, ref, port


def _req(R, rid, l_in=12, l_out=4, vocab=256, seed=None, **kw):
    rng = np.random.default_rng(seed if seed is not None else rid)
    return R(rid=rid, prompt=rng.integers(0, vocab, l_in).tolist(), max_new_tokens=l_out,
             **kw)


def _drain(eng, max_stages=500, now=None):
    for _ in range(max_stages):
        if eng.step(now=now) is None:
            break
    assert not eng.scheduler.has_work


def _summary(eng, reqs):
    st = eng.stats()
    return dict(
        requests=[(r.rid, r.state.value, r.finish_reason, list(r.output)) for r in reqs],
        counters={k: st[k] for k in ServingEngine.STATS_DELTA_KEYS + (
            "peak_active", "aging_promotions")},
        stages=[(p.num_decode, p.num_prefill, p.aborted, p.shed, p.expired, p.cancelled,
                 p.retries) for p in eng.reports])


def _both(pkgs, scenario):
    """Run ``scenario(ns)`` -> (engine, requests) on both packages; the
    summaries must be equal. Returns the port's engine and requests."""
    _, ref, port = pkgs
    out = {}
    for name, ns in (("ref", ref), ("port", port)):
        eng, reqs = scenario(ns)
        out[name] = (_summary(eng, reqs), eng, reqs)
    assert out["port"][0] == out["ref"][0]
    return out["port"][1], out["port"][2]


# ---- scheduler and request, the port alone -----------------------------------
def test_admission_rejected_typed_fields():
    s = ContinuousBatchingScheduler(queue_cap=2, overload_policy="reject")
    s.submit(_req(Request, 0))
    s.submit(_req(Request, 1))
    with pytest.raises(AdmissionRejected) as ei:
        s.submit(_req(Request, 2))
    e = ei.value
    assert (e.rid, e.queue_depth, e.queue_cap, e.policy) == (2, 2, 2, "reject")
    assert "queue full" in str(e) and "2/2" in str(e)
    assert s.pending == 2


def test_shed_oldest_makes_room():
    s = ContinuousBatchingScheduler(queue_cap=2, overload_policy="shed-oldest")
    r0, r1, r2 = (_req(Request, i) for i in range(3))
    s.submit(r0)
    s.submit(r1)
    assert s.submit(r2) == [r0]
    assert list(s.queue) == [r1, r2] and s.shed_count == 1


def test_shed_past_deadline_falls_back_to_reject():
    s = ContinuousBatchingScheduler(queue_cap=2, overload_policy="shed-past-deadline")
    live = _req(Request, 0, deadline=100.0)
    dead = _req(Request, 1, deadline=5.0)
    s.submit(live, now=0.0)
    s.submit(dead, now=0.0)
    assert s.submit(_req(Request, 2, deadline=100.0), now=10.0) == [dead]
    assert dead not in s.queue
    with pytest.raises(AdmissionRejected):
        s.submit(_req(Request, 3, deadline=100.0), now=10.0)


def test_bad_overload_arguments_raise():
    for kw in (dict(overload_policy="drop"), dict(queue_cap=0), dict(aging_rounds=0)):
        with pytest.raises(ValueError):
            ContinuousBatchingScheduler(**kw)


def test_priority_bands_and_shed_takes_the_lowest():
    s = ContinuousBatchingScheduler()
    for rid, prio in ((0, 0), (1, 0), (2, 5), (3, 5), (4, 1)):
        s.submit(_req(Request, rid, priority=prio))
    assert [r.rid for r in s.queue] == [2, 3, 4, 0, 1]
    s = ContinuousBatchingScheduler(queue_cap=2, overload_policy="shed-oldest")
    hi, lo = _req(Request, 0, priority=3), _req(Request, 1)
    s.submit(hi)
    s.submit(lo)
    assert s.submit(_req(Request, 2, priority=1)) == [lo] and hi in s.queue


@pytest.mark.parametrize("aging", [None, 2])
def test_aging_promotes_a_starved_band(aging):
    """One admission a stage: low (band 0) waits behind three band-1
    requests. With aging every 2 stages, the second stage promotes the two
    still queued (h3 to band 2, low to band 1), so low admits ahead of h4,
    submitted after it in band 1 (and promoted in turn at the fourth);
    without aging h4 goes first."""
    s = ContinuousBatchingScheduler(max_prefill_seqs=1, prefill_chunk_tokens=64,
                                    max_prefill_target=64, aging_rounds=aging)
    low = _req(Request, 0)
    s.submit(low)
    for rid in (1, 2, 3):
        s.submit(_req(Request, rid, priority=1))
    order = []
    for stage in range(4):
        if stage == 2:
            s.submit(_req(Request, 4, priority=1))
        d = s.next_stage(1)
        order += [c.req.rid for c in d.chunks]
    assert order == ([1, 2, 3, 0] if aging else [1, 2, 3, 4])
    assert s.aging_promotions == (3 if aging else 0)
    if aging:
        assert s.effective_priority(low) == 1 and low.aging_skips == 3


def test_finish_reasons_and_past_deadline_with_ttft_slo():
    r = _req(Request, 0, l_out=2)
    r.record_token(7, 1.0)
    r.record_token(8, 2.0)
    assert r.completed and r.finish_reason == "length" and r.e2e() == 2.0
    r2 = _req(Request, 1, l_out=8, eos_id=3)
    r2.record_token(3, 1.0)
    assert r2.completed and r2.finish_reason == "stop"
    r = _req(Request, 2, deadline=10.0)
    assert not r.past_deadline(9.9) and r.past_deadline(10.0)
    r3 = _req(Request, 3, arrival_time=5.0, ttft_slo=3.0)
    assert not r3.past_deadline(7.9) and r3.past_deadline(8.0)
    r3.record_token(1, 7.5)          # the first token inside the SLO
    assert not r3.past_deadline(100.0)
    r.finish("expired", 10.0)
    assert r.state is RequestState.EXPIRED and r.done and not r.completed
    assert not r.past_deadline(99.0)
    r4 = _req(Request, 4)
    r4.finish("shed", 1.0)
    assert r4.state is RequestState.CANCELLED and r4.finish_reason == "shed"


def test_past_deadline_victim_goes_first():
    def running(rid, priority, n_out, deadline=None):
        r = _req(Request, rid, priority=priority, deadline=deadline)
        r.state, r.slot, r.output = RequestState.DECODE, rid, list(range(n_out))
        return r
    a, b, c = running(0, 2, 1), running(1, 0, 3), running(2, 0, 1)
    e = running(4, 9, 2, deadline=1.0)
    assert pre.pick_victim([a, b, c, e], now=2.0) is e
    assert pre.pick_victim_paged([a, b, c, e], now=2.0) is e


# ---- the engine, both packages -------------------------------------------------
def test_cancel_queued_releases_prefix_pins(pkgs):
    """A request cancelled while queued after pinning a prefix unpins it,
    and the pool drains to fully free."""
    cfg = pkgs[0]

    def scenario(ns):
        eng = ns.engine(max_slots=1, kv_layout="paged", kv_page_size=8,
                        prefix_share=True, prefill_chunk_tokens=8)
        prefix = np.random.default_rng(0).integers(0, cfg.vocab_size, 16).tolist()
        donor = ns.Request(rid=0, prompt=prefix + [7, 8], max_new_tokens=6)
        eng.submit(donor, now=0.0)
        for _ in range(10):
            eng.step(now=0.0)
            if eng.kv.match_prefix(prefix):
                break
        assert eng.kv.match_prefix(prefix)
        waiter = ns.Request(rid=1, prompt=prefix + [9, 10], max_new_tokens=6)
        eng.submit(waiter, now=0.0)
        eng.step(now=0.0)                 # the queue-head refresh re-matches
        pinned = list(waiter.shared_pages)
        before = [eng.kv.page_ref(p) for p in pinned]
        assert eng.cancel(1, now=0.0)
        assert waiter.shared_pages is None
        assert [eng.kv.page_ref(p) for p in pinned] == [c - 1 for c in before]
        _drain(eng, now=0.0)
        assert donor.completed
        assert eng.kv.live_pages == 0 and eng.kv.free_slots == eng.kv.max_slots
        assert eng.kv.audit(pins={}) == []
        return eng, [donor, waiter]
    eng, _ = _both(pkgs, scenario)
    assert eng.stats()["cancelled"] == 1


def test_cancel_running_frees_slot_and_survivor_completes(pkgs):
    def scenario(ns):
        eng = ns.engine(kv_layout="paged", kv_page_size=8, prefill_chunk_tokens=16)
        a, b = _req(ns.Request, 0, l_out=8), _req(ns.Request, 1, l_out=8)
        eng.submit(a, now=0.0)
        eng.submit(b, now=0.0)
        while len(a.output) < 2 or len(b.output) < 2:
            eng.step(now=0.0)
        assert eng.cancel(0, now=5.0)
        assert a.state is ns.State.CANCELLED and a.slot == -1
        n_out = len(a.output)
        _drain(eng, now=5.0)
        assert b.completed and len(b.output) == 8 and len(a.output) == n_out
        assert eng.kv.live_pages == 0 and eng.kv.audit() == []
        assert eng.cancel(0) is False and eng.cancel(99) is False
        return eng, [a, b]
    _both(pkgs, scenario)


@pytest.mark.parametrize("adopted", [False, True])
def test_cancel_mid_chunk_prefill(pkgs, adopted):
    """A cancel between two chunks of a prefill (the request owns a slot and
    written pages, no token yet), with and without an adopted shared prefix:
    everything comes back (the donor keeps its pages) and the pool drains."""
    cfg = pkgs[0]

    def scenario(ns):
        eng = ns.engine(kv_layout="paged", kv_page_size=8, prefix_share=adopted,
                        prefill_chunk_tokens=8)
        reqs = []
        if adopted:
            prefix = np.random.default_rng(3).integers(0, cfg.vocab_size, 16).tolist()
            donor = ns.Request(rid=0, prompt=prefix + [5, 6], max_new_tokens=12)
            eng.submit(donor, now=0.0)
            for _ in range(10):
                eng.step(now=0.0)
                if eng.kv.match_prefix(prefix):
                    break
            r = ns.Request(rid=1, prompt=prefix + list(range(9, 19)), max_new_tokens=6)
            eng.submit(r, now=0.0)
            shared = list(r.shared_pages)
            for _ in range(10):
                eng.step(now=0.0)
                if r.state is ns.State.PREFILL:
                    break
            reqs.append(donor)
        else:
            r = _req(ns.Request, 0, l_in=24, l_out=4)     # 3 chunks of 8
            eng.submit(r, now=0.0)
            eng.step(now=0.0)
        reqs.append(r)
        assert r.state is ns.State.PREFILL and 0 < r.prefill_pos < r.prefill_total
        assert eng.kv.live_pages > 0
        if adopted:
            refs = [eng.kv.page_ref(p) for p in shared]
        assert eng.cancel(r.rid, now=0.0)
        assert r.state is ns.State.CANCELLED and r.slot == -1 and r.output == []
        if adopted:
            assert [eng.kv.page_ref(p) for p in shared] == [c - 1 for c in refs]
        _drain(eng, now=0.0)
        assert eng.kv.live_pages == 0 and eng.kv.free_slots == eng.kv.max_slots
        assert eng.kv.audit(pins={}) == []
        return eng, reqs
    eng, _ = _both(pkgs, scenario)
    assert eng.stats()["cancelled"] == 1


def test_deadline_expiry_frees_capacity(pkgs):
    def scenario(ns):
        eng = ns.engine(max_slots=1, kv_layout="paged", kv_page_size=8,
                        prefill_chunk_tokens=16)
        slow = _req(ns.Request, 0, l_out=20, deadline=3.0)
        waiting = _req(ns.Request, 1, l_out=2, arrival_time=0.0, ttft_slo=50.0)
        eng.submit(slow, now=0.0)
        eng.submit(waiting, now=0.0)
        eng.step(now=0.0)
        assert slow.slot >= 0 and waiting.slot < 0
        eng.step(now=4.0)                 # the sweep: slow is past its deadline
        assert slow.state is ns.State.EXPIRED and slow.slot == -1
        _drain(eng, now=5.0)
        assert waiting.completed and eng.kv.live_pages == 0
        return eng, [slow, waiting]
    eng, _ = _both(pkgs, scenario)
    assert eng.stats()["expired"] == 1 and eng.reports[1].expired == 1


def test_ttft_slo_expires_queued_request(pkgs):
    def scenario(ns):
        eng = ns.engine(max_slots=1)
        hog = _req(ns.Request, 0, l_out=12)
        slo = _req(ns.Request, 1, l_out=2, arrival_time=0.0, ttft_slo=2.0)
        eng.submit(hog, now=0.0)
        eng.submit(slo, now=0.0)
        eng.step(now=0.0)
        eng.step(now=3.0)                 # the SLO lapsed with no first token
        assert slo.state is ns.State.EXPIRED and slo.finish_reason == "expired"
        _drain(eng, now=3.0)
        assert hog.completed
        return eng, [hog, slo]
    _both(pkgs, scenario)


def test_engine_shed_releases_and_counts(pkgs):
    def scenario(ns):
        eng = ns.engine(queue_cap=1, overload_policy="shed-oldest")
        r0, r1 = _req(ns.Request, 0), _req(ns.Request, 1)
        eng.submit(r0, now=0.0)
        eng.submit(r1, now=0.0)           # sheds r0
        assert r0.state is ns.State.CANCELLED and r0.finish_reason == "shed"
        _drain(eng, now=0.0)
        assert r1.completed
        return eng, [r0, r1]
    eng, _ = _both(pkgs, scenario)
    assert eng.stats()["shed"] == 1


def test_run_marks_rejected_and_finishes_the_rest(pkgs):
    def scenario(ns):
        eng = ns.engine(queue_cap=1, overload_policy="reject")
        reqs = [_req(ns.Request, i, l_out=2) for i in range(3)]
        eng.run(reqs)
        assert reqs[0].completed
        assert [r.finish_reason for r in reqs[1:]] == ["rejected", "rejected"]
        return eng, reqs
    eng, _ = _both(pkgs, scenario)
    assert eng.stats()["rejected"] == 2


def test_watchdog_reports_capacity_livelock(pkgs):
    """A pool of one page with preemption off: the request's lifetime demand
    (2 pages) is never admitted."""
    msgs = {}

    def scenario(ns):
        eng = ns.engine(max_slots=1, kv_layout="paged", kv_page_size=8, kv_num_pages=2,
                        preemption="none", prefill_chunk_tokens=8)
        r = _req(ns.Request, 5, l_in=10, l_out=4)
        with pytest.raises(ns.Stalled) as ei:
            eng.run([r])
        msgs[ns.Request] = str(ei.value)
        return eng, [r]
    _both(pkgs, scenario)
    assert msgs[Request] == msgs[RefRequest]
    assert "rids=[5]" in msgs[Request] and "free_pages=1/1" in msgs[Request]
    assert "queue_depth=1" in msgs[Request] and "capacity livelock" in msgs[Request]


def test_watchdog_stall_counter(pkgs):
    msgs = {}

    def scenario(ns):
        inj = ns.Injector(0, p_step_error=1.0, p_page_alloc_fail=0.0, p_forced_evict=0.0,
                          p_latency_spike=0.0, max_retries=2)
        eng = ns.engine(injector=inj)
        r = _req(ns.Request, 0)
        with pytest.raises(ns.Stalled) as ei:
            eng.run([r], stall_stages=5)
        msgs[ns.Request] = str(ei.value)
        assert eng.stage_aborts == 5 and inj.counts["step_error"] == 10
        return eng, [r]
    _both(pkgs, scenario)
    assert msgs[Request] == msgs[RefRequest]
    assert "no progress across 5 consecutive stages" in msgs[Request]


def test_stats_reset_window_deltas(pkgs):
    """stats(reset=True) starts a window: the next ``delta`` is the window's
    activity, while the totals keep counting from the engine's start."""
    def scenario(ns):
        eng = ns.engine()
        eng.submit(_req(ns.Request, 0, l_out=2), now=0.0)
        _drain(eng, now=0.0)
        st1 = eng.stats(reset=True)
        assert st1["stages"] > 0 and st1["delta"]["stages"] == st1["stages"]
        r1 = _req(ns.Request, 1, l_out=4)
        eng.submit(r1, now=0.0)
        eng.step(now=0.0)
        eng.cancel(1, now=0.0)
        st2 = eng.stats()
        assert st2["delta"]["stages"] == st2["stages"] - st1["stages"] > 0
        assert st2["delta"]["cancelled"] == 1 and st2["cancelled"] == 1
        assert eng.stats()["delta"] == st2["delta"]     # no reset: the window stays open
        eng.stats(reset=True)
        assert all(v == 0 for v in eng.stats()["delta"].values())
        return eng, [r1]
    eng, _ = _both(pkgs, scenario)
    assert set(eng.stats()["delta"]) == set(ServingEngine.STATS_DELTA_KEYS)


# ---- path g's gates --------------------------------------------------------------
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_g", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_path_g_counters_match_the_smoke_gates():
    """Both of path g's runs on the port's engine on the CPU, narrow (2
    layers, d_model 64, OLMoE's 64 experts top-8 and vocabulary), built by
    the smoke's own functions: every counter the card gates equals the
    smoke's constant, and the CPU run passes the card's other gates."""
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
    reqs = sm.shared_requests(cfg)
    eng = ServingEngine(cfg, params, device="cpu", injector=sm.chaos_injector(),
                        audit_stages=True, **sm.shared_engine_kw(reqs))
    eng.run(reqs)
    assert sm.chaos_counters(eng) == sm.G1_EXPECT
    assert all(r.completed for r in reqs) and sm.drained(eng)
    assert eng.stats()["audit_violations"] == 0
    assert all(v > 0 for k, v in sm.G1_EXPECT["fault_counts"].items()
               if not k.startswith("replica"))       # seed 0 draws all four kinds
    reqs = sm.overload_requests(cfg)
    eng = ServingEngine(cfg, params, device="cpu", audit_stages=True, **sm.OVERLOAD_KW)
    cancelled = sm.drive_overload(eng, reqs)
    assert sm.overload_counters(eng, reqs) == sm.G2_EXPECT
    assert len(cancelled) == 2 and sm.drained(eng)
    assert eng.stats()["audit_violations"] == 0
    assert {r.finish_reason for r in reqs} == {"length", "shed", "expired", "cancelled"}
    exp = sm.G2_EXPECT
    assert min(exp["shed"], exp["expired_deadline"], exp["expired_ttft"],
               exp["aging_promotions"]) > 0
