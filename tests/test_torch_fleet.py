"""PyTorch port, the serving fleet (``serving/fleet.py``, ``serving/router.py``):

* ``tests/test_fleet.py``'s tests mirrored on the port alone: the routers,
  the degraded penalty, failover with token parity, ``failover=False``,
  the duplicate-submit guard, drain, join, spike recovery, the watchdog,
  fork streams and the chaos soak (seeds 0-2);
* three scenarios through both packages' ``Fleet`` on the same weights
  (``small_test_config("fleet-test")``, no kernels in either): affinity
  routing of a shared-prefix workload, the deterministic kill with
  failover, and the chaos soak with seed 0; each request's owner and
  tokens and the fleet's ``stats()`` equal;
* a draining replica with a pipelined stage in flight is not retired
  until that stage commits (the reference retires it with the requests the
  stage admitted: ROADMAP queue 3);
* path j of ``chip_smoke.py``: its three runs built by the smoke's own
  functions on a narrow OLMoE on the CPU, every counter the card gates
  equal to ``J_EXPECT``.
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
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.faults import FaultInjector as RefInjector
from repro.serving.fleet import Fleet as RefFleet
from repro.serving.request import Request as RefRequest
from repro_torch.configs import small_test_config as t_small_test_config
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.fleet import Fleet, FleetStalledError, ReplicaHealth
from repro_torch.serving.request import Request
from repro_torch.serving.router import AffinityRouter, RoundRobinRouter, make_router

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pkgs():
    cfg_j = small_test_config("fleet-test")
    pj = init_model(jax.random.PRNGKey(0), cfg_j)
    cfg = t_small_test_config("fleet-test")
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    ref = SimpleNamespace(
        cfg=cfg_j, make=lambda inj, **kw: RefEngine(cfg_j, pj, injector=inj, **kw),
        Fleet=RefFleet, Request=RefRequest, Injector=RefInjector)
    port = SimpleNamespace(cfg=cfg, make=lambda inj, **kw: ServingEngine(
        cfg, pt, injector=inj, use_kernels=False, device="cpu", **kw),
        Fleet=Fleet, Request=Request, Injector=FaultInjector)
    return ref, port


def _factory(pkg, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("use_duplex", False)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("kv_page_size", 8)
    kw.setdefault("prefix_share", True)
    kw.setdefault("preemption", "recompute")
    kw.setdefault("prefill_chunk_tokens", 8)

    def make(i, injector):
        del i
        return pkg.make(injector, **kw)
    return make


def _req(R, rid, vocab, l_in=12, l_out=4, prefix=None, **kw):
    rng = np.random.default_rng(1000 + rid)
    prompt = (prefix or []) + rng.integers(0, vocab, l_in).tolist()
    return R(rid=rid, prompt=prompt, max_new_tokens=l_out, **kw)


def _drive(fleet, max_ticks=2000):
    for _ in range(max_ticks):
        if not fleet.has_work:
            break
        fleet.step(now=0.0)
    assert not fleet.has_work, "fleet did not drain"


def _assert_survivors_clean(fleet):
    for rep in fleet.replicas:
        if rep.dead:
            continue
        assert rep.engine.kv.live_pages == 0, f"r{rep.id} leaked pages"
        assert rep.engine.kv.free_slots == rep.engine.kv.max_slots
        assert rep.engine.kv.audit(pins={}) == [], f"r{rep.id} dirty audit"
        assert rep.engine.stats()["audit_violations"] == 0


def _summary(fleet, reqs):
    """What the parity scenarios compare: each request's owner, tokens and
    finish reason, the fleet's stats() without the per-replica engine
    totals, and each replica's health and stage count."""
    st = fleet.stats()
    per = st.pop("per_replica")
    return dict(owners=[fleet._owner[r.rid].id for r in reqs],
                tokens=[list(r.output) for r in reqs],
                reasons=[r.finish_reason for r in reqs], stats=st,
                replicas={i: (s["health"], s["draining"], s["stages"], s["preemptions"],
                              s["shared_tokens_skipped"]) for i, s in per.items()})


# ---- routers ---------------------------------------------------------------
def test_make_router_and_unknown_policy():
    assert isinstance(make_router("affinity"), AffinityRouter)
    assert isinstance(make_router("round-robin"), RoundRobinRouter)
    with pytest.raises(ValueError):
        make_router("random")


def test_round_robin_cycles_replicas(pkgs):
    _, port = pkgs
    fleet = Fleet(_factory(port), 3, router="round-robin")
    owners = [fleet.submit(_req(Request, i, port.cfg.vocab_size), now=0.0).id
              for i in range(6)]
    assert owners == [0, 1, 2, 0, 1, 2]
    _drive(fleet)
    _assert_survivors_clean(fleet)


def _affinity_scenario(pkg):
    """The mirrored affinity test's steps; returns (fleet, requests)."""
    fleet = pkg.Fleet(_factory(pkg), 2, router="affinity")
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, pkg.cfg.vocab_size, 16).tolist()   # 2 full pages
    donor = _req(pkg.Request, 0, pkg.cfg.vocab_size, prefix=prefix, l_out=12)
    rep0 = fleet.submit(donor, now=0.0)
    # prefill the donor until BOTH prefix pages are registered on rep0
    for _ in range(15):
        fleet.step(now=0.0)
        if len(rep0.engine.kv.match_prefix(prefix)) == 2:
            break
    assert len(rep0.engine.kv.match_prefix(prefix)) == 2
    follower = _req(pkg.Request, 1, pkg.cfg.vocab_size, prefix=prefix, l_out=4)
    assert fleet.router.shared_tokens(rep0, follower) == 16
    # the follower co-locates with its resident prefix although rep0 is the
    # more loaded replica, a prefix-less request balances to the idle one
    assert fleet.submit(follower, now=0.0) is rep0
    stranger = _req(pkg.Request, 2, pkg.cfg.vocab_size, l_out=4)
    assert fleet.submit(stranger, now=0.0).id == 1
    _drive(fleet)
    reqs = [donor, follower, stranger]
    assert all(r.completed for r in reqs)
    assert rep0.engine.shared_tokens_skipped >= 16
    _assert_survivors_clean(fleet)
    return fleet, reqs


def test_affinity_routes_to_resident_prefix(pkgs):
    _affinity_scenario(pkgs[1])


def test_affinity_routing_matches_the_reference(pkgs):
    ref, port = pkgs
    got, want = (_summary(*_affinity_scenario(p)) for p in (port, ref))
    assert got == want
    assert got["owners"] == [0, 0, 1]


def test_affinity_penalizes_degraded_replica(pkgs):
    _, port = pkgs
    fleet = Fleet(_factory(port), 2, router="affinity")
    fleet.replicas[0].health = ReplicaHealth.DEGRADED
    req = _req(Request, 0, port.cfg.vocab_size)
    assert [rep.id for rep in fleet.router.order(fleet.admittable, req)] == [1, 0]


# ---- failover ---------------------------------------------------------------
def _kill_scenario(pkg):
    """The failover test's killed fleet: six requests over two replicas,
    replica 0 killed once one of its requests has a token."""
    fleet = pkg.Fleet(_factory(pkg), 2, router="round-robin")
    rs = [_req(pkg.Request, i, pkg.cfg.vocab_size, l_out=6) for i in range(6)]
    for r in rs:
        fleet.submit(r, now=0.0)
    victims = [r for r in rs if fleet._owner[r.rid].id == 0]
    assert victims
    for _ in range(50):
        fleet.step(now=0.0)
        if any(r.output for r in victims):
            break
    assert any(not r.done for r in victims)
    fleet.kill(0, now=0.0)
    assert fleet.kills == 1 and fleet.failovers > 0
    # every in-flight victim now lives on the survivor, with a priority
    # boost so that it is not evicted at once
    for r in victims:
        if not r.done:
            assert fleet._owner[r.rid].id == 1
            assert r.priority >= fleet.failover_priority
    _drive(fleet)
    st = fleet.stats()
    assert all(r.completed for r in rs)
    assert st["terminal"] == st["submitted"] == len(rs)   # exactly once
    assert st["duplicate_submits"] == 0 and st["lost"] == 0
    _assert_survivors_clean(fleet)
    return fleet, rs


def test_failover_exactly_once_with_token_parity(pkgs):
    _, port = pkgs
    ref = Fleet(_factory(port), 2, router="round-robin")
    ref_reqs = [_req(Request, i, port.cfg.vocab_size, l_out=6) for i in range(6)]
    for r in ref_reqs:
        ref.submit(r, now=0.0)
    _drive(ref)
    _, rs = _kill_scenario(port)
    # failover never generates a delivered token again: greedy parity holds
    assert [r.output for r in rs] == [r.output for r in ref_reqs]


def test_failover_matches_the_reference(pkgs):
    ref, port = pkgs
    got, want = (_summary(*_kill_scenario(p)) for p in (port, ref))
    assert got == want


def test_failover_disabled_strands_requests(pkgs):
    _, port = pkgs
    fleet = Fleet(_factory(port), 2, router="round-robin", failover=False)
    rs = [_req(Request, i, port.cfg.vocab_size, l_out=6) for i in range(6)]
    for r in rs:
        fleet.submit(r, now=0.0)
    fleet.step(now=0.0)
    victims = [r for r in rs if fleet._owner[r.rid].id == 0 and not r.done]
    assert victims
    fleet.kill(0, now=0.0)
    assert fleet.failovers == 0 and fleet.lost == len(victims)
    assert all(r.finish_reason == "lost" for r in victims)
    _drive(fleet)
    st = fleet.stats()
    assert st["terminal"] == st["submitted"]   # lost is a terminal state
    assert all(r.completed for r in rs if r not in victims)
    _assert_survivors_clean(fleet)


def test_duplicate_submit_guard(pkgs):
    _, port = pkgs
    fleet = Fleet(_factory(port), 2)
    r = _req(Request, 0, port.cfg.vocab_size)
    fleet.submit(r, now=0.0)
    with pytest.raises(ValueError, match="already live"):
        fleet.submit(r, now=0.0)
    assert fleet.duplicate_submits == 1
    _drive(fleet)


# ---- drain / join and leave ------------------------------------------------
def test_drain_retires_replica_and_releases_pool(pkgs):
    _, port = pkgs
    fleet = Fleet(_factory(port), 2, router="round-robin")
    a = _req(Request, 0, port.cfg.vocab_size, l_out=6)
    rep0 = fleet.submit(a, now=0.0)
    assert rep0.id == 0
    fleet.drain(0)
    # new work routes around the draining replica, while its request
    # finishes normally
    b = _req(Request, 1, port.cfg.vocab_size, l_out=4)
    assert fleet.submit(b, now=0.0).id == 1
    _drive(fleet)
    assert a.completed and b.completed
    assert len(fleet.replicas) == 1 and len(fleet.retired) == 1
    retired = fleet.retired[0]
    assert retired.id == 0 and retired.drain_clean is True
    assert retired.engine.kv.cache is None     # pool released
    assert retired.engine.stats()["kv"]["bytes_per_slot"] == 0
    _assert_survivors_clean(fleet)


def test_join_scales_up_and_serves(pkgs):
    _, port = pkgs
    fleet = Fleet(_factory(port), 1, router="round-robin")
    rep = fleet.join()
    assert rep.id == 1 and len(fleet.replicas) == 2
    owners = {fleet.submit(_req(Request, i, port.cfg.vocab_size), now=0.0).id
              for i in range(4)}
    assert owners == {0, 1}           # the joiner takes traffic
    fleet.leave(0)
    _drive(fleet)
    assert all(r.completed for r in fleet._requests.values())
    assert [rep.id for rep in fleet.replicas] == [1]
    assert fleet.retired[0].drain_clean is True


def test_draining_replica_keeps_its_stage_in_flight(pkgs):
    """With ``async_steps`` the first tick dispatches a stage that admits
    the only queued request: it is then in none of the scheduler's lists
    until the commit. The port retires the draining replica only after
    that stage commits and the request finishes; the reference retires it
    at once, stranding the request on a replica no tick steps."""
    ref, port = pkgs
    for pkg in (port, ref):
        fleet = pkg.Fleet(_factory(pkg), 2, router="round-robin", async_steps=True)
        r = _req(pkg.Request, 0, pkg.cfg.vocab_size, l_out=3)
        assert fleet.submit(r, now=0.0).id == 0
        fleet.drain(0)
        fleet.step(now=0.0)
        sch = fleet._owner[0].engine.scheduler
        assert not sch.has_work and not r.done
        if pkg is ref:
            assert [rep.id for rep in fleet.retired] == [0]      # the reference's fault
            continue
        assert not fleet.retired
        _drive(fleet)
        assert r.completed and len(r.output) == 3
        assert [rep.id for rep in fleet.retired] == [0] and fleet.retired[0].drain_clean
        _assert_survivors_clean(fleet)


# ---- health state machine ---------------------------------------------------
def test_replica_spike_degrades_then_recovers(pkgs):
    _, port = pkgs
    inj = FaultInjector(0, p_page_alloc_fail=0.0, p_forced_evict=0.0, p_step_error=0.0,
                        p_latency_spike=0.0, p_replica_spike=1.0, replica_spike_s=0.5)
    fleet = Fleet(_factory(port), 1, injector=inj, degrade_ticks=2)
    rep = fleet.replicas[0]
    fleet.submit(_req(Request, 0, port.cfg.vocab_size, l_out=4), now=0.0)
    fleet.step(now=0.0)
    assert rep.health is ReplicaHealth.DEGRADED
    assert rep.engine.fault_delay >= 0.5       # the spike hit the clock
    rep.injector.p_replica_spike = 0.0         # spikes stop...
    for _ in range(fleet.degrade_ticks + 1):
        fleet.step(now=0.0)
    assert rep.health is ReplicaHealth.HEALTHY  # ...and the replica recovers
    _drive(fleet)


def test_watchdog_raises_on_fleet_stall(pkgs):
    _, port = pkgs
    # a pool of one page with preemption off: the request's demand can never
    # be admitted on any replica, a fleet-wide livelock
    factory = _factory(port, max_slots=1, kv_num_pages=2, preemption="none",
                       prefix_share=False)
    fleet = Fleet(factory, 2, router="round-robin")
    with pytest.raises(FleetStalledError) as ei:
        fleet.run([_req(Request, 5, port.cfg.vocab_size, l_in=10, l_out=4)],
                  stall_ticks=10)
    msg = str(ei.value)
    assert "no fleet-wide progress" in msg and "rids=[5]" in msg


def test_fork_streams_are_deterministic_and_independent():
    base = FaultInjector(9, p_replica_kill=0.3, p_replica_spike=0.3)
    a1, a2, b = base.fork(0), base.fork(0), base.fork(1)

    def seq(inj):
        return [(inj.replica_kill(), inj.replica_spike()) for _ in range(100)]

    sa1, sa2, sb = seq(a1), seq(a2), seq(b)
    assert sa1 == sa2                 # same replica index -> same stream
    assert sa1 != sb                  # siblings draw independently
    assert base.counts["replica_kill"] == 0   # parent stream untouched
    ref = RefInjector(9, p_replica_kill=0.3, p_replica_spike=0.3).fork(1)
    assert seq(ref) == sb


# ---- the fleet chaos soak ----------------------------------------------------
def _soak(pkg, seed):
    inj = pkg.Injector(seed, p_page_alloc_fail=0.03, p_forced_evict=0.05, p_step_error=0.03,
                       p_latency_spike=0.03, p_replica_kill=0.02, p_replica_spike=0.04,
                       max_retries=4)
    fleet = pkg.Fleet(_factory(pkg), 3, router="affinity", injector=inj, min_live=1)
    rng = np.random.default_rng(42)
    sys_prefix = rng.integers(0, pkg.cfg.vocab_size, 16).tolist()
    reqs = [_req(pkg.Request, i, pkg.cfg.vocab_size, prefix=sys_prefix if i % 3 else None,
                 l_in=6 + i % 5, l_out=5) for i in range(12)]
    fleet.run(reqs, max_ticks=3000, stall_ticks=1000)
    st = fleet.stats()
    # exactly once: every accepted request reached one terminal state
    assert st["terminal"] == st["submitted"] == len(reqs)
    assert st["duplicate_submits"] == 0
    assert st["lost"] == 0            # failover leaves nothing stranded
    assert all(r.completed for r in reqs)
    assert all(len(r.output) == 5 for r in reqs)   # no double generation
    for rid_, s in st["per_replica"].items():
        assert s["audit_violations"] == 0, f"replica {rid_} audit dirty"
    _assert_survivors_clean(fleet)
    child_faults = sum(rep.injector.total_faults for rep in fleet.replicas + fleet.retired)
    assert child_faults > 0, "fleet soak drew no faults"
    return fleet, reqs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_chaos_soak_exactly_once(pkgs, seed):
    _soak(pkgs[1], seed)


def test_chaos_soak_matches_the_reference(pkgs):
    """Seed 0 of the soak through both fleets: owners, tokens, reasons, the
    fleet's ledger and counters and each replica's schedule."""
    ref, port = pkgs
    got, want = (_summary(*_soak(p, 0)) for p in (port, ref))
    assert got == want
    assert got["stats"]["kills"] + got["stats"]["kills_suppressed"] > 0 or \
        got["stats"]["counters"]["stage_aborts"] > 0


# ---- path j's gates ------------------------------------------------------------
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_j", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_path_j_counters_match_the_smoke_gates():
    """Path j's three runs on the port's engine on the CPU, narrow (2
    layers, d_model 64, OLMoE's 64 experts top-8 and vocabulary), built by
    the smoke's own functions: every counter the card gates equals
    ``J_EXPECT``, the card's other host gates pass, affinity skips more
    shared prompt positions than round-robin, and j3 kills and fails over
    with a replica retired and a joiner serving."""
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
    got = {}
    for run in sm.FLEET_RUNS:
        fleet, reqs = sm.fleet_run(cfg, params, run, device="cpu")
        assert sm.fleet_gates(fleet, reqs) == [], run
        got[run[0]] = sm.fleet_counters(fleet)
        if run[0] == "j3":
            assert fleet.retired and fleet.retired[0].drain_clean
            assert got["j3"]["routed"][3] > 0             # the joiner served
    assert got == sm.J_EXPECT
    skipped = {k: sum(v["skipped"].values()) for k, v in got.items()}
    assert skipped["j1"] > skipped["j2"]
    assert got["j3"]["kills"] >= 1 and got["j3"]["failovers"] >= 1
