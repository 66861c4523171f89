"""The port's serving driver: continuous batching with the Duplex dispatch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --kernels \\
      --kv-layout paged --kv-page-size 16 --prefill-chunk 64 --max-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny-moe --device cpu

Port of ``repro/launch/serve.py``: the same flags and report lines, plus
``--device`` (the card by default; ``cpu`` runs the kernels' plain
versions; asking for the card without one raises). Serves seeded random
requests on random weights (``init_model`` seeded with ``--seed``) and
reports T2FT/TBT/E2E and the per-stage dispatch decisions (bandwidth-path
FLOP fraction, k_cold); ``--replicas`` > 1 serves through a ``Fleet``.
``--profile DIR`` wraps the serving loop in ``torch.profiler`` and writes
a Chrome trace into DIR.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from repro_torch.configs import resolve_config
from repro_torch.models.params import init_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.fleet import Fleet, FleetStalledError
from repro_torch.serving.request import Request
from repro_torch.serving.router import ROUTER_POLICIES


@contextlib.contextmanager
def profiled(log_dir, device):
    """Profile exactly the serving loop with ``torch.profiler`` and write
    its Chrome trace under ``log_dir``: on the card its kernels (the device
    timeline, where a stage gap shows; host-op events would multiply the
    trace by the thousands of eager ops a stage makes), on the CPU its
    ops."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CUDA if torch.device(device).type == "cuda"
            else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"serve.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"[serve] profiler trace written under {log_dir} "
          f"(view: Perfetto or chrome://tracing)")


def run_fleet(args, make_engine, injector, reqs) -> int:
    """Serve through a Fleet of replicas; under --chaos, check the fleet's
    ledger and exit nonzero on any violation: a request that finished
    twice or not at all, an audit violation on any replica, or a surviving
    replica whose pool did not drain fully free."""
    fleet = Fleet(make_engine, args.replicas, router=args.router,
                  injector=injector, async_steps=args.async_loop)
    try:
        done = fleet.run(reqs)
    except FleetStalledError as e:
        print(f"[serve] FLEET STALLED: {e}")
        return 1
    n_done = sum(r.completed for r in done)
    fst = fleet.stats()
    print(f"[serve] fleet({args.replicas}x, router={args.router}): "
          f"{n_done}/{len(done)} completed in {fst['ticks']} ticks; "
          f"health: {fst['healthy']} healthy / {fst['degraded']} degraded "
          f"/ {fst['dead']} dead / {fst['retired']} retired")
    print(f"[serve] fleet failover: kills={fst['kills']} "
          f"failovers={fst['failovers']} lost={fst['lost']} "
          f"rejected={fst['rejected']} reasons={fst['finish_reasons']}")
    exactly_once = (fst["terminal"] == fst["submitted"]
                    and fst["duplicate_submits"] == 0)
    audit_viol = sum(s["audit_violations"] for s in fst["per_replica"].values())
    dirty = []
    for rep in fleet.replicas:
        if rep.dead:
            continue            # a dead device's pool is abandoned, not leaked
        kv = rep.engine.kv.stats()
        if kv["active"] != 0 or kv.get("live_pages", 0) != 0:
            dirty.append(rep.id)
    dirty += [rep.id for rep in fleet.retired if rep.drain_clean is False]
    if injector is not None:
        print(f"[serve] chaos(seed={args.chaos}): "
              f"counters={fst['counters']}, "
              f"exactly-once {'OK' if exactly_once else 'VIOLATED'}, "
              f"audit_violations={audit_viol}, "
              f"survivor drain {'DIRTY ' + str(dirty) if dirty else 'clean'}")
        if not exactly_once or audit_viol or dirty:
            for rep in fleet.replicas + fleet.retired:
                for line in rep.engine.audit_log[:5]:
                    print(f"[serve]   audit r{rep.id}: {line}")
            return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="tiny-moe")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--l-in", type=int, default=32)
    p.add_argument("--l-out", type=int, default=16)
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--kv-layout", choices=("dense", "paged"), default="dense",
                   help="paged = shared KV page pool; decode streams live pages only "
                        "(full-attention decoder archs)")
    p.add_argument("--kv-page-size", type=int, default=64)
    p.add_argument("--prefix-share", action="store_true",
                   help="refcounted copy-on-write prefix sharing (paged only): prompts "
                        "sharing a full-page prefix map the resident pages at refcount+1 "
                        "and skip those prefill stages")
    p.add_argument("--oversubscribe", type=float, default=None, metavar="F",
                   help="paged only: size the page pool at F x the dense worst case "
                        "(e.g. 0.5) and enable recompute preemption")
    p.add_argument("--preemption", choices=("none", "migrate", "recompute"), default=None,
                   help="eviction policy under capacity pressure (default: none, or "
                        "recompute when --oversubscribe is set; migrate is dense-only)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache (+fp32 per-token scales): halves the streamed "
                        "decode KV bytes; either --kv-layout")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="chunked prefill token budget per stage; default = monolithic "
                        "whole-prompt prefill")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request finish deadline (ms after arrival): the per-stage "
                        "expiry sweep EXPIREs past-deadline work")
    p.add_argument("--queue-cap", type=int, default=None,
                   help="bound the admission queue; what happens when it fills is "
                        "--overload-policy")
    p.add_argument("--overload-policy",
                   choices=("reject", "shed-oldest", "shed-past-deadline"),
                   default="reject",
                   help="full-queue behavior: reject new work, shed the oldest queued "
                        "request, or shed queued requests already past deadline")
    p.add_argument("--chaos", type=int, default=None, metavar="SEED",
                   help="deterministic fault injection with a per-stage KV audit; exits "
                        "nonzero on any violation or a dirty drain; with --replicas >1 "
                        "the forked per-replica streams also draw whole-replica kills "
                        "and latency spikes")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve through a fleet of N engine replicas behind --router, "
                        "with health tracking and exactly-once failover (default 1 = "
                        "single engine, no fleet layer)")
    p.add_argument("--router", choices=ROUTER_POLICIES, default="affinity",
                   help="fleet placement policy (--replicas >1): 'affinity' scores "
                        "replicas by resident-prefix match length minus load; "
                        "'round-robin' cycles blindly")
    p.add_argument("--async", dest="async_loop", action="store_true",
                   help="pipelined serving loop (run_async); with --replicas >1 every "
                        "replica steps pipelined")
    p.add_argument("--spec-k", type=int, default=0, metavar="K",
                   help="self-speculative decoding (greedy only): draft up to K tokens "
                        "per decode row by n-gram lookup over the request's own stream "
                        "(default 0 = off)")
    p.add_argument("--spec-ngram", type=int, default=3, metavar="N",
                   help="tail n-gram length the drafter matches (with --spec-k)")
    p.add_argument("--aging-rounds", type=int, default=None, metavar="K",
                   help="priority aging: promote a queued request one band per K "
                        "admission rounds it was skipped")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="wrap the serving loop in torch.profiler and write its Chrome "
                        "trace into DIR (inspect with Perfetto)")
    p.add_argument("--no-duplex", action="store_true")
    p.add_argument("--kernels", action="store_true",
                   help="run the hand-written kernels (their plain versions on the "
                        "CPU); with duplex this enables the ragged count-threaded MoE")
    p.add_argument("--no-moe-ragged", action="store_true",
                   help="with --kernels: the capacity-padded MoE kernels instead of "
                        "the ragged ones")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where to serve: the card (default) or cpu")
    args = p.parse_args(argv)

    cfg = resolve_config(args.arch, args.reduced)
    if cfg.is_encoder_decoder:
        raise SystemExit("enc-dec archs serve via serve_step (see dryrun)")
    if ((args.prefix_share or args.oversubscribe is not None)
            and args.kv_layout != "paged"):
        raise SystemExit("--prefix-share/--oversubscribe need --kv-layout paged")
    num_pages = None
    preemption = args.preemption or "none"
    if args.oversubscribe is not None:
        if args.oversubscribe <= 0:
            raise SystemExit("--oversubscribe needs a positive pool factor")
        dense_pages = args.max_slots * (-(-args.max_len // args.kv_page_size))
        num_pages = 1 + max(2, int(args.oversubscribe * dense_pages))
        if args.preemption is None:
            preemption = "recompute"
    params = init_model(cfg, seed=args.seed, device=args.device)
    fleet_mode = args.replicas > 1
    injector = None
    if args.chaos is not None:
        # fleet chaos adds whole-replica faults on top of the engine-level
        # schedule; each replica draws from its own forked stream
        kw = dict(p_replica_kill=0.015, p_replica_spike=0.03) if fleet_mode else {}
        injector = FaultInjector(args.chaos, **kw)

    def make_engine(replica_id=0, child_injector=None):
        del replica_id  # replicas are homogeneous; the id is the fleet's
        return ServingEngine(cfg, params, max_slots=args.max_slots,
                             max_len=args.max_len,
                             kv_layout=args.kv_layout,
                             kv_page_size=args.kv_page_size,
                             kv_num_pages=num_pages,
                             kv_quant=args.kv_quant,
                             prefix_share=args.prefix_share,
                             preemption=preemption,
                             use_duplex=not args.no_duplex,
                             use_kernels=args.kernels,
                             moe_ragged=not args.no_moe_ragged,
                             prefill_chunk_tokens=args.prefill_chunk,
                             queue_cap=args.queue_cap,
                             overload_policy=args.overload_policy,
                             aging_rounds=args.aging_rounds,
                             spec_k=args.spec_k,
                             spec_ngram=args.spec_ngram,
                             injector=child_injector if fleet_mode else injector,
                             device=args.device)

    eng = None if fleet_mode else make_engine()
    rng = np.random.default_rng(args.seed)
    # with --prefix-share, most requests open with a common full-page
    # system prefix (the workload sharing exploits)
    sys_prefix = (rng.integers(0, cfg.vocab_size, 2 * args.kv_page_size).tolist()
                  if args.prefix_share else [])
    reqs = []
    t0 = time.monotonic()
    for i in range(args.requests):
        l_in = max(4, int(rng.normal(args.l_in, args.l_in * 0.2)))
        prompt = rng.integers(0, cfg.vocab_size, l_in).tolist()
        if args.prefix_share and i % 10 != 0:
            prompt = (sys_prefix + prompt)[:args.max_len - args.l_out - 1]
        deadline = (t0 + args.deadline_ms / 1e3 if args.deadline_ms is not None else None)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=args.l_out,
                            arrival_time=t0, deadline=deadline))
    if fleet_mode:
        with profiled(args.profile, args.device):
            return run_fleet(args, make_engine, injector, reqs)
    with profiled(args.profile, args.device):
        done = eng.run_async(reqs) if args.async_loop else eng.run(reqs)
    n_done = sum(r.completed for r in done)
    tbts = [t for r in done for t in r.tbts()]
    mixed = sum(1 for r in eng.reports if r.is_mixed)
    med_tbt = np.median(tbts) * 1e3 if tbts else float("nan")
    print(f"[serve] {cfg.name}: {n_done}/{len(done)} completed, "
          f"stages={len(eng.reports)} (mixed={mixed}), "
          f"median TBT={med_tbt:.1f}ms")
    bw = [r.bandwidth_flop_fraction for r in eng.reports if not r.is_mixed]
    kc = [r.k_cold for r in eng.reports]
    print(f"[serve] decode-stage bandwidth-path FLOP fraction: "
          f"{np.mean(bw):.3f}; k_cold (planner): min={min(kc)} max={max(kc)}")
    moe_b = sum(r.moe_bytes_streamed for r in eng.reports)
    if moe_b:
        live = sum(r.moe_flops_live for r in eng.reports)
        padded = sum(r.moe_flops_padded for r in eng.reports)
        print(f"[serve] MoE streamed bytes={moe_b/1e6:.2f}MB "
              f"({'ragged' if eng.moe_ragged else 'padded'} kernels); "
              f"live/padded FLOPs={live/max(padded, 1):.2f}")
    st = [r.stage_tokens for r in eng.reports]
    mode = (f"chunked@{args.prefill_chunk}" if args.prefill_chunk else "monolithic")
    print(f"[serve] per-stage tokens ({mode} prefill): "
          f"mean={np.mean(st):.1f} std={np.std(st):.1f} max={max(st)}")
    kvb = [r.kv_bytes_streamed for r in eng.reports if r.kv_bytes_streamed]
    flavor = f"{args.kv_layout}/{'int8+scales' if args.kv_quant else 'fp'}"
    if kvb:
        print(f"[serve] streamed KV bytes/stage ({flavor}): "
              f"mean={np.mean(kvb)/1e3:.1f}kB max={max(kvb)/1e3:.1f}kB "
              f"total={sum(kvb)/1e6:.2f}MB")
    if args.prefix_share:
        shp = max((r.shared_kv_pages for r in eng.reports), default=0)
        print(f"[serve] prefix sharing: {eng.shared_tokens_skipped} prefill "
              f"positions skipped, peak shared pages={shp}, "
              f"COW copies={eng.kv.cow_copies}")
    if preemption != "none" or args.oversubscribe is not None:
        print(f"[serve] preemption({preemption}): {eng.preemptions} "
              f"evictions, peak concurrent batch={eng.peak_active}")
    st2 = eng.stats()
    if args.async_loop:
        gap_ms = st2["host_gap_s"] * 1e3 / max(st2["gap_stages"], 1)
        print(f"[serve] async loop: spec_hits={st2['spec_hits']} "
              f"spec_misses={st2['spec_misses']} "
              f"host stage-gap mean={gap_ms:.3f}ms "
              f"over {st2['gap_stages']} gaps")
    if args.spec_k > 0:
        print(f"[serve] spec decode(k={args.spec_k}, ngram={args.spec_ngram}): "
              f"proposed={st2['spec_proposed']} "
              f"accepted={st2['spec_accepted']} "
              f"(rate={st2['spec_acceptance']:.2f}), "
              f"rewinds={st2['spec_rewinds']}")
    if args.aging_rounds is not None:
        print(f"[serve] priority aging(K={args.aging_rounds}): "
              f"{st2['aging_promotions']} promotions")
    if (args.queue_cap is not None or args.deadline_ms is not None
            or injector is not None):
        print(f"[serve] robustness: shed={st2['shed']} "
              f"expired={st2['expired']} cancelled={st2['cancelled']} "
              f"rejected={st2['rejected']} retries={st2['retries']} "
              f"stage_aborts={st2['stage_aborts']} "
              f"audit_violations={st2['audit_violations']}")
    if injector is not None:
        kv = st2["kv"]
        dirty = (kv["active"] != 0 or (args.kv_layout == "paged"
                                       and kv["live_pages"] != 0))
        print(f"[serve] chaos(seed={args.chaos}): faults="
              f"{st2['fault_counts']}, drain {'DIRTY' if dirty else 'clean'}")
        if st2["audit_violations"] or dirty:
            for line in eng.audit_log[:20]:
                print(f"[serve]   audit: {line}")
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
