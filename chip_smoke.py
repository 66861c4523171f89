#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, OLMoE-1B-7B at full width
    python3 chip_smoke.py --kernels-only

Phases, each printing a line:
  1. environment: torch / CUDA versions and the card's name and power limit;
  2. kernel build (nvcc, all sources in parallel) and its time;
  3. each hand-written kernel against its plain PyTorch version on the card
     at OLMoE-1B-7B shapes (plus a GQA shape for the attention kernels), in
     bfloat16 within its rounding band and again in float32 within 1e-4:
     max error and tolerance, kernel / plain / library time, and the
     kernel's bound (least bytes / 3.35 TB/s or operations over the peak
     rate of the inputs' type: 989 TFLOP/s bf16, 67 TFLOP/s float32);
  4. the main path: ``ServingEngine`` serving 16 seeded requests on
     OLMoE-1B-7B at full width and depth with random weights, paged KV
     (page 16), chunked prefill (64) and the duplex ragged MoE; checks that
     every request completes with in-vocabulary tokens, that each kernel was
     launched on the main path, and that one mixed stage's logits through
     the kernels agree with the plain (kernel-free) torch path.

Prints a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` as the
last line. Any failure raises, and the exit code is non-zero. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,   # H100 SXM dense bf16 tensor-core peak
              "float32": 67e12}     # H100 SXM float32 outside the tensor cores
TOL = {"bfloat16": 2e-2,            # bf16 rounding of outputs of magnitude ~4
       "float32": 1e-4}             # float32 sums in another order


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pools(torch, gen, P, KV, page, hd, dtype):
    k = torch.randn((P, KV, page, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((P, KV, page, hd), generator=gen, device="cuda").to(dtype)
    return k, v


def _tables(torch, gen, lens, page, maxp, P):
    """Block tables giving each sequence its own random live pages; unused
    columns hold the null page 0."""
    ids = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).tolist()
    bt = torch.zeros((len(lens), maxp), dtype=torch.int32)
    nxt = 0
    for b, n in enumerate(lens):
        need = min(-(-n // page), maxp)
        bt[b, :need] = torch.tensor(ids[nxt:nxt + need], dtype=torch.int32)
        nxt += need
    return bt.cuda()


def check_decode(torch, gen, dtype, *, KV, qpk, window=0, softcap=0.0):
    from repro_torch.kernels import decode_attn as da
    B, hd, page, maxp = 16, 128, 16, 64
    P = 1 + B * maxp
    lens = [0, 1, 15, 16, 17, 100, 257, 511, 512, 640, 700, 800, 900, 1000,
            1023, 1024]
    kp, vp = _pools(torch, gen, P, KV, page, hd, dtype)
    bt = _tables(torch, gen, lens, page, maxp, P)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn((B, KV, qpk, hd), generator=gen, device="cuda").to(dtype)
    kw = dict(window=window, softcap=softcap)
    got = da.paged_decode_attention_kernel(q, kp, vp, lengths, bt, **kw)
    want = da.paged_decode_attention_plain(q, kp, vp, lengths, bt, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ms = time_ms(lambda: da.paged_decode_attention_kernel(q, kp, vp, lengths, bt, **kw))
    plain_ms = time_ms(lambda: da.paged_decode_attention_plain(q, kp, vp, lengths, bt, **kw))
    live = [min(n, maxp * page) if not window else min(n, window) for n in lens]
    item = q.element_size()
    nbytes = (sum(live) * KV * hd * 2 * item + 2 * q.numel() * item
              + B * 4 + sum(-(-n // page) for n in live) * 4)
    flops = sum(live) * KV * qpk * hd * 4
    # library yardstick: SDPA over the same K/V gathered dense, with the mask
    kd = da._gather_pages(kp, bt)
    vd = da._gather_pages(vp, bt)
    kpos = torch.arange(maxp * page, device="cuda")[None]
    valid = kpos < lengths.long()[:, None]
    if window:
        valid &= kpos > lengths.long()[:, None] - 1 - window
    mask = valid[:, None, None, :]
    lib_ms = None
    if not softcap:
        qs = q.reshape(B, KV, qpk, hd)
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kd, vd, attn_mask=mask))
    return err, want.float().abs().max().item(), ms, plain_ms, lib_ms, nbytes, flops


def check_chunk(torch, gen, dtype, *, KV, qpk):
    from repro_torch.kernels import decode_attn as da
    hd, page, maxp, Sc = 128, 16, 64, 64
    starts = [0, 64, 448, 0]
    clens = [64, 64, 30, 0]           # a short chunk and a padded row
    totals = [s + c for s, c in zip(starts, clens)]
    B = len(starts)
    P = 1 + B * maxp
    kp, vp = _pools(torch, gen, P, KV, page, hd, dtype)
    bt = _tables(torch, gen, totals, page, maxp, P)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    tot = torch.tensor(totals, dtype=torch.int32, device="cuda")
    q = torch.randn((B, KV, Sc * qpk, hd), generator=gen, device="cuda").to(dtype)
    got = da.chunked_prefill_attention_kernel(q, kp, vp, tot, st, bt, qpk=qpk)
    want = da.chunked_prefill_attention_plain(q, kp, vp, tot, st, bt, qpk=qpk)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ms = time_ms(lambda: da.chunked_prefill_attention_kernel(q, kp, vp, tot, st, bt, qpk=qpk))
    plain_ms = time_ms(lambda: da.chunked_prefill_attention_plain(
        q, kp, vp, tot, st, bt, qpk=qpk))
    item = q.element_size()
    nbytes = sum(totals) * KV * hd * 2 * item + 2 * q.numel() * item
    # live (row, key) pairs: row at chunk position i attends keys <= start+i
    pairs = 0
    for s, c, t in zip(starts, clens, totals):
        for i in range(Sc):
            pairs += min(s + i + 1, t)
    flops = pairs * KV * qpk * hd * 4
    kd = da._gather_pages(kp, bt)
    vd = da._gather_pages(vp, bt)
    R = Sc * qpk
    qpos = st.long()[:, None] + torch.arange(R, device="cuda")[None] // qpk
    kpos = torch.arange(maxp * page, device="cuda")
    mask = ((kpos[None, None] <= qpos[:, :, None])
            & (kpos[None, None] < tot.long()[:, None, None]))[:, None]
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kd, vd, attn_mask=mask))
    return err, want.float().abs().max().item(), ms, plain_ms, lib_ms, nbytes, flops


def _experts(torch, gen, dtype, E, d, f):
    def w(*shape, fan_in):
        return (torch.randn(shape, generator=gen, device="cuda")
                / fan_in ** 0.5).to(dtype)
    return w(E, d, f, fan_in=d), w(E, d, f, fan_in=d), w(E, f, d, fan_in=f)


def check_moe(torch, gen, dtype, *, hot: bool, C: int = 48):
    """hot: E - k_cold = 32 hot experts with capacity C; cold: 48 cold
    experts with capacity 48 (a 272-token stage at k_cold 48)."""
    from repro_torch.kernels import moe_gemm, moe_gemv
    E, d, f = 64, 2048, 1024
    if hot:
        n = E - 32
        # at C=128 (c_block 64) C//2 and C//2 + 1 are c_block and c_block + 1
        base = [0, 1, 2, 3, C // 2, C // 2 + 1, C - 1, C]
        kernel, plain = moe_gemm.ragged_moe_gemm_kernel, moe_gemm.ragged_moe_gemm_plain
    else:
        n, C = 48, 48
        base = [0, 1, 48, 0, 5, 2, 47, 3]
        kernel, plain = moe_gemv.ragged_moe_gemv_kernel, moe_gemv.ragged_moe_gemv_plain
    rest = torch.randint(0, C + 1, (n - len(base),), generator=gen, device="cuda").tolist()
    counts_l = base + rest
    counts = torch.tensor(counts_l, dtype=torch.int32, device="cuda")
    perm = torch.randperm(E, generator=gen, device="cuda")[:n].to(torch.int32)
    wg, wu, wo = _experts(torch, gen, dtype, E, d, f)
    x = torch.randn((n, C, d), generator=gen, device="cuda").to(dtype)
    got = kernel(x, wg, wu, wo, perm, counts)
    want = plain(x, wg, wu, wo, perm, counts)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ms = time_ms(lambda: kernel(x, wg, wu, wo, perm, counts))
    plain_ms = time_ms(lambda: plain(x, wg, wu, wo, perm, counts), iters=5)
    item = x.element_size()
    live_experts = sum(1 for c in counts_l if c > 0)
    nbytes = (live_experts * 3 * d * f * item + sum(counts_l) * d * item
              + x.numel() * item + 2 * n * 4)
    flops = 2 * 3 * d * f * sum(counts_l)
    return err, want.float().abs().max().item(), ms, plain_ms, None, nbytes, flops


KERNELS = [
    # name, TPU kernel it replaces, source, [(case label, check fn, kwargs)];
    # every case runs in bfloat16 (the main path's dtype; the first case is
    # the main path's shape) and again in float32
    ("paged_decode_attention",
     "src/repro/kernels/decode_attn.py:280",
     "src/repro_torch/kernels/csrc/decode_attn.cu",
     [("olmoe qpk=1", check_decode, dict(KV=16, qpk=1)),
      ("gqa qpk=4", check_decode, dict(KV=4, qpk=4)),
      ("gqa qpk=4 window=200 softcap=30", check_decode,
       dict(KV=4, qpk=4, window=200, softcap=30.0))]),
    ("chunked_prefill_attention",
     "src/repro/kernels/decode_attn.py:503",
     "src/repro_torch/kernels/csrc/decode_attn.cu",
     [("olmoe qpk=1 Sc=64", check_chunk, dict(KV=16, qpk=1)),
      ("gqa qpk=4 Sc=64", check_chunk, dict(KV=4, qpk=4))]),
    ("ragged_moe_gemm",
     "src/repro/kernels/moe_gemm.py:141",
     "src/repro_torch/kernels/csrc/moe_gemm.cu",
     # C=64: the hot capacity of a 272-token stage (16 decode rows + 4 chunks
     # of 64); C=128 puts counts at c_block 64 and c_block + 1
     [("olmoe hot E=32 C=64", check_moe, dict(hot=True, C=64)),
      ("olmoe hot E=32 C=128", check_moe, dict(hot=True, C=128))]),
    ("ragged_moe_gemv",
     "src/repro/kernels/moe_gemv.py:114",
     "src/repro_torch/kernels/csrc/moe_gemv.cu",
     [("olmoe cold Ec=48 Cc=48", check_moe, dict(hot=False))]),
]


def kernel_phase(torch):
    """Returns {name: row of the kernels line}: the times of the main path's
    shape in bfloat16, the largest bfloat16 error, and launches None until
    the main path has run."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}
    failed = []
    for name, replaces, source, cases in KERNELS:
        for dtype in ("bfloat16", "float32"):
            for i, (label, fn, kw) in enumerate(cases):
                err, scale, ms, plain_ms, lib_ms, nbytes, flops = fn(
                    torch, gen, getattr(torch, dtype), **kw)
                bms, by = bound_ms(nbytes, flops, dtype)
                tol = TOL[dtype]
                ok = err <= tol
                lib = f"{lib_ms:.4f}" if lib_ms is not None else "none"
                log(f"kernel {name} [{label} {dtype}]: max_abs_err={err:.3e} "
                    f"tol={tol:g} (plain max |out|={scale:.3g}) "
                    f"{'OK' if ok else 'FAIL'}; ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={lib} bound_ms={bms:.4f} ({by})")
                if not ok:
                    failed.append(f"{name} [{label} {dtype}]")
                if dtype != "bfloat16":
                    continue
                if i == 0:             # the main path's shape is the row
                    rows[name] = {"name": name, "route": "cuda", "source": source,
                                  "replaces": replaces, "launches": None,
                                  "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": bms, "bound_by": by,
                                  "library_ms": lib_ms}
                else:
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def serve_phase(torch):
    """Serve 16 seeded requests on OLMoE-1B-7B; returns the launch counts of
    the run. Raises on any failed check."""
    import numpy as np
    from repro_torch.configs import resolve_config
    from repro_torch.kernels import build
    from repro_torch.models.params import init_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    cfg = resolve_config("olmoe-1b-7b")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve: {cfg.name} random init (seed 0) {n_params / 1e9:.2f}B params "
        f"in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    n_req, l_out = 16, 32
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(128, 513))).tolist(),
                    max_new_tokens=l_out) for i in range(n_req)]
    eng = ServingEngine(cfg, params, max_slots=16, max_len=1024, kv_page_size=16,
                        prefill_chunk_tokens=64, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:                       # all arrive together at the start
        r.arrival_time = time.monotonic()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)

    done = sum(r.done for r in reqs)
    ok_tokens = all(len(r.output) == l_out and all(0 <= t < cfg.vocab_size for t in r.output)
                    for r in reqs)
    reps = eng.reports
    mixed = sum(r.is_mixed for r in reps)
    dec_only = [r for r in reps if not r.is_mixed]
    gen = sum(len(r.output) for r in reqs)
    dec_tps = (sum(r.num_decode for r in dec_only)
               / max(sum(r.wall_time for r in dec_only), 1e-9))
    kc = [r.k_cold for r in reps]
    log(f"serve: {done}/{n_req} completed, {sum(len(r.prompt) for r in reqs)} prompt "
        f"tokens, {gen} generated, stages={len(reps)} (mixed={mixed}, "
        f"decode-only={len(dec_only)}) in {wall:.2f}s; generated tokens/s="
        f"{gen / wall:.1f}; decode-only stage tokens/s={dec_tps:.1f}; "
        f"k_cold min={min(kc)} max={max(kc)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    tbt = [t for r in reqs for t in r.tbts()]
    st = [r.stage_tokens for r in reps]
    kvb = [r.kv_bytes_streamed for r in reps]
    live = sum(r.moe_flops_live for r in reps)
    padded = sum(r.moe_flops_padded for r in reps)
    log(f"serve: median TBT={np.median(tbt) * 1e3:.1f}ms, median TTFT="
        f"{np.median([r.t2ft() for r in reqs]) * 1e3:.0f}ms; per-stage tokens "
        f"mean={np.mean(st):.1f} std={np.std(st):.1f} max={max(st)}; modelled MoE "
        f"streamed bytes={sum(r.moe_bytes_streamed for r in reps) / 1e9:.2f}GB "
        f"(ragged kernels), live/padded FLOPs={live / max(padded, 1):.2f}; streamed KV "
        f"bytes/stage mean={np.mean(kvb) / 1e6:.1f}MB max={max(kvb) / 1e6:.1f}MB")
    log(f"serve: kernel launches on the main path: {json.dumps(launches)}")
    if done != n_req or not ok_tokens:
        raise AssertionError(f"main path: {done}/{n_req} completed, tokens valid={ok_tokens}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    check_against_plain(torch, cfg, params)
    profile_stages(torch, cfg, params)
    return launches


def profile_stages(torch, cfg, params, top: int = 12):
    """A short profiled run (4 requests, 8 new tokens each) through
    torch.profiler, device activity only (each kernel counted once, no
    host-op events): device time by kernel and the device's busy share of
    the run's host wall time (tracing overhead can only inflate the wall
    time, so the busy share is a lower bound)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(128, 257))).tolist(),
                    max_new_tokens=8) for i in range(4)]
    eng = ServingEngine(cfg, params, max_slots=16, max_len=1024, kv_page_size=16,
                        prefill_chunk_tokens=64, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if dev(e) > 0 and str(getattr(e, "device_type", "CUDA")).endswith("CUDA")]
    busy_ms = sum(dev(e) for e in events) / 1e3
    if not events:
        log("profile: the profiler recorded no device events; no breakdown")
        return
    log(f"profile: {len(eng.reports)} stages in {wall * 1e3:.1f} ms host wall, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / (wall * 1e3):.1f}%)")
    for e in sorted(events, key=dev, reverse=True)[:top]:
        log(f"profile: {dev(e) / 1e3:9.2f} ms {100 * dev(e) / 1e3 / busy_ms:5.1f}% "
            f"x{e.count:<6d} {e.key[:110]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def check_against_plain(torch, cfg, params):
    """One mixed stage (a 64-token chunk after a written 64-token prefix,
    plus two decode rows) through the kernels and through the plain torch
    path, each on its own fresh cache: logits must agree within bf16 noise
    and every argmax whose top-2 margin exceeds twice that noise must
    match."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models.model import init_cache, mixed_step
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    page, maxp = 16, 16
    V = cfg.vocab_size
    tok = lambda *s: torch.randint(0, V, s, generator=gen, device="cuda")
    prefix, chunk = tok(1, 64), tok(1, 64)
    dec = tok(2, 1)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
    bt = torch.zeros((1, maxp), dtype=torch.int32, device="cuda")
    bt[0, :8] = torch.arange(1, 9)            # the chunk row's pages
    bt_dec = torch.zeros((2, maxp), dtype=torch.int32, device="cuda")
    bt_dec[0, 0] = 9                          # a decode row; row 1 is padding
    out = {}
    for use_kernels in (True, False):
        plan = ExecutionPlan(moe_impl="duplex", k_cold=32, c_hot=64, c_cold=16,
                             moe_ragged=use_kernels, use_kernels=use_kernels)
        cache = init_cache(cfg, page_size=page, num_pages=32, device="cuda")
        # write the prefix, then run the chunk with two decode rows
        mixed_step(params, cfg, dec[:1], prefix, cache,
                   attn_ctx={"lengths": i32([0]), "block_tables": bt_dec[:1],
                             "valid": i32([1]) > 0},
                   chunk_ctx={"starts": i32([0]), "chunk_lens": i32([64]),
                              "block_tables": bt}, plan=plan)
        dl, cl, _, _ = mixed_step(
            params, cfg, dec, chunk, cache,
            attn_ctx={"lengths": i32([1, 0]), "block_tables": bt_dec,
                      "valid": i32([1, 0]) > 0},
            chunk_ctx={"starts": i32([64]), "chunk_lens": i32([64]),
                       "block_tables": bt}, plan=plan)
        out[use_kernels] = torch.cat([dl[:1, 0], cl[:, 0]]).float()
    a, b = out[True], out[False]
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    top2 = b.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * diff
    agree = (a.argmax(-1) == b.argmax(-1)) | ~clear
    log(f"serve: kernels vs plain path on one mixed stage: max |dlogit|={diff:.4f} "
        f"(logit scale {scale:.2f}), argmax agree on {int(agree.sum())}/{len(agree)} "
        f"rows ({int(clear.sum())} with a clear top-2 margin)")
    if not bool(torch.isfinite(a).all()) or diff > 0.05 * scale or not bool(agree.all()):
        raise AssertionError("kernel path disagrees with the plain path")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phase (launches stay null)")
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "port on the card and has no CPU mode", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_name_and_power()
    log(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {len(build.SOURCES)} sources with nvcc in "
        f"{time.perf_counter() - t0:.1f}s")
    for src in build.SOURCES:
        text = build._lib_path(src).with_suffix(".log").read_text()
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", text))
        log(f"ptxas {src}: {len(regs)} kernels, at most {max(regs, default=0)} "
            f"registers, {spills} bytes of spill stores and loads")

    rows = kernel_phase(torch)
    if not args.kernels_only:
        for name, n in serve_phase(torch).items():
            rows[name]["launches"] = n
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
