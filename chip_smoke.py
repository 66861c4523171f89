#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase: OLMoE-1B-7B, Jamba-v0.1, training
    python3 chip_smoke.py --kernels-only

Phases, each printing a line:
  1. environment: torch / CUDA versions and the card's name and power limit;
  2. kernel build (nvcc, all sources in parallel) and its time, each
     source's ptxas registers and spills, and the count of tensor-core
     instructions (HGMMA, HMMA) in each library's SASS (``cuobjdump``;
     the bf16 flash forward and backward must hold HGMMA);
  3. each hand-written kernel against its plain PyTorch version on the card
     at OLMoE-1B-7B shapes (plus a GQA shape for the attention kernels;
     the ragged MoE pair also at Jamba-v0.1's widths and path c's decode
     capacities; the dense decode attention and the SSD decode at
     Jamba-v0.1's shapes, the SSD decode also at Mamba2-2.7B's; the flash
     forward and backward at path d's shape, Jamba-v0.1's GQA heads, a
     window with a softcap, 96 heads over 8 and a length that is not a
     tile multiple), in
     bfloat16 within its rounding band and again in float32 within 1e-4
     (the backward's dq, dk, dv each within the band times max(1, its
     largest entry)):
     max error and tolerance, kernel / plain / library time (the kernel
     also from a CUDA-graph replay: its device time without the wrapper's
     host work, and the TFLOP/s it reaches there), and the
     kernel's bound (least bytes / 3.35 TB/s or operations over the peak
     rate of the inputs' type: 989 TFLOP/s bf16, 67 TFLOP/s float32, 1979
     TOP/s int8); the int8 attention rows also print the float kernel's
     time at the same shape, the flash backward's SDPA's forward +
     backward beside its backward alone (its library time);
  4. the paths, each driven with every launch count set to 0 just before
     it and read just after: ``ServingEngine`` serving 16 seeded requests
     on OLMoE-1B-7B at full width and depth with random weights, paged KV
     (page 16) and chunked prefill (64),
       a. bf16 KV pages and the duplex ragged MoE (the first path),
       b. int8 KV pages (``kv_quant``) and the capacity-padded duplex MoE
          (``moe_ragged=False``);
     each checks that every request completes with in-vocabulary tokens,
     that each of its kernels was launched, and that one mixed stage's
     logits through the kernels agree with the plain (kernel-free) torch
     path, then profiles a short run; b also prints both paths' KV pool
     bytes. Then, with the OLMoE model freed,
       c. Jamba-v0.1 (Mamba-2 + GQA attention + MoE) at full width, depth
          cut to 16 of its 32 layers (two of four periods; the whole model,
          ~103 GB in bf16, does not fit one 80 GB card), the same 16
          requests on the dense KV layout (the engine's layout for a hybrid
          stack) with the legacy whole-prompt prefill
          (``prefill_chunk_tokens=None``) and
          the duplex ragged MoE; it checks completion, the launches of the
          dense decode attention, SSD decode and ragged MoE kernels, one
          decode stage through the kernels against the plain path, prints
          the dense KV and SSM state bytes and the peak memory, and
          profiles a short run. Then, with the Jamba model freed,
       d. training: OLMoE-1B-7B at full width, depth cut to 8 of its 16
          layers (its training state, 12 bytes a parameter, is 83 GB at
          full depth), 5 steps of ``make_step`` driven by ``train_loop`` on
          ``SyntheticLMData`` batches of 4 x 2048 tokens, run twice from
          the same seed; each run checks that each flash kernel launched
          layers x steps times, that losses and grad norms are finite and
          the parameters moved, and prints its losses, step times,
          tokens/s, the parameter and optimizer bytes and the peak memory;
          the two runs' losses must be equal at every step. Then one
          step's loss and layer 0's attention gradients through the
          kernels against the plain path, and a profile of one step.

Prints a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` as the
last line. Any failure raises, and the exit code is non-zero. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,   # H100 SXM dense bf16 tensor-core peak
              "float32": 67e12,     # H100 SXM float32 outside the tensor cores
              "int8": 1979e12}      # H100 SXM dense int8 tensor-core peak
# Kernel vs plain version. The int8 kernels are held to the same bands: on
# the card both sides requantize with the same recipe and the card's own
# expf, so their int8 values agree and only float32 sums differ in order.
# (A last-bit difference in exp would flip a requantized p*v_scale by one
# int8 step, moving an output by at most p*v_scale*|v8|/l; none is expected
# here, and it would show as a failure at 1e-4.)
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


def graph_ms(torch, fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the wrappers' host work (argument checks, allocation, the
    ctypes call) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                               # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound_ms(nbytes: float, flops: float, ops_type: str):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[ops_type]
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


def _quant_pools(kp, vp):
    from repro_torch.kernels.quant import int8_quantize
    (k8, ks), (v8, vs) = int8_quantize(kp), int8_quantize(vp)
    return k8, ks, v8, vs


def check_decode(torch, gen, dtype, *, KV, qpk, window=0, softcap=0.0, int8=False):
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
    fp_call = lambda: da.paged_decode_attention_kernel(q, kp, vp, lengths, bt, **kw)
    if int8:
        k8, ks, v8, vs = _quant_pools(kp, vp)
        args = (q, k8, ks, v8, vs, lengths, bt)
        kernel, plain = (da.paged_decode_attention_int8_kernel,
                         da.paged_decode_attention_int8_plain)
    else:
        args = (q, kp, vp, lengths, bt)
        kernel, plain = da.paged_decode_attention_kernel, da.paged_decode_attention_plain
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    out = dict(err=(got.float() - want.float()).abs().max().item(),
               scale=want.float().abs().max().item(),
               ms=time_ms(lambda: kernel(*args, **kw)),
               graph_ms=graph_ms(torch, lambda: kernel(*args, **kw)),
               plain_ms=time_ms(lambda: plain(*args, **kw)), lib_ms=None)
    live = [min(n, maxp * page) if not window else min(n, window) for n in lens]
    item = q.element_size()
    if int8:
        # pages the kernel must read: the window's first page to the last
        pages = 0
        for n in lens:
            first = max(n - window, 0) if window else 0
            pages += -(-n // page) - first // page if n else 0
        out["nbytes"] = (pages * 2 * KV * page * (hd + 4) + 2 * q.numel() * item
                         + B * 4 + pages * 4)
        out["ops_type"] = "int8"
        out["fp_ms"] = time_ms(fp_call)
    else:
        out["nbytes"] = (sum(live) * KV * hd * 2 * item + 2 * q.numel() * item
                         + B * 4 + sum(-(-n // page) for n in live) * 4)
        if not softcap:
            # library yardstick: SDPA over the same K/V gathered dense, with the mask
            kd = da._gather_pages(kp, bt)
            vd = da._gather_pages(vp, bt)
            kpos = torch.arange(maxp * page, device="cuda")[None]
            valid = kpos < lengths.long()[:, None]
            if window:
                valid &= kpos > lengths.long()[:, None] - 1 - window
            mask = valid[:, None, None, :]
            qs = q.reshape(B, KV, qpk, hd)
            out["lib_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=mask))
    out["flops"] = sum(live) * KV * qpk * hd * 4
    return out


def check_chunk(torch, gen, dtype, *, KV, qpk, int8=False):
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
    fp_call = lambda: da.chunked_prefill_attention_kernel(q, kp, vp, tot, st, bt, qpk=qpk)
    if int8:
        k8, ks, v8, vs = _quant_pools(kp, vp)
        args = (q, k8, ks, v8, vs, tot, st, bt)
        kernel, plain = (da.chunked_prefill_attention_int8_kernel,
                         da.chunked_prefill_attention_int8_plain)
    else:
        args = (q, kp, vp, tot, st, bt)
        kernel, plain = (da.chunked_prefill_attention_kernel,
                         da.chunked_prefill_attention_plain)
    got = kernel(*args, qpk=qpk)
    want = plain(*args, qpk=qpk)
    torch.cuda.synchronize()
    out = dict(err=(got.float() - want.float()).abs().max().item(),
               scale=want.float().abs().max().item(),
               ms=time_ms(lambda: kernel(*args, qpk=qpk)),
               graph_ms=graph_ms(torch, lambda: kernel(*args, qpk=qpk)),
               plain_ms=time_ms(lambda: plain(*args, qpk=qpk)), lib_ms=None)
    item = q.element_size()
    if int8:
        pages = sum(-(-t // page) for t in totals)
        out["nbytes"] = (pages * 2 * KV * page * (hd + 4) + 2 * q.numel() * item
                         + pages * 4)
        out["ops_type"] = "int8"
        out["fp_ms"] = time_ms(fp_call)
    else:
        out["nbytes"] = sum(totals) * KV * hd * 2 * item + 2 * q.numel() * item
        kd = da._gather_pages(kp, bt)
        vd = da._gather_pages(vp, bt)
        R = Sc * qpk
        qpos = st.long()[:, None] + torch.arange(R, device="cuda")[None] // qpk
        kpos = torch.arange(maxp * page, device="cuda")
        mask = ((kpos[None, None] <= qpos[:, :, None])
                & (kpos[None, None] < tot.long()[:, None, None]))[:, None]
        out["lib_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask))
    # live (row, key) pairs: row at chunk position i attends keys <= start+i
    pairs = 0
    for s, c, t in zip(starts, clens, totals):
        for i in range(Sc):
            pairs += min(s + i + 1, t)
    out["flops"] = pairs * KV * qpk * hd * 4
    return out


def check_dense(torch, gen, dtype, *, KV, qpk, window=0, softcap=0.0):
    """Decode attention over a dense (B, Smax, KV, hd) cache, read in place:
    16 sequences, Smax 1024, seeded lengths 0-1024 (one at 0, one at 1024)."""
    from repro_torch.kernels import decode_attn as da
    B, hd, Smax = 16, 128, 1024
    lens = torch.randint(0, Smax + 1, (B,), generator=gen, device="cuda").to(torch.int32)
    lens[0], lens[1] = 0, Smax
    k = torch.randn((B, Smax, KV, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Smax, KV, hd), generator=gen, device="cuda").to(dtype)
    q = torch.randn((B, KV, qpk, hd), generator=gen, device="cuda").to(dtype)
    kw = dict(window=window, softcap=softcap)
    got = da.decode_attention_kernel(q, k, v, lens, **kw)
    want = da.decode_attention_plain(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    out = dict(err=(got.float() - want.float()).abs().max().item(),
               scale=want.float().abs().max().item(),
               ms=time_ms(lambda: da.decode_attention_kernel(q, k, v, lens, **kw)),
               graph_ms=graph_ms(torch, lambda: da.decode_attention_kernel(q, k, v, lens, **kw)),
               plain_ms=time_ms(lambda: da.decode_attention_plain(q, k, v, lens, **kw)),
               lib_ms=None)
    lens_l = lens.tolist()
    live = [min(n, Smax) - (max(n - window, 0) if window else 0) for n in lens_l]
    live = [max(n, 0) for n in live]
    item = q.element_size()
    out["nbytes"] = sum(live) * KV * hd * 2 * item + 2 * q.numel() * item + B * 4
    out["flops"] = sum(live) * KV * qpk * hd * 4
    if not softcap:
        # library yardstick: SDPA over the same dense cache with the length mask
        kpos = torch.arange(Smax, device="cuda")[None]
        valid = kpos < lens.long()[:, None]
        if window:
            valid &= kpos > lens.long()[:, None] - 1 - window
        mask = valid[:, None, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        out["lib_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kt, vt, attn_mask=mask))
    return out


def check_ssd(torch, gen, dtype, *, H, N, P):
    """The Mamba-2 decode state update for 16 sequences; the kernel updates
    its (cloned) state in place. The error is the larger of y's and the
    new state's."""
    from repro_torch.kernels import ssd_decode as sd
    B = 16
    state = torch.randn((B, H, N, P), generator=gen, device="cuda")
    x = torch.randn((B, H, P), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, H), generator=gen, device="cuda"))
    a_log = torch.rand((H,), generator=gen, device="cuda")
    b = torch.randn((B, N), generator=gen, device="cuda")
    c = torch.randn((B, N), generator=gen, device="cuda")
    d = torch.randn((H,), generator=gen, device="cuda")
    y_p, s_p = sd.ssd_decode_plain(state, x, dt, a_log, b, c, d)
    y_k, s_k = sd.ssd_decode_kernel(state.clone(), x, dt, a_log, b, c, d)
    torch.cuda.synchronize()
    err = max((y_k.float() - y_p.float()).abs().max().item(), (s_k - s_p).abs().max().item())
    work = state.clone()
    item = x.element_size()
    return dict(err=err, scale=y_p.float().abs().max().item(),
                ms=time_ms(lambda: sd.ssd_decode_kernel(work, x, dt, a_log, b, c, d)),
                graph_ms=graph_ms(torch, lambda: sd.ssd_decode_kernel(work, x, dt, a_log, b,
                                                                      c, d)),
                plain_ms=time_ms(lambda: sd.ssd_decode_plain(state, x, dt, a_log, b, c, d)),
                lib_ms=None,
                nbytes=2 * state.numel() * 4 + 2 * x.numel() * item + (B * H + 2 * B * N
                                                                      + 2 * H) * 4,
                flops=6 * state.numel(), ops_type="float32")


def _live_pairs(S, causal, window):
    """(query, key) pairs the masks leave live, per (sequence, head)."""
    n = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        n += (i + 1 if causal else S) - lo
    return n


def _flash_inputs(torch, gen, dtype, B, S, H, KV, hd=128):
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return r(B, S, H, hd), r(B, S, KV, hd), r(B, S, KV, hd)


def _sdpa(torch, q, k, v, causal):
    """The library yardstick in (B, H, S, hd) views; K/V of a GQA shape go
    in by ``enable_gqa`` where the installed PyTorch has it, else repeated
    here, outside any timed region. Returns a call."""
    F = torch.nn.functional
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.shape[2] == k.shape[2]:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=True)
    except TypeError:
        rep = q.shape[2] // k.shape[2]
        kt, vt = kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)


def check_flash(torch, gen, dtype, *, B, S, H, KV, causal=True, window=0, softcap=0.0):
    """The flash forward on the model layout, called as the training path
    calls it (``f32_out=True``: bf16 runs the tensor-core kernel, which also
    writes the float32 output): out, lse and the float32 output against the
    plain version (the error is the largest of the three)."""
    from repro_torch.kernels import flash_attn as fa
    q, k, v = _flash_inputs(torch, gen, dtype, B, S, H, KV)
    kw = dict(causal=causal, window=window, softcap=softcap, f32_out=True)
    got, lse, o32 = fa.flash_attention_kernel(q, k, v, **kw)
    want, lse_p, o32_p = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = max((got.float() - want.float()).abs().max().item(), (lse - lse_p).abs().max().item(),
              (o32 - o32_p).abs().max().item())
    hd, item = q.shape[3], q.element_size()
    out_bytes = q.numel() * (item + (4 if dtype != torch.float32 else 0))
    out = dict(err=err, scale=want.float().abs().max().item(),
               ms=time_ms(lambda: fa.flash_attention_kernel(q, k, v, **kw)),
               graph_ms=graph_ms(torch, lambda: fa.flash_attention_kernel(q, k, v, **kw)),
               plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), iters=5),
               lib_ms=None,
               nbytes=(q.numel() + k.numel() + v.numel()) * item + out_bytes + lse.numel() * 4,
               flops=4 * hd * B * H * _live_pairs(S, causal, window))
    if not window and not softcap:
        out["lib_ms"] = time_ms(_sdpa(torch, q, k, v, causal))
    return out


def check_flash_bwd(torch, gen, dtype, *, B, S, H, KV, causal=True, window=0, softcap=0.0):
    """The flash backward (one wrapper, three launches) from the plain
    forward's out and lse and a seeded dout: each of dq, dk, dv against the
    plain version within the band times max(1, its largest |entry|) (dk and
    dv sum over every query row and the group's heads, so they grow with S).
    ``err`` is the largest absolute error, ``rel_err`` what the band
    judges. The library time is SDPA's backward alone: forward +
    ``autograd.grad`` less the forward, timed in turns in this call
    (forward + ``backward()``, which also accumulates into ``.grad``, is
    printed beside it)."""
    from repro_torch.kernels import flash_attn as fa
    q, k, v = _flash_inputs(torch, gen, dtype, B, S, H, KV)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, lse, o = fa.flash_attention_plain(q, k, v, f32_out=True, **kw)   # o: float32
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    args = (q, k, v, o, lse, dout)
    got = fa.flash_attention_bwd_kernel(*args, **kw)
    want = fa.flash_attention_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
    scales = [w.float().abs().max().item() for w in want]
    hd, item = q.shape[3], q.element_size()
    out = dict(err=max(errs), rel_err=max(e / max(1.0, s) for e, s in zip(errs, scales)),
               scale=max(scales),
               detail=" ".join(f"{n}: err={e:.3e} max|plain|={s:.3g};"
                               for n, e, s in zip(("dq", "dk", "dv"), errs, scales)),
               ms=time_ms(lambda: fa.flash_attention_bwd_kernel(*args, **kw)),
               graph_ms=graph_ms(torch, lambda: fa.flash_attention_bwd_kernel(*args, **kw)),
               plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(*args, **kw), iters=5),
               lib_ms=None,
               nbytes=(2 * q.numel() + 2 * (k.numel() + v.numel())) * item + o.numel() * 4
               + lse.numel() * 4 + dout.numel() * item,
               flops=2.5 * 4 * hd * B * H * _live_pairs(S, causal, window))
    if not window and not softcap:
        # library yardstick: SDPA's backward on the same inputs
        qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        fwd = _sdpa(torch, qg, kg, vg, causal)
        dt = dout.transpose(1, 2)
        grads = lambda: torch.autograd.grad(fwd(), (qg, kg, vg), dt)
        fwd_bwd = time_ms(lambda: fwd().backward(dt))
        fwd_ms, grad_ms = time_ms(fwd), time_ms(grads)
        out["lib_ms"] = grad_ms - fwd_ms
        out["lib_detail"] = (f" (SDPA fwd={fwd_ms:.4f} fwd+grad={grad_ms:.4f} "
                             f"fwd+backward()={fwd_bwd:.4f})")
    return out


def _experts(torch, gen, dtype, E, d, f):
    def w(*shape, fan_in):
        return (torch.randn(shape, generator=gen, device="cuda")
                / fan_in ** 0.5).to(dtype)
    return w(E, d, f, fan_in=d), w(E, d, f, fan_in=d), w(E, f, d, fan_in=f)


def check_moe(torch, gen, dtype, *, hot: bool, E: int = 64, d: int = 2048, f: int = 1024,
              n: int = 0, C: int = 48, padded: bool = False):
    """n experts (in rank order, some empty) of E with capacity C each. hot:
    the ragged GEMM, by default E - k_cold = 32 hot experts; cold: the
    ragged GEMV, by default 48 cold experts with capacity 48 (a 272-token
    OLMoE stage at k_cold 48). ``padded``: the capacity-padded kernels,
    every slot live and computed."""
    from repro_torch.kernels import moe_gemm, moe_gemv
    if hot:
        n = n or E - 32
        # at C=128 (c_block 64) C//2 and C//2 + 1 are c_block and c_block + 1
        base = [0, 1, 2, 3, C // 2, C // 2 + 1, C - 1, C]
        kernel, plain = moe_gemm.ragged_moe_gemm_kernel, moe_gemm.ragged_moe_gemm_plain
        if padded:
            kernel, plain = moe_gemm.moe_gemm_kernel, moe_gemm.moe_gemm_plain
    else:
        n = n or 48
        base = [0, 1, C, 0, min(5, C), 2, C - 1, 3]
        kernel, plain = moe_gemv.ragged_moe_gemv_kernel, moe_gemv.ragged_moe_gemv_plain
        if padded:
            kernel, plain = moe_gemv.moe_gemv_kernel, moe_gemv.moe_gemv_plain
    base = base[:n]
    rest = torch.randint(0, C + 1, (n - len(base),), generator=gen, device="cuda").tolist()
    counts_l = [C] * n if padded else base + rest
    counts = torch.tensor(counts_l, dtype=torch.int32, device="cuda")
    perm = torch.randperm(E, generator=gen, device="cuda")[:n].to(torch.int32)
    wg, wu, wo = _experts(torch, gen, dtype, E, d, f)
    x = torch.randn((n, C, d), generator=gen, device="cuda").to(dtype)
    args = (x, wg, wu, wo, perm) if padded else (x, wg, wu, wo, perm, counts)
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    item = x.element_size()
    live_experts = sum(1 for c in counts_l if c > 0)
    return dict(err=(got.float() - want.float()).abs().max().item(),
                scale=want.float().abs().max().item(),
                ms=time_ms(lambda: kernel(*args)),
                graph_ms=graph_ms(torch, lambda: kernel(*args)),
                plain_ms=time_ms(lambda: plain(*args), iters=5), lib_ms=None,
                nbytes=(live_experts * 3 * d * f * item + sum(counts_l) * d * item
                        + x.numel() * item + (1 if padded else 2) * n * 4),
                flops=2 * 3 * d * f * sum(counts_l))


# Jamba-v0.1's MoE widths; on path c a decode stage is 16 bucketed tokens,
# so the engine's capacities are C_hot 8 and C_cold 8 (16 at k_cold 16)
JAMBA_MOE = dict(E=16, d=4096, f=14336)

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
      ("olmoe hot E=32 C=128", check_moe, dict(hot=True, C=128)),
      # path c's decode stages: k_cold 8, and k_cold 0 (every expert hot)
      ("jamba hot E=8 C=8", check_moe, dict(hot=True, n=8, C=8, **JAMBA_MOE)),
      ("jamba hot E=16 C=8", check_moe, dict(hot=True, n=16, C=8, **JAMBA_MOE))]),
    ("ragged_moe_gemv",
     "src/repro/kernels/moe_gemv.py:114",
     "src/repro_torch/kernels/csrc/moe_gemv.cu",
     [("olmoe cold Ec=48 Cc=48", check_moe, dict(hot=False)),
      # path c's decode stages: k_cold 8, and k_cold 16 (every expert cold)
      ("jamba cold Ec=8 Cc=8", check_moe, dict(hot=False, n=8, C=8, **JAMBA_MOE)),
      ("jamba cold Ec=16 Cc=16", check_moe, dict(hot=False, n=16, C=16, **JAMBA_MOE))]),
    ("paged_decode_attention_int8",
     "src/repro/kernels/decode_attn.py:222",
     "src/repro_torch/kernels/csrc/decode_attn.cu",
     [("olmoe qpk=1 int8", check_decode, dict(KV=16, qpk=1, int8=True)),
      ("gqa qpk=4 window=200 softcap=30 int8", check_decode,
       dict(KV=4, qpk=4, window=200, softcap=30.0, int8=True))]),
    ("chunked_prefill_attention_int8",
     "src/repro/kernels/decode_attn.py:446",
     "src/repro_torch/kernels/csrc/decode_attn.cu",
     [("olmoe qpk=1 Sc=64 int8", check_chunk, dict(KV=16, qpk=1, int8=True)),
      ("gqa qpk=4 Sc=64 int8", check_chunk, dict(KV=4, qpk=4, int8=True))]),
    ("moe_gemm",
     "src/repro/kernels/moe_gemm.py:65",
     "src/repro_torch/kernels/csrc/moe_gemm.cu",
     [("olmoe hot padded E=32 C=64", check_moe, dict(hot=True, C=64, padded=True))]),
    ("moe_gemv",
     "src/repro/kernels/moe_gemv.py:57",
     "src/repro_torch/kernels/csrc/moe_gemv.cu",
     [("olmoe cold padded Ec=48 Cc=48", check_moe, dict(hot=False, padded=True))]),
    ("decode_attention",
     "src/repro/kernels/decode_attn.py:127",
     "src/repro_torch/kernels/csrc/decode_attn.cu",
     [("jamba KV=8 qpk=4 Smax=1024", check_dense, dict(KV=8, qpk=4)),
      ("KV=8 qpk=1 window=200 softcap=30", check_dense,
       dict(KV=8, qpk=1, window=200, softcap=30.0))]),
    ("ssd_decode",
     "src/repro/kernels/ssd_decode.py:46",
     "src/repro_torch/kernels/csrc/ssd_decode.cu",
     [("jamba H=128 N=16 P=64", check_ssd, dict(H=128, N=16, P=64)),
      ("mamba2-2.7b H=80 N=128 P=64", check_ssd, dict(H=80, N=128, P=64))]),
    # path d's shape (OLMoE-1B-7B, 4 x 2048 tokens, causal), Jamba-v0.1's GQA
    # heads, a window with a softcap, mistral-large-123b's 96 heads over 8
    # (qpk 12 does not divide the kernels' 128 rows), and a length that is
    # not a tile multiple; bf16 runs flash_fwd_sm90.cu and flash_bwd_sm90.cu,
    # float32 flash_attn.cu
    ("flash_attention",
     "src/repro/kernels/flash_attn.py:87",
     "src/repro_torch/kernels/csrc/flash_fwd_sm90.cu",
     [("olmoe B=4 S=2048 H=16 KV=16 causal", check_flash, dict(B=4, S=2048, H=16, KV=16)),
      ("gqa B=1 S=4096 H=32 KV=8 causal", check_flash, dict(B=1, S=4096, H=32, KV=8)),
      ("B=1 S=2048 H=16 KV=16 window=1000 softcap=50", check_flash,
       dict(B=1, S=2048, H=16, KV=16, window=1000, softcap=50.0)),
      ("qpk=12 B=1 S=2048 H=96 KV=8 causal", check_flash, dict(B=1, S=2048, H=96, KV=8)),
      ("ragged B=2 S=2047 H=16 KV=16 causal", check_flash, dict(B=2, S=2047, H=16, KV=16))]),
    ("flash_attention_bwd",
     "src/repro/models/attention.py:349",
     "src/repro_torch/kernels/csrc/flash_bwd_sm90.cu",
     [("olmoe B=4 S=2048 H=16 KV=16 causal", check_flash_bwd,
       dict(B=4, S=2048, H=16, KV=16)),
      ("gqa B=1 S=4096 H=32 KV=8 causal", check_flash_bwd, dict(B=1, S=4096, H=32, KV=8)),
      ("B=1 S=2048 H=16 KV=16 window=1000 softcap=50", check_flash_bwd,
       dict(B=1, S=2048, H=16, KV=16, window=1000, softcap=50.0)),
      ("qpk=12 B=1 S=2048 H=96 KV=8 causal", check_flash_bwd, dict(B=1, S=2048, H=96, KV=8)),
      ("ragged B=2 S=2047 H=16 KV=16 causal", check_flash_bwd,
       dict(B=2, S=2047, H=16, KV=16))]),
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
                r = fn(torch, gen, getattr(torch, dtype), **kw)
                err, lib_ms = r["err"], r["lib_ms"]
                bms, by = bound_ms(r["nbytes"], r["flops"], r.get("ops_type", dtype))
                tol = TOL[dtype]
                ok = r.get("rel_err", err) <= tol
                lib = f"{lib_ms:.4f}" if lib_ms is not None else "none"
                fp = f" fp_kernel_ms={r['fp_ms']:.4f}" if "fp_ms" in r else ""
                fp += r.get("lib_detail", "")
                band = (f" ({r['detail']} band tol x max(1, max|plain|))" if "detail" in r
                        else "")
                log(f"kernel {name} [{label} {dtype}]: max_abs_err={err:.3e} "
                    f"tol={tol:g}{band} (plain max |out|={r['scale']:.3g}) "
                    f"{'OK' if ok else 'FAIL'}; ms={r['ms']:.4f} graph_ms={r['graph_ms']:.4f} "
                    f"plain_ms={r['plain_ms']:.4f} "
                    f"library_ms={lib} bound_ms={bms:.4f} ({by}) "
                    f"TFLOP/s={r['flops'] / r['graph_ms'] / 1e9:.1f} (graph){fp}")
                if not ok:
                    failed.append(f"{name} [{label} {dtype}]")
                if dtype != "bfloat16":
                    continue
                if i == 0:             # the main path's shape is the row
                    rows[name] = {"name": name, "route": "cuda", "source": source,
                                  "replaces": replaces, "launches": None,
                                  "max_abs_err": err, "ms": r["ms"],
                                  "plain_ms": r["plain_ms"], "bound_ms": bms,
                                  "bound_by": by, "library_ms": lib_ms}
                else:
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    return rows


# ---------------------------------------------------------------------------
# phase 4: the paths
# ---------------------------------------------------------------------------

# (label, engine flags, the kernels the path must launch)
PATHS = [
    ("bf16 KV + ragged MoE", dict(),
     ("paged_decode_attention", "chunked_prefill_attention", "ragged_moe_gemm",
      "ragged_moe_gemv")),
    ("int8 KV + padded MoE", dict(kv_quant=True, moe_ragged=False),
     ("paged_decode_attention_int8", "chunked_prefill_attention_int8", "moe_gemm",
      "moe_gemv")),
]
ENGINE_KW = dict(max_slots=16, max_len=1024, kv_page_size=16, prefill_chunk_tokens=64)
# path c: Jamba-v0.1 at full width, 16 of its 32 layers (two 8-layer
# periods): the whole model (~51.5B parameters, ~103 GB in bf16) does not
# fit one 80 GB card; the cut one is ~26.0B (~52 GB)
HYBRID_LABEL = "jamba dense KV + ragged MoE"
HYBRID_LAYERS = 16
# the engine takes the dense KV layout, the one a hybrid stack has
HYBRID_KW = dict(max_slots=16, max_len=1024, prefill_chunk_tokens=None)
HYBRID_KERNELS = ("decode_attention", "ssd_decode", "ragged_moe_gemm", "ragged_moe_gemv")


def serve_phase(torch):
    """Serve 16 seeded requests on OLMoE-1B-7B down each path; returns
    {kernel: launches} with each kernel's count from its own path's run.
    Raises on any failed check."""
    from repro_torch.configs import resolve_config
    from repro_torch.models.params import init_model, tree_leaves

    cfg = resolve_config("olmoe-1b-7b")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"serve: {cfg.name} random init (seed 0) {n_params / 1e9:.2f}B params "
        f"in {time.perf_counter() - t0:.1f}s")
    launches, pool_bytes = {}, {}
    for label, flags, kernels in PATHS:
        engine_kw = {**ENGINE_KW, **flags}
        counts, eng = serve_path(torch, cfg, params, label, engine_kw)
        pool_bytes[label] = eng.kv._total_bytes()
        del eng
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"[{label}] kernels never launched on the path: {missing}")
        launches.update({k: counts[k] for k in kernels})
        check_against_plain(torch, cfg, params, label, flags)
        profile_stages(torch, cfg, params, label, engine_kw)
    from repro_torch.serving.kvmanager import kv_token_bytes
    (a, na), (b, nb) = pool_bytes.items()
    want = kv_token_bytes(cfg) / kv_token_bytes(cfg, kv_quant=True)
    log(f"serve: KV pool bytes [{a}] {na / 2**20:.1f} MiB, [{b}] {nb / 2**20:.1f} MiB, "
        f"ratio {na / nb:.3f} ({want:.3f} expected: 2*KV*hd*2 over 2*KV*(hd + 4) bytes "
        f"per token)")
    return launches


def serve_path(torch, cfg, params, label, engine_kw):
    """One path's run: every launch count set to 0 just before it and read
    just after. Returns (launch counts, the engine)."""
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(0)
    n_req, l_out = 16, 32
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(128, 513))).tolist(),
                    max_new_tokens=l_out) for i in range(n_req)]
    eng = ServingEngine(cfg, params, device="cuda", **engine_kw)
    pool = eng.kv._total_bytes()
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
    log(f"serve [{label}]: {done}/{n_req} completed, {sum(len(r.prompt) for r in reqs)} "
        f"prompt tokens, {gen} generated, stages={len(reps)} (mixed={mixed}, "
        f"decode-only={len(dec_only)}) in {wall:.2f}s; generated tokens/s="
        f"{gen / wall:.1f}; decode-only stage tokens/s={dec_tps:.1f}; "
        f"k_cold min={min(kc)} max={max(kc)} (stages with k_cold>0: "
        f"{sum(k > 0 for k in kc)}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; KV cache {pool / 2**20:.1f} MiB")
    tbt = [t for r in reqs for t in r.tbts()]
    st = [r.stage_tokens for r in reps]
    kvb = [r.kv_bytes_streamed for r in reps]
    live = sum(r.moe_flops_live for r in reps)
    padded = sum(r.moe_flops_padded for r in reps)
    which = "padded" if engine_kw.get("moe_ragged") is False else "ragged"
    log(f"serve [{label}]: median TBT={np.median(tbt) * 1e3:.1f}ms, median TTFT="
        f"{np.median([r.t2ft() for r in reqs]) * 1e3:.0f}ms; per-stage tokens "
        f"mean={np.mean(st):.1f} std={np.std(st):.1f} max={max(st)}; modelled MoE "
        f"streamed bytes={sum(r.moe_bytes_streamed for r in reps) / 1e9:.2f}GB "
        f"({which} kernels), live/padded FLOPs={live / max(padded, 1):.2f}; streamed KV "
        f"bytes/stage mean={np.mean(kvb) / 1e6:.1f}MB max={max(kvb) / 1e6:.1f}MB")
    log(f"serve [{label}]: kernel launches on the path: {json.dumps(launches)}")
    if done != n_req or not ok_tokens:
        raise AssertionError(f"[{label}]: {done}/{n_req} completed, tokens valid={ok_tokens}")
    return launches, eng


def hybrid_phase(torch):
    """Path c: Jamba-v0.1 at full width and 16 layers, random weights from
    seed 0, the same 16 requests on the dense KV layout with the legacy
    prefill. Returns {kernel: launches} for the dense decode attention and
    the SSD decode; raises if any of the path's kernels was not launched or
    a check fails."""
    import dataclasses
    from repro_torch.configs import resolve_config
    from repro_torch.configs.base import Segment
    from repro_torch.models.params import init_model, tree_leaves
    full = resolve_config("jamba-v0.1-52b")
    pattern = full.segments[0].pattern
    cfg = dataclasses.replace(
        full, num_layers=HYBRID_LAYERS,
        segments=(Segment(pattern, HYBRID_LAYERS // len(pattern)),)).validate()
    log(f"serve: before {cfg.name}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"still allocated")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    p_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"serve: {cfg.name} cut to {cfg.num_layers} of {full.num_layers} layers, random "
        f"init (seed 0) {n_params / 1e9:.2f}B params ({p_bytes / 2**30:.1f} GiB) in "
        f"{time.perf_counter() - t0:.1f}s")
    counts, eng = serve_path(torch, cfg, params, HYBRID_LABEL, HYBRID_KW)
    missing = [k for k in HYBRID_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"[{HYBRID_LABEL}] kernels never launched on the path: "
                             f"{missing}")
    kv_b = sum(t.numel() * t.element_size() for seg in eng.kv.cache
               for blk in seg["blocks"] if "k" in blk for t in blk.values())
    ssm_b = sum(t.numel() * t.element_size() for seg in eng.kv.cache
                for blk in seg["blocks"] if "mamba" in blk for t in blk["mamba"].values())
    n_attn = sum(k.mixer != "mamba" for k in cfg.layer_kinds())
    slots, max_len = HYBRID_KW["max_slots"], HYBRID_KW["max_len"]
    log(f"serve [{HYBRID_LABEL}]: dense KV cache {kv_b / 2**20:.1f} MiB ({n_attn} attention "
        f"layers x {slots} slots x {max_len} positions, k/v/pos/len), SSM state "
        f"{ssm_b / 2**20:.1f} MiB ({cfg.num_layers - n_attn} Mamba layers x {slots} slots, "
        f"conv tail + float32 state); streamed KV bytes per decode stage "
        f"{eng._dense_kv_bytes_per_stage / 2**20:.1f} MiB")
    del eng
    check_decode_against_plain(torch, cfg, params, HYBRID_LABEL)
    profile_stages(torch, cfg, params, HYBRID_LABEL, HYBRID_KW)
    log(f"serve [{HYBRID_LABEL}]: peak memory since the weights were made "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return {k: counts[k] for k in ("decode_attention", "ssd_decode")}


def check_decode_against_plain(torch, cfg, params, label):
    """One dense decode stage (four rows after a prefill of 320, 257, 130
    and 64 tokens, the fourth row dead) through the kernels (dense decode
    attention, SSD decode, ragged MoE at k_cold 8) and through the plain
    torch path, each on its own copy of the prefilled cache; the live rows'
    logits are held to ``compare_logits``."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.params import tree_map
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    B, S = 4, 320
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    true_len = torch.tensor([320, 257, 130, 64], dtype=torch.int32, device="cuda")
    cache = init_cache(cfg, B, 1024, device="cuda")
    with torch.no_grad():
        prefill(params, cfg, {"tokens": toks}, cache, true_len,
                plan=ExecutionPlan(moe_impl="grouped", use_kernels=True))
    nxt = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device="cuda")
    valid = torch.tensor([True, True, True, False], device="cuda")
    out = {}
    for use_kernels in (True, False):
        own = tree_map(cache, lambda t: t.clone())
        plan = ExecutionPlan(moe_impl="duplex", k_cold=8, c_hot=8, c_cold=8,
                             moe_ragged=use_kernels, use_kernels=use_kernels)
        with torch.no_grad():
            logits, _, _ = decode_step(params, cfg, nxt, own, {"valid": valid}, plan=plan)
        out[use_kernels] = logits[:3, 0].float()
    compare_logits(torch, label, "one decode stage", out[True], out[False])


def profile_stages(torch, cfg, params, label, engine_kw, top: int = 12):
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
    eng = ServingEngine(cfg, params, device="cuda", **engine_kw)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_profile(prof, label, f"{len(eng.reports)} stages", wall, top)


def log_profile(prof, label, what, wall, top, also=()):
    """Device time by kernel from a CUDA-only profile, and the device's busy
    share of ``wall`` (host seconds): the ``top`` items, then any other
    whose name holds one of the words in ``also``."""
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if dev(e) > 0 and str(getattr(e, "device_type", "CUDA")).endswith("CUDA")]
    busy_ms = sum(dev(e) for e in events) / 1e3
    if not events:
        log(f"profile [{label}]: the profiler recorded no device events; no breakdown")
        return
    log(f"profile [{label}]: {what} in {wall * 1e3:.1f} ms host wall, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / (wall * 1e3):.1f}%)")
    ranked = sorted(events, key=dev, reverse=True)
    for i, e in enumerate(ranked):
        if i < top or any(w in e.key for w in also):
            log(f"profile [{label}]: {dev(e) / 1e3:9.2f} ms {100 * dev(e) / 1e3 / busy_ms:5.1f}% "
                f"x{e.count:<6d} {e.key[:110]}")


# path d: OLMoE-1B-7B trained at full width and 8 of its 16 layers: the
# training state costs 12 bytes a parameter (bf16 params and grads, float32
# mu and nu), 83 GB for the whole 6.92B-parameter model, more than one 80 GB
# card; 8 layers are 3.56B parameters, 42.8 GB of state
TRAIN_LABEL = "olmoe training"
TRAIN_LAYERS = 8
TRAIN_STEPS = 5
TRAIN_BATCH, TRAIN_SEQ = 4, 2048         # 8192 tokens a step; S > 512 runs the flash core
TRAIN_REMAT = "none"
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd")


def train_phase(torch):
    """Path d: ``make_train_state`` -> ``make_step`` -> ``train_loop`` on
    OLMoE-1B-7B at full width and TRAIN_LAYERS layers, random weights from
    seed 0, ``SyntheticLMData`` batches (seed 0, 4 x 2048), the reference
    CLI's optimizer defaults (lr 1e-3, warmup max(steps // 10, 1)). Runs
    twice from the same seed, each run with the launch counts set to 0 just
    before it and read just after; the two runs' losses must be equal at
    every step (the MoE input gradient is summed in a fixed order). Returns
    {kernel: launches} of the first run; raises if a check fails."""
    import dataclasses
    from repro_torch.configs import RunConfig, resolve_config
    from repro_torch.configs.base import Segment
    from repro_torch.launch.train import make_step
    from repro_torch.training.data import DataConfig, SyntheticLMData
    from repro_torch.training.optimizer import OptConfig
    full = resolve_config("olmoe-1b-7b")
    cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS, segments=(
        Segment(full.segments[0].pattern, TRAIN_LAYERS),)).validate()
    opt = OptConfig(learning_rate=1e-3, total_steps=TRAIN_STEPS,
                    warmup_steps=max(TRAIN_STEPS // 10, 1))
    data = SyntheticLMData(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    batch_fn = lambda step: {"tokens": torch.from_numpy(data.batch_at(step)["tokens"]).cuda()}
    step_fn = make_step(cfg, opt, RunConfig(remat_policy=TRAIN_REMAT))
    runs = []
    for run in range(2):
        if runs:                          # the first run's state goes
            runs[-1].pop("state")
            gc.collect()
            torch.cuda.empty_cache()
        runs.append(train_run(torch, cfg, full, opt, step_fn, batch_fn, run))
    losses = [r["losses"] for r in runs]
    log(f"train [{TRAIN_LABEL}]: losses of the two runs equal at all {TRAIN_STEPS} steps: "
        f"{losses[0] == losses[1]}; median steps {runs[0]['median']:.3f} and "
        f"{runs[1]['median']:.3f} s")
    if losses[0] != losses[1]:
        raise AssertionError(f"[{TRAIN_LABEL}] two runs from one seed differ: {losses}")
    state = runs[-1]["state"]
    batch = batch_fn(TRAIN_STEPS)
    check_train_against_plain(torch, cfg, state["params"], batch)
    profile_train_step(torch, step_fn, state, batch)
    log(f"train [{TRAIN_LABEL}]: peak memory since the second run's weights were made "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return {k: runs[0]["launches"][k] for k in TRAIN_KERNELS}


def train_run(torch, cfg, full, opt, step_fn, batch_fn, run):
    """One run of path d from fresh seed-0 weights: TRAIN_STEPS steps, each
    timed to a device sync. Checks the launches, finite losses and grad
    norms, and that the parameters moved; returns {state, launches, losses,
    median}."""
    from repro_torch.kernels import build
    from repro_torch.models.params import init_model, tree_leaves
    from repro_torch.training.loop import LoopConfig, train_loop
    from repro_torch.training.train_state import make_train_state
    label = f"{TRAIN_LABEL} run {run + 1}"
    log(f"train [{label}]: before {cfg.name}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"still allocated")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = make_train_state(init_model(cfg, seed=0, device="cuda"), opt)
    torch.cuda.synchronize()
    leaves = tree_leaves(state["params"])
    n_params = sum(t.numel() for t in leaves)
    p_bytes = sum(t.numel() * t.element_size() for t in leaves)
    o_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(state["opt"]["mu"]) + tree_leaves(state["opt"]["nu"]))
    log(f"train [{label}]: {cfg.name} cut to {cfg.num_layers} of {full.num_layers} layers, "
        f"random init (seed 0) {n_params / 1e9:.2f}B params in {time.perf_counter() - t0:.1f}s; "
        f"parameters {p_bytes / 2**30:.2f} GiB, optimizer state (mu, nu) "
        f"{o_bytes / 2**30:.2f} GiB")
    record = []

    def timed_step(state, batch):
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t, m["loss"], m["grad_norm"], m["lr"]))
        return state, m

    watch = state["params"]["segments"][0]["blocks"][0]["mixer"]["wq"]["kernel"]
    before = watch.detach().clone()
    build.reset_launch_counts()
    loop = train_loop(state, timed_step, batch_fn, LoopConfig(total_steps=TRAIN_STEPS,
                                                              log_every=1), log=log)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    times = [r[0] for r in record]
    losses = [float(r[1]) for r in record]
    norms = [float(r[2]) for r in record]
    med = sorted(times)[len(times) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"train [{label}]: {loop.step} steps of {tokens} tokens, remat={TRAIN_REMAT}; "
        f"losses {losses}; grad norms {[round(x, 4) for x in norms]}; "
        f"lr {[r[3] for r in record]}; step times (s) {[round(x, 4) for x in times]}, median "
        f"{med:.4f} s, {tokens / med:.0f} tokens/s; stragglers={loop.stragglers}; peak "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"train [{label}]: kernel launches on the path: {json.dumps(launches)}")
    fwd_per_layer = 2 if TRAIN_REMAT == "full" else 1   # the recompute runs the forward again
    want = {"flash_attention": TRAIN_LAYERS * TRAIN_STEPS * fwd_per_layer,
            "flash_attention_bwd": TRAIN_LAYERS * TRAIN_STEPS}
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if bad:
        raise AssertionError(f"[{label}] launches (got, want): {bad}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"[{label}] non-finite loss or grad norm")
    if torch.equal(before, watch.detach()):
        raise AssertionError(f"[{label}] the parameters did not move")
    return dict(state=state, launches=launches, losses=losses, median=med)


def check_train_against_plain(torch, cfg, params, batch):
    """The loss and the gradients of layer 0's attention projections from
    the same parameters and batch through the kernels and through the plain
    path (``use_kernels=False``): the loss within 1e-2 relative, each
    gradient within 5e-2 of its largest entry (bf16 activations, summed
    in other orders by the two paths' attention)."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models.model import loss_fn
    mixer = params["segments"][0]["blocks"][0]["mixer"]
    names = ("wq", "wk", "wv", "wo")
    out = {}
    for use_kernels in (True, False):
        plan = ExecutionPlan(moe_impl="grouped", use_kernels=use_kernels)
        loss, _ = loss_fn(params, cfg, batch, plan=plan, remat=TRAIN_REMAT)
        grads = torch.autograd.grad(loss, [mixer[n]["kernel"] for n in names])
        out[use_kernels] = (loss.item(), [g[0].float() for g in grads])
        del loss, grads
    (lk, gk), (lp, gp) = out[True], out[False]
    rel = abs(lk - lp) / abs(lp)
    errs = [((a - b).abs().max().item(), b.abs().max().item()) for a, b in zip(gk, gp)]
    log(f"train [{TRAIN_LABEL}]: kernels vs plain path on one step: loss {lk:.5f} vs "
        f"{lp:.5f} (rel {rel:.2e}, tolerance 1e-2); layer 0 attention gradients "
        + ", ".join(f"{n}: max|d|={e:.3e} of max|g|={m:.3e}" for n, (e, m) in zip(names, errs))
        + " (tolerance 5e-2 x max|g|)")
    if not math.isfinite(lk) or rel > 1e-2 or any(e > 5e-2 * m for e, m in errs):
        raise AssertionError(f"[{TRAIN_LABEL}] kernel path disagrees with the plain path")


def profile_train_step(torch, step_fn, state, batch, top: int = 12):
    """One more step under torch.profiler (device activity only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_profile(prof, TRAIN_LABEL, "one training step", wall, top, also=("flash", "index"))


def check_against_plain(torch, cfg, params, label, flags):
    """One mixed stage (a 64-token chunk after a written 64-token prefix,
    plus two decode rows) through the path's kernels and through the plain
    torch path, each on its own fresh cache; the logits are held to
    ``compare_logits`` (its 5% band also covers, with int8 pages, the
    kernels' per-page against the plain path's whole-row requantization of
    p*v_scale)."""
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
    ragged = flags.get("moe_ragged", True)
    for use_kernels in (True, False):
        plan = ExecutionPlan(moe_impl="duplex", k_cold=32, c_hot=64, c_cold=16,
                             moe_ragged=ragged and use_kernels, use_kernels=use_kernels)
        cache = init_cache(cfg, page_size=page, num_pages=32, device="cuda",
                           kv_quant=flags.get("kv_quant", False))
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
    compare_logits(torch, label, "one mixed stage", out[True], out[False])


def compare_logits(torch, label, what, a, b):
    """Kernel-path logits ``a`` against plain-path logits ``b`` (rows,
    vocab): finite, within 5% of the logit scale (bf16 noise), and every
    argmax whose top-2 margin exceeds twice the difference must match."""
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    top2 = b.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * diff
    agree = (a.argmax(-1) == b.argmax(-1)) | ~clear
    equal = int((a.argmax(-1) == b.argmax(-1)).sum())
    log(f"serve [{label}]: kernels vs plain path on {what}: max |dlogit|="
        f"{diff:.4f} (tolerance {0.05 * scale:.4f} = 5% of the logit scale {scale:.2f}); "
        f"argmax equal on {equal}/{len(agree)} rows, agree on {int(agree.sum())}/"
        f"{len(agree)} ({int(clear.sum())} with a clear top-2 margin)")
    if not bool(torch.isfinite(a).all()) or diff > 0.05 * scale or not bool(agree.all()):
        raise AssertionError(f"[{label}] kernel path disagrees with the plain path")


def tensor_core_sass(build) -> None:
    """Counts the tensor-core instructions in each built library's SASS
    (``cuobjdump -sass``): warpgroup products (HGMMA) and warp ones (HMMA).
    The bf16 flash forward and backward must hold HGMMA."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    for src in build.SOURCES:
        sass = subprocess.run([str(tool), "-sass", str(build._lib_path(src))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        hgmma = len(re.findall(r"\bHGMMA\.", sass))
        hmma = len(re.findall(r"\bHMMA\.", sass))
        log(f"sass {src}: {hgmma} HGMMA and {hmma} HMMA instructions "
            f"({'tensor cores' if hgmma or hmma else 'no tensor-core instruction'})")
        if src in ("flash_fwd_sm90.cu", "flash_bwd_sm90.cu") and not hgmma:
            raise AssertionError(f"the SASS of {src} holds no HGMMA")


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
    # path d allocates and frees multi-GB activations: growable segments keep
    # the allocator from fragmenting (read when CUDA initialises)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    tensor_core_sass(build)

    rows = kernel_phase(torch)
    if not args.kernels_only:
        for name, n in serve_phase(torch).items():
            rows[name]["launches"] = n
        gc.collect()                      # the OLMoE model and its caches go
        torch.cuda.empty_cache()
        for name, n in hybrid_phase(torch).items():
            rows[name]["launches"] = n
        gc.collect()                      # the Jamba model and its caches go
        torch.cuda.empty_cache()
        for name, n in train_phase(torch).items():
            rows[name]["launches"] = n
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
