#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase: the kernels, the paths, training
    python3 chip_smoke.py --kernels-only

Phases, each printing a line:
  1. environment: torch / CUDA versions and the card's name and power limit;
  2. kernel build (nvcc, all sources in parallel) and its time, each
     source's ptxas registers and spills, and the count of tensor-core
     instructions (HGMMA, HMMA, IGMMA, IMMA) in each library's SASS
     (``cuobjdump``; the bf16 flash forward and backward and the bf16 chunk
     attention must hold HGMMA, the bf16 hot GEMM and cold GEMV and the
     float32 chunk attention HMMA or HGMMA, the int8 chunk attention IMMA or
     IGMMA);
  3. each hand-written kernel against its plain PyTorch version on the card
     at OLMoE-1B-7B shapes (plus a GQA shape for the attention kernels,
     path a's decode lengths for the paged decode, and one of path a's
     chunk stages and a stage of path i's verify spans (16 rows of 8, spans
     of 2-5 positions at path a's lengths) for the chunked prefill, whose
     bf16 cases must run its wgmma route and float32 ones its 3xTF32 route
     (also at internvl2-1b's heads at head_dim 64 on pages of 8, and on
     pages of 64; the first case and path a's also time the scalar kernel
     that ran float32 before, and every float32 case prints the bound of
     three TF32 products), as the hot GEMMs' and the cold GEMVs' bf16
     cases must run theirs; the
     int8 paged decode and chunk also at path b's decode lengths and chunk
     stage, the decode on its split route held against that route's plain
     version, the chunk on its int8 tensor-core route; the
     ragged hot GEMM also at C 136, a second 128-row pass; the ragged MoE
     pair also at Jamba-v0.1's widths and path c's decode capacities, each
     MoE case judged on its error over max(1, the largest |plain| entry);
     the dense decode attention and the SSD decode at Jamba-v0.1's shapes,
     the dense decode also at path c's decode lengths and at OLMoE-1B-7B's
     heads (16 over 16, Smax 1024, also at path f's decode lengths), the
     SSD decode also
     at Mamba2-2.7B's, judged on its error over max(1, the largest |plain|
     entry); the flash
     forward and backward at path d's shape, Jamba-v0.1's GQA heads, a
     window with a softcap, 96 heads over 8 and a length that is not a
     tile multiple; both also at gemma3-4b's head_dim 256 and 8 heads over
     4 at S 2048, windowed 1024 and causal (the backward also at S 2047
     under a softcap of 50), in bfloat16 only: the float32 routes refuse
     head_dim 256; the forward's bf16 score chain (``score_bf16``) at path
     d's shape in bfloat16 and float32 and at gemma3-4b's causal head_dim
     256, against the plain chain within 2e-2, and nearer the plain chain
     at the kernel's own key tiles than the plain version without the
     chain is, by CHAIN_SEP in mean; the dense decode also
     at path l's global decode, head_dim 256, qpk 2, Smax 4096, 16
     sequences at its lengths; at head_dim 64, the dense decode at path
     o's and path p's decodes, the flash forward at whisper-small's
     non-causal encoder (8 x 1500 frames, 12 heads) and internvl2-1b's
     causal prefill (8 x 1280, 14 heads over 2) and the backward at the
     encoder's (4 x 1500); the ragged MoE pair at deepseek-moe-16b's d_ff
     1408 and path n's capacities), in
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
       a. bf16 KV pages and the duplex ragged MoE (the first path; every
          chunked prefill call must run the tensor-core route),
       b. int8 KV pages (``kv_quant``) and the capacity-padded duplex MoE
          (``moe_ragged=False``; every int8 decode call must run the split
          route of ``decode_sm90.cu``, every int8 chunk call
          ``chunk_int8_sm90.cu``);
     each checks that every request completes with in-vocabulary tokens,
     that each of its kernels was launched, every hot GEMM and cold GEMV
     launch on the tensor-core route (``moe_gemm_sm90.cu``,
     ``moe_gemv_sm90.cu``; a prints its paged decode
     launches, all through ``decode_sm90.cu``), and that one mixed stage's
     logits through the kernels agree with the plain (kernel-free) torch
     path, then profiles a short run; b also prints both paths' KV pool
     bytes;
       r. the paper's analytic simulator (``repro_torch.sim``) on the
          card's host: path a's engine serves the short profiled run's four
          requests (128-256 tokens, 8 new) through ``run``, then again stage
          by stage (``plan_stage``, ``dispatch_stage``, ``commit_stage``)
          in one CUDA-only profile, its tokens equal to the first run's and
          kernels 1-4 launched on their routes; each stage's mix through
          ``stage_exec`` on the modelled H100 (and on the modelled Duplex
          device: "duplex", "duplex_pe"), each finite and positive; prints
          the stage counts, the modelled totals, breakdown and median
          stages, the card's device time (attention kernels, MoE kernels,
          the rest) and host wall, and measured over modelled; then Fig.
          11's quick Mixtral grid (requests cut to max(2 x batch, 48)) and
          Table I's parameter counts, each within 1e-9 of the reference's
          (``R_EXPECT``), Duplex > 1.3x the GPU at 256 tokens and
          Duplex+PE+ET at least 0.95x Duplex;
       t. float32: OLMoE-1B-7B at full width and depth with float32
          weights and activations (27.7 GB), path r's four requests on path
          a's engine (after path a's bf16 weights are freed): every chunk
          call on the 3xTF32 route (``chunk_f32_sm90.cu``; none on the
          scalar kernel), kernel 1 and the float32 hot GEMM and cold GEMV
          (``moe_gemm.cu``, ``moe_gemv.cu``) launched, their counts
          printed; the greedy tokens equal to the plain float32 path's on
          the same engine, its router calls pinned to the kernel run's
          expert choices; prints the stages, the wall, tokens/s and a short
          profile's device busy share;
       e. a shared system prompt on an oversubscribed pool: 16 requests of
          one 256-token system prompt and a seeded private suffix of 64-256
          tokens, bf16 pages and the ragged MoE with ``prefix_share`` and
          ``preemption="recompute"``, ``kv_num_pages`` a quarter of the
          pages the requests would need over their lifetimes without sharing
          (shared, they need less than half); it checks completion, that requests were preempted and
          shared prompt positions skipped, an empty ``kv.audit()`` and a
          drained pool, kernels 1-4 launched (the chunk calls and the MoE
          calls on their tensor-core routes), and one mixed stage whose
          chunk row starts after an adopted shared prefix (its pages also
          in a decode row's table) through the kernels against the plain
          path, each on its own copy of the pool;
       f. the dense KV layout with migrate preemption over 8 slots, path
          a's 16 requests: completion, preemptions, the dense decode's
          launches (all through ``decode_sm90.cu``) and the MoE kernels on
          their tensor-core routes, and one dense mixed stage (chunk rows
          and decode rows) through the kernels against the plain path;
          prints the dense KV bytes and the bytes migrated to the host, and
          profiles a short run;
       g. overload and faults, two runs: g1 serves path e's requests on path
          e's engine under a seeded ``FaultInjector`` (page-allocation
          failures, forced evictions, step errors, latency spikes) with the
          per-stage audit, on the wall clock; g2 serves 32 requests (path
          a's lengths twice) on path a's engine with a queue of 8 that sheds
          its oldest, aging every 4 stages, finish deadlines, first-token
          SLOs and two cancels (one queued, one mid-prefill), on a virtual
          clock of 0.1 s a stage. Each checks the launches of kernels 1-4
          (the chunk and MoE calls on their tensor-core routes), an empty
          audit and a drained pool, and holds its counters (g1: stages,
          aborts, retries, preemptions, forced evictions, fault counts; g2:
          stages, sheds, expiries by deadline and by SLO, cancels, rejects,
          aging promotions, completions) equal to the schedule the port's
          engine forms on the CPU (``G1_EXPECT``, ``G2_EXPECT``); g1 also
          needs every request completed, an aborted stage and a retry, and
          prints how many requests emitted path e's tokens, g2 every request
          terminal as length, shed, expired or cancelled;
       h. the async loop: path a's engine and requests through ``run`` and
          ``run_async``, two pairs in the order sync async, async sync
          (three before), every ``dispatch_stage`` under torch's sync debug
          mode "error"; each run checks 16/16 completed with 32 tokens, a
          drained pool with an empty audit, kernels 1-4 on their
          tensor-core routes and the schedule counters (stages, chained
          stages, spec hits and misses, gap stages) equal to the CPU's
          (``H_EXPECT``), and prints its wall, tokens/s, TBT, TTFT, host
          gap, the mean host time a stage in plan, enqueue, wait, commit
          and deferred commit, and how many requests emit path a's tokens
          (each other one with its first departing position and the top-2
          logit gap there); then a short profile in each loop (its launch
          counts stay out of the ``kernels`` line);
       i. speculative decoding: path a's engine with ``spec_k=4``,
          ``spec_ngram=3`` and the per-stage audit on 16 requests (path a's
          first 8 prompts and 8 that repeat a seeded 8-token pattern to
          128-512 tokens, 32 new tokens each), three runs: spec_k 0 through
          ``run``, spec_k 4 through ``run`` and through ``run_async``, every
          ``dispatch_stage`` under sync debug "error"; each checks 16/16
          completed with 32 tokens, a drained pool with an empty audit, its
          ``on_token`` stream equal to its outputs and kernels 1-4 on their
          tensor-core routes, the spec runs drafts proposed, the async run
          plans missed for drafts or rewinds; each prints its stages with and
          without a verify span, drafts proposed and accepted, rewinds,
          acceptance, wall, tokens/s, TBT, TTFT, the mean chunk rows and slab
          tokens a stage and its host split, the spec runs how many requests
          emit run 1's tokens, each other one with its first departing
          position and the top-2 logit gap there, which must be at most
          ``SPEC_GAP_BAND``; then one stage of run 2 with verify spans (and a
          prefill chunk) through the kernels against the plain path on the
          kernel path's expert choices, the logits of every live verify
          position included, the float32 LM head's time over a spec stage's
          slab, and a short profile (its launch counts stay out of the
          ``kernels`` line);
       j. the fleet: one parameter set behind three replicas of path e's
          engine (8 slots each, a full pool), 24 requests of three tenants
          (each tenant's own 256-token system prompt, a 64-256-token
          suffix, 32 new tokens) arriving one a tick on a virtual clock of
          0.1 s a tick, three runs: j1 the affinity router, j2 round-robin,
          j3 affinity with pipelined ticks (``step_async``) under a seeded
          injector forked per replica (g1's rates plus replica kills and
          spikes, ``min_live=1``) and a kill of replica 1, a join and a
          drain of replica 2 at set ticks; every ``dispatch_stage`` under
          sync debug "error". Each checks every request terminal exactly
          once with 32 tokens, clean audits, clean drains, kernels 1-4 on
          their routes and its counters equal to the CPU schedule
          (``J_EXPECT``); j1 must skip more shared prompt positions than
          j2, j3 must kill and fail over and depart from j1's tokens only
          at a top-2 gap within ``SPEC_GAP_BAND``; each prints its wall,
          ticks, tokens/s, TBT, TTFT, the host plan ms a stage (the Op/B
          plan included), routing and skips by replica and the peak
          memory. Then, with the OLMoE model freed,
       k. the serve CLI, ``repro_torch.launch.serve.main`` in-process on
          OLMoE-1B-7B with its own weights: k1 one engine (16 requests of
          ~256 tokens, paged, chunks of 64, the kernels), k2 the same
          through a two-replica fleet with sharing, chaos seed 0, pipelined
          ticks and ``--profile``; each must exit 0 with 16/16 completed,
          kernels 1-4 on their routes, its engines' k_cold range and
          bandwidth-path FLOP fraction printed, k2 a trace file; then k3,
          path a's engine and requests at temperature 0.8, top-k 50, top-p
          0.95, seed 0, twice, every dispatch under sync debug "error":
          16/16 with 32 in-vocabulary tokens, kernels 1-4 on their routes,
          the two runs' tokens equal, some off path a's greedy tokens.
          Then
       c. Jamba-v0.1 (Mamba-2 + GQA attention + MoE) at full width, depth
          cut to 16 of its 32 layers (two of four periods; the whole model,
          ~103 GB in bf16, does not fit one 80 GB card), the same 16
          requests on the dense KV layout (the engine's layout for a hybrid
          stack) with the legacy whole-prompt prefill
          (``prefill_chunk_tokens=None``) and
          the duplex ragged MoE; it checks completion, the launches of the
          dense decode attention (all through ``decode_sm90.cu``), SSD
          decode and ragged MoE kernels (every hot GEMM and cold GEMV
          launch on the tensor-core route), a decode stage of three live
          rows and three of seven live rows (seeds 1-3) through the kernels
          against the plain path, the plain path taking the kernel path's
          expert choices (each row's top-2 logit gap printed beside its
          difference, and any MoE layer where the plain router would choose
          otherwise, with its margin: a near-tie shows as one), prints
          the dense KV and SSM state bytes and the peak memory, and
          profiles a short run. Then, with the Jamba model freed,
       l. gemma3-4b at full width and depth (34 layers: 29 with a window of
          1024 positions, 5 global; head_dim 256, 8 heads over 4), random
          weights from seed 0, 16 requests (prompts of 256-2048 tokens, 64
          new) on the dense layout with ``max_len`` 4096 (each local
          layer's row a ring of 1025 slots) and the legacy whole-prompt
          prefill, kernels on: 16/16 completed, the schedule (stages,
          decode stages, legacy prefills and those past the 512-position q
          block) equal to the CPU's (``L_EXPECT``), the dense decode
          launched 5 times a decode stage and the flash forward 34 times a
          long prefill, the KV bytes equal to the formula (16 slots x 4096
          B x (5 x 4096 + 29 x 1025)), and the decode logits of four
          requests (one at each side of the window) at their last 8
          positions against ``forward`` over their tokens through the plain
          versions (``compare_logits``); prints its wall, tokens/s, the
          median decode stage, TBT and TTFT and peak memory, and profiles
          a short run;
       l2. the same with int8 dense caches (``kv_quant``; no decode kernel,
          as the reference): the same gates (the dense decode never
          launched), KV bytes 2080/4096 of l's, and one model-level decode
          step after four prefills into a float32 and an int8 cache (path
          l's weights in float32, the plain path), their logits within 5%
          relative (the reference's rule, in its test's arithmetic; the
          bf16 figures printed beside it); prints its greedy agreement
          with l;
       m. qwen3-8b, command-r-35b and mistral-large-123b (paged, chunks of
          64, kernels 1 and 2) and mamba2-2.7b (dense, kernel 8), each at
          full width cut to 2 layers: 4 requests of 128-512 tokens and 8
          new to completion with its kernels launched, then one stage
          through the kernels against the plain path (a mixed stage with
          decode rows; for Mamba path c's decode stages). Then
       n. deepseek-moe-16b at full width and depth (28 layers: a dense FFN
          of 10944, then 27 layers of 64 routed experts top-6 of d_ff 1408
          and 2 shared ones of 2816 in all; 16.38B parameters, 32.76 GB in
          bf16) on path a's engine and requests: 16/16 completed, kernels
          1-4 launched, the hot GEMM launched once an MoE layer a stage
          with a hot expert and the cold GEMV once an MoE layer a stage
          with a cold one (every MoE layer of every stage on the
          kernels), one mixed stage through the kernels against the plain
          path on the kernel path's expert choices, and the same stage
          with the shared experts zeroed, whose logits must move by more
          than the kernels' difference; prints the run's numbers, the KV
          pool and the peak memory, and profiles a short run;
       o. whisper-small at full width and depth (12 encoder and 12
          decoder layers, head_dim 64): 8 clips of 1500 seeded frame
          embeddings and a 4-token prompt, 64 new tokens through
          ``prefill`` and ``decode_step`` on a dense cache of max_len 448
          with cross caches of 1500: the flash forward (non-causal) 12
          times, the dense decode 12 times a step, the logits of 8 decode
          steps against the plain path on the kernel path's tokens, and
          prefill's logits against ``forward``'s;
       o2. one ``loss_fn`` and backward of whisper-small on 4 clips x
          (1500 frames + 448 tokens): the flash forward and backward 12
          times each, the loss and encoder layer 0's attention gradients
          against the plain path in path d's bands;
       p. internvl2-1b at full width and depth (24 layers, 14 heads over
          2, head_dim 64): 8 requests of 1024 seeded patch embeddings and
          70-247 text tokens, 32 new tokens through ``prefill`` (true_len
          = patches + text) and ``decode_step`` on a dense cache of 1536:
          the flash forward (causal, qpk 7) 24 times, the dense decode 24
          times a step, decode logits against the plain path and prefill's
          against each request's ``forward``. Then
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
       s. training at head_dim 256: gemma3-4b at full width (d_model 2560,
          8 heads over 4 of 256, d_ff 10240, vocabulary 262144, window
          1024, qk-norm, tied embeddings), depth cut to one period of its
          34 layers (5 local, 1 global), 3 steps of ``make_step`` (the
          trainer's default plan) driven by ``train_loop`` on
          ``SyntheticLMData`` batches of 2 x 2048, no remat: finite losses
          and grad norms, parameters that moved, each flash kernel (its
          head_dim-256 plan) launched 6 times a step; then one step's loss
          and the attention gradients of layers 0 (local) and 5 (global)
          through the kernels against the plain path, without and with
          ``attn_score_bf16``, and the kernels' response to the flag
          pointing the plain path's way (cosine over CHAIN_COS); prints
          the median step, the peak memory and
          one profiled step's device time by kernel beside the card.
       d2. checkpoints: OLMoE-1B-7B at full width and 1 layer, 6 steps of
          4 x 2048 with async keep-2 checkpoints every 2 steps, three
          runs: R1 uninterrupted; R2 sends itself SIGTERM during step 3,
          checkpoints there and stops; R3 starts from other weights,
          restores step 3 and runs to step 6. R2's losses then R3's must
          equal R1's bit for bit, R3's final state R1's, the checkpoints
          kept honour keep, and one leaf restores on the CPU with equal
          bits; it logs the free disk (and raises under (keep + 1)
          checkpoints), the bytes written, a sync save's seconds, an async
          save's snapshot and whole save, the restore and the steps with
          and without a write in flight, and removes its directory;
       d3. remat: path d's configuration for 3 steps under
          ``remat="dots"`` and ``"full"``; each run's losses must equal
          path d's first three bit for bit, the flash forward run twice a
          layer a step and the backward once; it logs the median step, the
          peak memory and the launches a step beside path d's.
       q. the sharded step builders (``launch/steps.py``) on a one-rank
          NCCL mesh at OLMoE-1B-7B's full width, no kernel launched (the
          reference's steps run none): ``make_train_step`` for 3 steps of
          path d's 4 x 2048 at 8 layers with one and two microbatches, each
          loss within path d's band (1e-2) of ``make_step``'s under the
          same plan; ``make_prefill_step`` on 1 x 8192 (the flash core at
          the grid's prefill tiles of 4096 positions, ``Q_PREFILL_TILE``) and
          ``make_serve_step`` on 16 rows over a 4096-position cache
          (``duplex_k_cold``'s plan) at full depth, their next tokens equal
          to the unsharded ``prefill`` and ``decode_step``'s. Then the dry
          run of each of the three steps in a fake one-rank group: its
          predicted per-device peak within 25% of the card's (the
          arguments plus ``max_memory_allocated`` over the step's start),
          its FLOPs, bytes and t_ideal beside the step's device time from
          torch.profiler, its roofline fraction finite and at most 1.05;
          and ``python -m repro_torch.launch.dryrun`` on one production
          cell (``Q_CELL``) in a subprocess, which must end ok on 256
          ranks.

Prints each kernel's launches by path, each phase's wall seconds (the
share of the time limit it takes), a ``kernels`` JSON line (each
kernel's launches summed over the paths that read them; the float32 routes
with a source of their own, path t's, have rows of their own), then
``{"ok": true, "device": ...}`` as the last line. Any failure raises, and the exit code is non-zero. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
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
              "tf32": 495e12,       # H100 SXM dense TF32 tensor-core peak
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


ROW_LENS = (0, 1, 15, 16, 17, 100, 257, 511, 512, 640, 700, 800, 900, 1000, 1023, 1024)
# path a's decode lengths: 16 prompts of 128-512 tokens plus up to 32 new ones
PATH_A_LENS = tuple(round(144 + i * 400 / 15) for i in range(16))
# path c's decode lengths: the same prompts, from the first decode step on
PATH_C_LENS = tuple(round(128 + i * 416 / 15) for i in range(16))
# path f's: path a's lengths over its 8 dense slots
PATH_F_LENS = tuple(round(144 + i * 400 / 7) for i in range(8))
# path l's global decode: its 16 prompts (256-2048) 32 tokens into decode
PATH_L_LENS = tuple(round(256 + i * 1792 / 15) + 32 for i in range(16))
# path i's verify spans: 2-5 positions (the last token and 1-4 drafts) at
# path a's decode lengths, in rows of 8 (the bucket of a stage of spans alone)
PATH_I_SPANS = tuple(2 + i % 4 for i in range(16))


def check_decode(torch, gen, dtype, *, KV, qpk, window=0, softcap=0.0, int8=False,
                 lens=ROW_LENS, seed=None):
    """Paged decode; ``seed`` draws the inputs from a generator of their own,
    so that the cases after this one draw what they drew without it. The
    int8 kernel must take its split route (``decode_sm90.cu``, page 16) and
    is held against that route's plain version, split by split."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attn as da
    if seed is not None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
    B, hd, page, maxp = len(lens), 128, 16, 64
    P = 1 + B * maxp
    kp, vp = _pools(torch, gen, P, KV, page, hd, dtype)
    bt = _tables(torch, gen, lens, page, maxp, P)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn((B, KV, qpk, hd), generator=gen, device="cuda").to(dtype)
    kw = dict(window=window, softcap=softcap)
    fp_call = lambda: da.paged_decode_attention_kernel(q, kp, vp, lengths, bt, **kw)
    if int8:
        k8, ks, v8, vs = _quant_pools(kp, vp)
        args = (q, k8, ks, v8, vs, lengths, bt)
        kernel = da.paged_decode_attention_int8_kernel
        plain = lambda *a, **k: da.paged_decode_attention_int8_split_plain(
            *a, pages_per_split=da.INT8_PAGES_PER_SPLIT, **k)
    else:
        args = (q, kp, vp, lengths, bt)
        kernel, plain = da.paged_decode_attention_kernel, da.paged_decode_attention_plain
    split = build.launch_counts["paged_decode_attention_int8_sm90"]
    got = kernel(*args, **kw)
    split = build.launch_counts["paged_decode_attention_int8_sm90"] - split
    if split != int8:
        raise AssertionError(f"paged decode int8={int8} took the wrong route "
                             f"(int8 split launches {split})")
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


@contextlib.contextmanager
def scalar_chunk_route():
    """Inside, every float chunk attention call takes the scalar kernel of
    ``decode_attn.cu``, the float32 route before ``chunk_f32_sm90.cu``:
    its figure, timed in the same run as its successor's."""
    from repro_torch.kernels import decode_attn as da
    route = da.chunk_route
    da.chunk_route = lambda *a: "chunked_prefill_attention"
    try:
        yield
    finally:
        da.chunk_route = route


def check_chunk(torch, gen, dtype, *, KV, qpk, int8=False, starts=(0, 64, 448, 0),
                clens=(64, 64, 30, 0), Sc=64, hd=128, page=16, scalar=False):
    """Chunked prefill; by default four sequences of ``Sc`` 64 with a short
    chunk and a padded row (totals == 0), over a table of 1024 keys. The
    float kernel's bf16 case must run the wgmma route (``chunk_attn_sm90.cu``),
    float32 the 3xTF32 one (``chunk_f32_sm90.cu``); the int8 kernel must run
    its tensor-core route (``chunk_int8_sm90.cu``) in both. Float32 cases
    also print the 3xTF32 reckoning of the bound (three products at the
    TF32 tensor cores' 495 TFLOP/s, or the bytes) and, with ``scalar``, the
    scalar kernel's times on the same inputs."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attn as da
    maxp = 1024 // page
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
        routes = {"chunked_prefill_attention_int8_sm90": 1}
    else:
        args = (q, kp, vp, tot, st, bt)
        kernel, plain = (da.chunked_prefill_attention_kernel,
                         da.chunked_prefill_attention_plain)
        routes = {"chunked_prefill_attention_sm90": int(dtype == torch.bfloat16),
                  "chunked_prefill_attention_f32_sm90": int(dtype == torch.float32)}
    before = {r: build.launch_counts[r] for r in routes}
    got = kernel(*args, qpk=qpk)
    took = {r: build.launch_counts[r] - n for r, n in before.items()}
    if took != routes:
        raise AssertionError(f"chunked prefill {dtype} int8={int8} took the wrong route "
                             f"(tensor-core launches {took}, expected {routes})")
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
    if dtype == torch.float32 and not int8:
        tf32, by = bound_ms(out["nbytes"], 3 * out["flops"], "tf32")
        out["lib_detail"] = f" 3xTF32 bound_ms={tf32:.4f} ({by})"
        if scalar:
            with scalar_chunk_route():
                n = build.launch_counts["chunked_prefill_attention_f32_sm90"]
                err = (kernel(*args, qpk=qpk) - want).abs().max().item()
                out["scalar_ms"] = time_ms(lambda: kernel(*args, qpk=qpk))
                out["scalar_graph_ms"] = graph_ms(torch, lambda: kernel(*args, qpk=qpk))
                if build.launch_counts["chunked_prefill_attention_f32_sm90"] != n:
                    raise AssertionError("the scalar chunk route was not taken")
            out["lib_detail"] += (f" scalar_kernel_ms={out['scalar_ms']:.4f} scalar_graph_ms="
                                  f"{out['scalar_graph_ms']:.4f} (max_abs_err {err:.3e}); "
                                  f"graph_ms below SDPA's {out['graph_ms'] < out['lib_ms']}, "
                                  f"below the scalar kernel's "
                                  f"{out['graph_ms'] < out['scalar_graph_ms']}")
    return out


def check_dense(torch, gen, dtype, *, KV, qpk, window=0, softcap=0.0, lens=None, seed=None,
                hd=128, Smax=1024):
    """Decode attention over a dense (B, Smax, KV, hd) cache, read in place:
    by default 16 sequences of seeded lengths 0-Smax (one at 0, one at
    Smax), else one a length of ``lens``. ``seed`` draws the inputs from a
    generator of their own, so that the cases after this one draw what they
    drew without it."""
    from repro_torch.kernels import decode_attn as da
    if seed is not None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
    B = 16 if lens is None else len(lens)
    if lens is None:
        lens = torch.randint(0, Smax + 1, (B,), generator=gen, device="cuda").to(torch.int32)
        lens[0], lens[1] = 0, Smax
    else:
        lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
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
    its (cloned) state in place. y and the new state are each judged on
    their error over max(1, their largest |plain entry|) (``rel_err``; |y|
    reaches ~220 at Mamba2-2.7B's shape, where one bf16 step is 1.0); ``err``
    is the larger absolute error."""
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
    errs = [(y_k.float() - y_p.float()).abs().max().item(), (s_k - s_p).abs().max().item()]
    scales = [y_p.float().abs().max().item(), s_p.abs().max().item()]
    work = state.clone()
    item = x.element_size()
    return dict(err=max(errs), rel_err=max(e / max(1.0, m) for e, m in zip(errs, scales)),
                scale=scales[0],
                detail=" ".join(f"{n}: err={e:.3e} max|plain|={m:.3g};"
                                for n, e, m in zip(("y", "state"), errs, scales)),
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


def _sdpa(torch, q, k, v, causal, window=0):
    """The library yardstick in (B, H, S, hd) views; K/V of a GQA shape go
    in by ``enable_gqa`` where the installed PyTorch has it, else repeated
    here, outside any timed region. A window goes in as an explicit boolean
    mask (causal and banded), made here. Returns a call."""
    F = torch.nn.functional
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kw = dict(is_causal=causal)
    if window:
        pos = torch.arange(q.shape[1], device=q.device)
        d = pos[:, None] - pos[None, :]
        kw = dict(attn_mask=(d < window) & ((d >= 0) if causal else True))
    if q.shape[2] == k.shape[2]:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)
    try:
        F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
    except TypeError:
        rep = q.shape[2] // k.shape[2]
        kt, vt = kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


# the band of the bf16 score chain's cases, in either dtype: the kernels
# and the plain chain round the same values to bf16, and a score or p at a
# rounding boundary (exp against ex2, tanh on another core) moves by a bf16
# step
CHAIN_TOL = 2e-2
# a run with the score chain must lie nearer the plain chain at its own key
# tiles than the plain version without the chain does, by this factor (the
# band alone is as wide as the chain's whole effect, so it would pass a
# kernel that ignores the flag; measured on an H100: 0.000-0.001)
CHAIN_SEP = 0.05
# path s: the kernels' response to the flag (the chain's gradients less the
# chain-free ones) against the plain path's, the least cosine (measured on
# an H100: 0.476 and 0.601; a kernel that ignores the flag gives 0, since
# its two runs are the same bits). Looser than CHAIN_SEP: kernel 9b's bf16
# P and dS, and the local layers' key tiles that start off the 64-key
# grid, move the gradients about as far as the chain does
CHAIN_COS = 0.25


def key_tile(torch, dtype, hd):
    """The keys a tile of the flash forward a query row walks in order:
    KT of ``flash_fwd_sm90.cu`` (128, 64 at hd 256) for bf16, TK of
    ``flash_attn.cu`` (64) for float32. The score chain rounds p against
    the running max, so its result depends on where the key tiles start:
    the plain chain at these blocks runs the kernel's own schedule."""
    return 64 if dtype == torch.float32 or hd == 256 else 128


def chain_gate(kernel, plain_chain, plain_off, names=("out", "lse")):
    """(ok, detail) of the score chain's separation: the mean |difference|
    of each tensor (a kernel's float32 output and lse, or a step's
    gradients) between the kernel run and the plain chain must be under
    CHAIN_SEP times that between the plain version without the chain and
    the plain chain. Means, since a bf16 value at a rounding boundary moves
    by a whole step either way, and so the largest difference is one step
    in both."""
    ok, parts = True, []
    for name, a, b, c in zip(names, kernel, plain_chain, plain_off):
        err, effect = (a - b).abs().mean().item(), (c - b).abs().mean().item()
        ok &= err < CHAIN_SEP * effect
        parts.append(f"{name}: mean|kernel - chain|={err:.3e} mean|no chain - chain|="
                     f"{effect:.3e} (ratio {err / effect if effect else float('inf'):.3f})")
    return ok, "; ".join(parts)


def check_flash(torch, gen, dtype, *, B, S, H, KV, causal=True, window=0, softcap=0.0,
                hd=128, score_bf16=False):
    """The flash forward on the model layout, called as the training path
    calls it (``f32_out=True``: bf16 runs the tensor-core kernel, which also
    writes the float32 output): out, lse and the float32 output against the
    plain version (the error is the largest of the three); with
    ``score_bf16`` the bf16 score chain on both sides, held to CHAIN_TOL,
    and the float32 output and lse held by ``chain_gate`` against the plain
    chain and the plain version without it.
    The library time is SDPA's, causal by ``is_causal``, a window by an
    explicit mask."""
    from repro_torch.kernels import flash_attn as fa
    q, k, v = _flash_inputs(torch, gen, dtype, B, S, H, KV, hd)
    kw = dict(causal=causal, window=window, softcap=softcap, f32_out=True,
              score_bf16=score_bf16)
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
    if score_bf16:
        tile = key_tile(torch, dtype, hd)
        at_tile = dict(kw, q_block=tile, kv_block=tile)
        _, lse_t, o32_t = fa.flash_attention_plain(q, k, v, **at_tile)
        _, lse_0, o32_0 = fa.flash_attention_plain(q, k, v, **dict(at_tile, score_bf16=False))
        out["tol"] = CHAIN_TOL
        ok, detail = chain_gate((o32, lse), (o32_t, lse_t), (o32_0, lse_0))
        far = ((o32 - o32_p).abs().mean().item(), (lse - lse_p).abs().mean().item())
        out["chain"] = (ok, f"at {tile}-key blocks {detail} (gate ratio < {CHAIN_SEP}); "
                            f"mean|kernel - chain at 512-key blocks| out {far[0]:.3e} lse "
                            f"{far[1]:.3e}")
    if not softcap:
        out["lib_ms"] = time_ms(_sdpa(torch, q, k, v, causal, window))
    return out


def check_flash_bwd(torch, gen, dtype, *, B, S, H, KV, causal=True, window=0, softcap=0.0,
                    hd=128):
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
    q, k, v = _flash_inputs(torch, gen, dtype, B, S, H, KV, hd)
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
    every slot live and computed. A bf16 call must run the tensor-core
    route (``moe_gemm_sm90.cu``, ``moe_gemv_sm90.cu``), a float32 one the
    scalar kernel. Judged on the error over max(1, the largest |plain|
    entry) (``rel_err``: one bf16 step at |y| >= 4 is 3.1e-2); ``err`` is
    the absolute error."""
    from repro_torch.kernels import build, moe_gemm, moe_gemv
    if hot:
        n = n or E - 32
        # at C=128 C//2 and C//2 + 1 are 64 and 65, either side of a 64-row
        # tile; at C=136 C - 1 and C are in the bf16 kernel's second pass
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
    sm90 = f"{'' if padded else 'ragged_'}moe_{'gemm' if hot else 'gemv'}_sm90"
    before = build.launch_counts[sm90]
    got = kernel(*args)
    if build.launch_counts[sm90] - before != (dtype == torch.bfloat16):
        raise AssertionError(f"{sm90[:-5]} {dtype} took the wrong route "
                             f"(tensor-core launches {build.launch_counts[sm90] - before})")
    want = plain(*args)
    torch.cuda.synchronize()
    item = x.element_size()
    live_experts = sum(1 for c in counts_l if c > 0)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return dict(err=err, rel_err=err / max(1.0, scale), scale=scale,
                detail=f"y: err={err:.3e} max|plain|={scale:.3g};",
                ms=time_ms(lambda: kernel(*args)),
                graph_ms=graph_ms(torch, lambda: kernel(*args)),
                plain_ms=time_ms(lambda: plain(*args), iters=5), lib_ms=None,
                nbytes=(live_experts * 3 * d * f * item + sum(counts_l) * d * item
                        + x.numel() * item + (1 if padded else 2) * n * 4),
                flops=2 * 3 * d * f * sum(counts_l))


# deepseek-moe-16b's routed experts (path n): E 64, d 2048, d_ff 1408
DEEPSEEK_MOE = dict(E=64, d=2048, f=1408)
# path o's decode, halfway through whisper's 64 new tokens after its
# 4-token prompt; path p's, halfway through internvl2's 32 new tokens
# after 1024 patches and its text (P_TEXT_LENS, path p's text lengths)
PATH_O_LENS = (4 + 32,) * 8
P_TEXT_LENS = (155, 162, 209, 247, 70, 91, 222, 247)   # numpy default_rng(1), 64-256
PATH_P_LENS = tuple(1024 + n + 16 for n in P_TEXT_LENS)

# Jamba-v0.1's MoE widths; on path c a decode stage is 16 bucketed tokens,
# so the engine's capacities are C_hot 8 and C_cold 8 (16 at k_cold 16)
JAMBA_MOE = dict(E=16, d=4096, f=14336)

KERNELS = [
    # name, TPU kernel it replaces, source, [(case label, check fn, kwargs[,
    # dtypes])][, (name, source) of the float32 route's own row]; every case
    # runs in bfloat16 (the main path's dtype; the first case is the main
    # path's shape) and again in float32, unless it names its dtypes
    ("paged_decode_attention",
     "src/repro/kernels/decode_attn.py:280",
     "src/repro_torch/kernels/csrc/decode_sm90.cu",
     [("olmoe qpk=1", check_decode, dict(KV=16, qpk=1)),
      ("gqa qpk=4", check_decode, dict(KV=4, qpk=4)),
      ("gqa qpk=4 window=200 softcap=30", check_decode,
       dict(KV=4, qpk=4, window=200, softcap=30.0)),
      ("path a B=16 lengths 144-544", check_decode,
       dict(KV=16, qpk=1, lens=PATH_A_LENS, seed=1))]),
    # bf16 runs chunk_attn_sm90.cu, float32 chunk_f32_sm90.cu (its own row,
    # from the float32 runs; the first and third cases also time the scalar
    # kernel that ran float32 before it); the third case is one of path a's
    # stages: one 64-token chunk after a 448-token prefix; the fourth a stage
    # of path i's verify spans; the last two float32 only: internvl2-1b's 14
    # heads over 2 at head_dim 64 on pages of 8, and pages of 64
    ("chunked_prefill_attention",
     "src/repro/kernels/decode_attn.py:503",
     "src/repro_torch/kernels/csrc/chunk_attn_sm90.cu",
     [("olmoe qpk=1 Sc=64", check_chunk, dict(KV=16, qpk=1, scalar=True)),
      ("gqa qpk=4 Sc=64", check_chunk, dict(KV=4, qpk=4)),
      ("path a B=1 start=448 Sc=64", check_chunk,
       dict(KV=16, qpk=1, starts=(448,), clens=(64,), scalar=True)),
      ("path i verify spans B=16 Sc=8 spans 2-5 starts 144-544", check_chunk,
       dict(KV=16, qpk=1, starts=PATH_A_LENS, clens=PATH_I_SPANS, Sc=8)),
      ("internvl2 KV=2 qpk=7 hd=64 page=8 Sc=64", check_chunk,
       dict(KV=2, qpk=7, hd=64, page=8), ("float32",)),
      ("olmoe qpk=1 Sc=64 page=64", check_chunk, dict(KV=16, qpk=1, page=64), ("float32",))],
     ("chunked_prefill_attention_f32_sm90", "src/repro_torch/kernels/csrc/chunk_f32_sm90.cu")),
    # bf16 runs moe_gemm_sm90.cu, float32 moe_gemm.cu (its own row)
    ("ragged_moe_gemm",
     "src/repro/kernels/moe_gemm.py:141",
     "src/repro_torch/kernels/csrc/moe_gemm_sm90.cu",
     # C=64: the hot capacity of a 272-token stage (16 decode rows + 4 chunks
     # of 64); C=128 puts counts at 64 and 65; C=136 takes the bf16 kernel's
     # second 128-row pass
     [("olmoe hot E=32 C=64", check_moe, dict(hot=True, C=64)),
      ("olmoe hot E=32 C=128", check_moe, dict(hot=True, C=128)),
      ("olmoe hot E=32 C=136", check_moe, dict(hot=True, C=136)),
      # path c's decode stages: k_cold 8, and k_cold 0 (every expert hot)
      ("jamba hot E=8 C=8", check_moe, dict(hot=True, n=8, C=8, **JAMBA_MOE)),
      ("jamba hot E=16 C=8", check_moe, dict(hot=True, n=16, C=8, **JAMBA_MOE)),
      # path n's mixed stages (72 bucketed tokens: 8 decode rows and a
      # 64-token chunk) all ran at k_cold 48: 16 hot experts of capacity 16
      # at d_ff 1408
      ("path n hot E=16 C=16 f=1408", check_moe, dict(hot=True, n=16, C=16, **DEEPSEEK_MOE))],
     ("ragged_moe_gemm_f32", "src/repro_torch/kernels/csrc/moe_gemm.cu")),
    # bf16 runs moe_gemv_sm90.cu, float32 moe_gemv.cu (its own row)
    ("ragged_moe_gemv",
     "src/repro/kernels/moe_gemv.py:114",
     "src/repro_torch/kernels/csrc/moe_gemv_sm90.cu",
     [("olmoe cold Ec=48 Cc=48", check_moe, dict(hot=False)),
      # path c's decode stages: k_cold 8, and k_cold 16 (every expert cold)
      ("jamba cold Ec=8 Cc=8", check_moe, dict(hot=False, n=8, C=8, **JAMBA_MOE)),
      ("jamba cold Ec=16 Cc=16", check_moe, dict(hot=False, n=16, C=16, **JAMBA_MOE)),
      # the same stages' 48 cold experts of capacity 16
      ("path n cold Ec=48 Cc=16 f=1408", check_moe,
       dict(hot=False, n=48, C=16, **DEEPSEEK_MOE))],
     ("ragged_moe_gemv_f32", "src/repro_torch/kernels/csrc/moe_gemv.cu")),
    # the split route of decode_sm90.cu; the third case is path b's decode
    # stage: 16 sequences at path a's lengths
    ("paged_decode_attention_int8",
     "src/repro/kernels/decode_attn.py:222",
     "src/repro_torch/kernels/csrc/decode_sm90.cu",
     [("olmoe qpk=1 int8", check_decode, dict(KV=16, qpk=1, int8=True)),
      ("gqa qpk=4 window=200 softcap=30 int8", check_decode,
       dict(KV=4, qpk=4, window=200, softcap=30.0, int8=True)),
      ("path b B=16 lengths 144-544 int8", check_decode,
       dict(KV=16, qpk=1, int8=True, lens=PATH_A_LENS, seed=3))]),
    # the int8 tensor-core route; the third case is path b's chunk stage
    ("chunked_prefill_attention_int8",
     "src/repro/kernels/decode_attn.py:446",
     "src/repro_torch/kernels/csrc/chunk_int8_sm90.cu",
     [("olmoe qpk=1 Sc=64 int8", check_chunk, dict(KV=16, qpk=1, int8=True)),
      ("gqa qpk=4 Sc=64 int8", check_chunk, dict(KV=4, qpk=4, int8=True)),
      ("path b B=1 start=448 Sc=64 int8", check_chunk,
       dict(KV=16, qpk=1, int8=True, starts=(448,), clens=(64,)))]),
    ("moe_gemm",
     "src/repro/kernels/moe_gemm.py:65",
     "src/repro_torch/kernels/csrc/moe_gemm_sm90.cu",
     [("olmoe hot padded E=32 C=64", check_moe, dict(hot=True, C=64, padded=True))]),
    ("moe_gemv",
     "src/repro/kernels/moe_gemv.py:57",
     "src/repro_torch/kernels/csrc/moe_gemv_sm90.cu",
     [("olmoe cold padded Ec=48 Cc=48", check_moe, dict(hot=False, padded=True))]),
    ("decode_attention",
     "src/repro/kernels/decode_attn.py:127",
     "src/repro_torch/kernels/csrc/decode_sm90.cu",
     [("jamba KV=8 qpk=4 Smax=1024", check_dense, dict(KV=8, qpk=4)),
      ("KV=8 qpk=1 window=200 softcap=30", check_dense,
       dict(KV=8, qpk=1, window=200, softcap=30.0)),
      ("path c B=16 KV=8 qpk=4 lengths 128-544", check_dense,
       dict(KV=8, qpk=4, lens=PATH_C_LENS, seed=2)),
      # OLMoE-1B-7B's heads, served on the dense layout by path f
      ("olmoe KV=16 qpk=1 Smax=1024", check_dense, dict(KV=16, qpk=1, seed=4)),
      ("path f B=8 KV=16 qpk=1 lengths 144-544", check_dense,
       dict(KV=16, qpk=1, lens=PATH_F_LENS, seed=5)),
      # gemma3-4b's global layers on path l: 16 sequences at its prompt
      # lengths halfway through their 64 new tokens, head_dim 256, qpk 2
      ("path l B=16 KV=4 qpk=2 hd=256 Smax=4096 lengths 288-2080", check_dense,
       dict(KV=4, qpk=2, hd=256, Smax=4096, lens=PATH_L_LENS, seed=6)),
      # head_dim 64: whisper-small's decoder self-attention on path o (12
      # heads over 12, max_len 448) and internvl2-1b's on path p (14 over 2)
      ("path o B=8 KV=12 qpk=1 hd=64 Smax=448 lengths 36", check_dense,
       dict(KV=12, qpk=1, hd=64, Smax=448, lens=PATH_O_LENS, seed=7)),
      ("path p B=8 KV=2 qpk=7 hd=64 Smax=1536 lengths 1110-1287", check_dense,
       dict(KV=2, qpk=7, hd=64, Smax=1536, lens=PATH_P_LENS, seed=8))]),
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
      ("ragged B=2 S=2047 H=16 KV=16 causal", check_flash, dict(B=2, S=2047, H=16, KV=16)),
      # gemma3-4b's prefill on path l (head_dim 256: bf16 only, the float32
      # route refuses it): a local layer's window of 1024, a global layer
      ("gemma3 B=1 S=2048 H=8 KV=4 hd=256 window=1024", check_flash,
       dict(B=1, S=2048, H=8, KV=4, hd=256, window=1024), ("bfloat16",)),
      ("gemma3 B=1 S=2048 H=8 KV=4 hd=256 causal", check_flash,
       dict(B=1, S=2048, H=8, KV=4, hd=256), ("bfloat16",)),
      # the bf16 score chain (attn_score_bf16) against the plain chain:
      # path d's shape in bf16 and float32, and path s's global layers
      ("olmoe B=4 S=2048 H=16 KV=16 causal score_bf16", check_flash,
       dict(B=4, S=2048, H=16, KV=16, score_bf16=True)),
      ("gemma3 B=1 S=2048 H=8 KV=4 hd=256 causal score_bf16", check_flash,
       dict(B=1, S=2048, H=8, KV=4, hd=256, score_bf16=True), ("bfloat16",)),
      # head_dim 64: whisper-small's encoder (non-causal, 1500 frames) on
      # path o and internvl2-1b's prefill (1024 patches + text) on path p
      ("whisper encoder B=8 S=1500 H=12 KV=12 hd=64 non-causal", check_flash,
       dict(B=8, S=1500, H=12, KV=12, hd=64, causal=False)),
      ("internvl2 B=8 S=1280 H=14 KV=2 hd=64 causal", check_flash,
       dict(B=8, S=1280, H=14, KV=2, hd=64))]),
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
       dict(B=2, S=2047, H=16, KV=16)),
      # whisper-small's encoder trained on path o2
      ("whisper encoder B=4 S=1500 H=12 KV=12 hd=64 non-causal", check_flash_bwd,
       dict(B=4, S=1500, H=12, KV=12, hd=64, causal=False)),
      # gemma3-4b trained on path s (head_dim 256: bf16 only, the float32
      # route refuses it): a global layer, a local layer's window of 1024,
      # and a ragged last tile under a softcap
      ("gemma3 B=1 S=2048 H=8 KV=4 hd=256 causal", check_flash_bwd,
       dict(B=1, S=2048, H=8, KV=4, hd=256), ("bfloat16",)),
      ("gemma3 B=1 S=2048 H=8 KV=4 hd=256 window=1024", check_flash_bwd,
       dict(B=1, S=2048, H=8, KV=4, hd=256, window=1024), ("bfloat16",)),
      ("gemma3 B=1 S=2047 H=8 KV=4 hd=256 causal softcap=50", check_flash_bwd,
       dict(B=1, S=2047, H=8, KV=4, hd=256, softcap=50.0), ("bfloat16",))]),
]


def kernel_phase(torch):
    """Returns {name: row of the kernels line}: the times of the main path's
    shape in bfloat16, the largest bfloat16 error, and launches None until
    the main path has run; a float32 route with its own source has its own
    row, from the float32 runs (path t's)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}
    failed = []
    for name, replaces, source, cases, *f32_row in KERNELS:
        for dtype in ("bfloat16", "float32"):
            for i, (label, fn, kw, *dtypes) in enumerate(cases):
                if dtypes and dtype not in dtypes[0]:
                    continue
                r = fn(torch, gen, getattr(torch, dtype), **kw)
                err, lib_ms = r["err"], r["lib_ms"]
                bms, by = bound_ms(r["nbytes"], r["flops"], r.get("ops_type", dtype))
                tol = r.get("tol", TOL[dtype])
                ok = r.get("rel_err", err) <= tol
                chain_ok, chain = r.get("chain", (True, ""))
                ok &= chain_ok
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
                    f"TFLOP/s={r['flops'] / r['graph_ms'] / 1e9:.1f} (graph){fp}"
                    + (f"; score chain {chain}" if chain else ""))
                if not ok:
                    failed.append(f"{name} [{label} {dtype}]")
                if dtype == "float32" and f32_row:
                    row_name, row_source = f32_row[0]
                elif dtype == "bfloat16":
                    row_name, row_source = name, source
                else:
                    continue
                if row_name not in rows:   # the first case: the main path's shape
                    rows[row_name] = {"name": row_name, "route": "cuda", "source": row_source,
                                      "replaces": replaces, "launches": None,
                                      "max_abs_err": err, "ms": r["ms"],
                                      "plain_ms": r["plain_ms"], "bound_ms": bms,
                                      "bound_by": by, "library_ms": lib_ms}
                else:
                    rows[row_name]["max_abs_err"] = max(rows[row_name]["max_abs_err"], err)
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


def timed(seconds, name, fn, *a):
    """``fn(*a)``, its wall seconds put in ``seconds[name]``: each phase's
    share of the smoke's time limit."""
    t = time.perf_counter()
    out = fn(*a)
    seconds[name] = round(time.perf_counter() - t, 1)
    return out


def serve_phase(torch, seconds):
    """Serve 16 seeded requests on OLMoE-1B-7B down each path; returns
    ({kernel: launches} with each kernel's count from its own path's run,
    path r's {kernel: launches}, path a's tokens by rid), each path's wall
    seconds in ``seconds``. Raises on any failed check."""
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
    a_tokens = None
    t_ab = time.perf_counter()
    for label, flags, kernels in PATHS:
        engine_kw = {**ENGINE_KW, **flags}
        reqs = path_a_requests(cfg)
        counts, eng = serve_path(torch, cfg, params, label, engine_kw, reqs)
        a_tokens = a_tokens or {r.rid: list(r.output) for r in reqs}
        pool_bytes[label] = eng.kv._total_bytes()
        del eng
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"[{label}] kernels never launched on the path: {missing}")
        launches.update({k: counts[k] for k in kernels})
        if "chunked_prefill_attention" in kernels:
            # bf16 pages at hd 128, page 16: every chunk call on the tensor cores
            sm90 = counts["chunked_prefill_attention_sm90"]
            log(f"serve [{label}]: chunked prefill launches "
                f"{counts['chunked_prefill_attention']}, {sm90} of them on the tensor-core "
                f"route (chunk_attn_sm90.cu)")
            if sm90 != counts["chunked_prefill_attention"]:
                raise AssertionError(f"[{label}] chunked prefill left the tensor-core route")
        check_expert_routes(label, counts)
        if "paged_decode_attention" in kernels:
            log(f"serve [{label}]: paged decode launches {counts['paged_decode_attention']}, "
                f"each the split and merge kernels of decode_sm90.cu (its one route)")
        if "paged_decode_attention_int8" in kernels:
            # int8 pages of 16 keys at hd 128: every decode call on the split
            # route, every chunk call on the int8 tensor cores
            for name, route in (("paged_decode_attention_int8", "split (decode_sm90.cu)"),
                                ("chunked_prefill_attention_int8",
                                 "tensor-core (chunk_int8_sm90.cu)")):
                n = counts[f"{name}_sm90"]
                log(f"serve [{label}]: {name} launches {counts[name]}, {n} of them on the "
                    f"{route} route")
                if n != counts[name]:
                    raise AssertionError(f"[{label}] {name} left its {route} route")
        check_against_plain(torch, cfg, params, label, flags)
        profile_stages(torch, cfg, params, label, engine_kw)
    from repro_torch.serving.kvmanager import kv_token_bytes
    (a, na), (b, nb) = pool_bytes.items()
    want = kv_token_bytes(cfg) / kv_token_bytes(cfg, kv_quant=True)
    log(f"serve: KV pool bytes [{a}] {na / 2**20:.1f} MiB, [{b}] {nb / 2**20:.1f} MiB, "
        f"ratio {na / nb:.3f} ({want:.3f} expected: 2*KV*hd*2 over 2*KV*(hd + 4) bytes "
        f"per token)")
    seconds["a, b"] = round(time.perf_counter() - t_ab, 1)
    r_launches = timed(seconds, "r", sim_phase, torch, cfg, params)
    e_tokens = timed(seconds, "e", shared_phase, torch, cfg, params)
    timed(seconds, "f", dense_phase, torch, cfg, params)
    timed(seconds, "g", overload_phase, torch, cfg, params, e_tokens)
    timed(seconds, "h", async_phase, torch, cfg, params, a_tokens)
    timed(seconds, "i", spec_phase, torch, cfg, params)
    timed(seconds, "j", fleet_phase, torch, cfg, params)
    return launches, r_launches, a_tokens


# path r: the paper's analytic simulator (``repro_torch.sim``) on the
# card's host. r1 serves the short profiled run's four requests on path
# a's engine stage by stage and holds the simulator's modelled H100 (a
# roofline plus a 3 us launch term an operation, with uniform expert counts
# drawn from ``R_SEED``) against the card's device time on the recorded
# stage mixes (on an H100, path a's 16 requests took 20.3-20.8 s of wall
# under the profiler and ~20 s more to collect its events: path r 54-72
# s); r2 runs
# Fig. 11's quick Mixtral grid
# (benchmarks/fig11_throughput.py, its requests cut from the full grid's
# 4 x batch to max(2 x batch, 48)) and Table I's parameter counts
R_LABEL = "simulator: the modelled H100 against path a"
R_POLICIES = ("gpu", "duplex", "duplex_pe")
R_SEED = 0
R_FIG11_CASES = ((256, 256, 32), (1024, 1024, 64))     # (l_in, l_out, batch)
R_FIG11_VARIANTS = (("gpu", "gpu"), ("gpu2x", "gpu"), ("duplex", "duplex"),
                    ("duplex", "duplex_pe"), ("duplex_et", "duplex_pe_et"))
R_REL = 1e-9
# the reference's numbers on the CPU: benchmarks/fig11_throughput.py's
# run(quick=True) tok_per_s and repro.sim.paper_models' param_count()
R_EXPECT = {
    "fig11/256/gpu/gpu": 3556.9654858824947,
    "fig11/256/gpu2x/gpu": 6756.7771729501765,
    "fig11/256/duplex/duplex": 8192.713427695478,
    "fig11/256/duplex/duplex_pe": 8243.140215250878,
    "fig11/256/duplex_et/duplex_pe_et": 9892.825143923588,
    "fig11/1024/gpu/gpu": 6061.958660208891,
    "fig11/1024/gpu2x/gpu": 11239.853821410225,
    "fig11/1024/duplex/duplex": 9580.84130384357,
    "fig11/1024/duplex/duplex_pe": 10327.253833128118,
    "fig11/1024/duplex_et/duplex_pe_et": 11873.108192741862,
    "params/mixtral": 46702792704.0,
    "params/glam": 142000525312.0,
    "params/grok1": 315271944192.0,
    "params/opt": 65820828672.0,
    "params/llama3": 68976648192.0,
}
# path a's kernels on the card by the words in their names: (kernel,
# group, words)
R_KERNELS = (("paged decode", "attention", ("decode_split", "decode_merge")),
             ("chunked prefill", "attention", ("chunk_attn",)),
             ("hot GEMM", "moe", ("hot_sm90",)), ("cold GEMV", "moe", ("cold_sm90",)))


def drive_stages(eng, reqs):
    """Serve ``reqs`` stage by stage through the engine's public
    ``plan_stage`` / ``dispatch_stage`` / ``commit_stage`` (what ``step``
    does); returns each stage's ``StageMix``."""
    for r in reqs:
        eng.submit(r)
    mixes = []
    while eng.scheduler.has_work:
        plan = eng.plan_stage()
        if plan is None:
            raise AssertionError(f"[{R_LABEL}] no stage could be formed with work pending")
        mixes.append(plan.decision.mix())
        eng.commit_stage(eng.dispatch_stage(plan))
    return mixes


def predict_stages(cfg, mixes):
    """{policy: [StageExec]}: each mix through the simulator's
    ``stage_exec`` on one modelled device (an H100 for "gpu", the H100 with
    its Logic-PIM for the Duplex policies), expert counts drawn from one
    generator seeded ``R_SEED`` a policy, threaded through the stages."""
    import numpy as np
    from repro_torch.sim.layermodel import stage_exec
    from repro_torch.sim.specs import duplex_system, gpu_system
    out = {}
    for policy in R_POLICIES:
        system = gpu_system(1, 1) if policy == "gpu" else duplex_system(1, 1)
        rng = np.random.default_rng(R_SEED)
        out[policy] = [stage_exec(system, cfg, m, policy, rng=rng) for m in mixes]
    return out


def sim_paper_numbers():
    """Fig. 11's quick grid (tokens/s of each system and policy) and Table
    I's parameter counts through the port's simulator, keyed as
    ``R_EXPECT``."""
    import copy
    from repro_torch.sim.engine_sim import simulate
    from repro_torch.sim.paper_models import MIXTRAL, PAPER_MODELS
    from repro_torch.sim.specs import default_system
    from repro_torch.sim.workload import gaussian_requests
    out = {}
    for l_in, l_out, batch in R_FIG11_CASES:
        proto = gaussian_requests(max(2 * batch, 48), l_in, min(l_out, 256), seed=11)
        for kind, policy in R_FIG11_VARIANTS:
            res = simulate(default_system(MIXTRAL, kind), MIXTRAL, policy, copy.deepcopy(proto),
                           max_batch=batch)
            out[f"fig11/{l_in}/{kind}/{policy}"] = res.throughput
    out.update({f"params/{n}": float(m.param_count()) for n, m in PAPER_MODELS.items()})
    return out


def check_paper_numbers(got):
    """Each number within ``R_REL`` of the reference's, and the paper's
    directions at 256 tokens: Duplex over the GPU > 1.3, Duplex+PE+ET at
    least 0.95 x Duplex (tests/test_benchmarks.py's conditions)."""
    off = {k: (got.get(k), v) for k, v in R_EXPECT.items()
           if k not in got or abs(got[k] - v) > R_REL * abs(v)}
    gpu = got["fig11/256/gpu/gpu"]
    duplex, et = got["fig11/256/duplex/duplex"] / gpu, got["fig11/256/duplex_et/duplex_pe_et"] / gpu
    log(f"sim [{R_LABEL}]: Fig. 11 quick grid (Mixtral, tokens/s): "
        + ", ".join(f"{k[6:]} {v:.4f}" for k, v in got.items() if k.startswith("fig11/"))
        + f"; at 256 Duplex {duplex:.4f}x the GPU, Duplex+PE+ET {et:.4f}x; Table I parameters: "
        + ", ".join(f"{k[7:]} {v / 1e9:.3f}B" for k, v in got.items() if k.startswith("params/"))
        + f"; {len(R_EXPECT) - len(off)}/{len(R_EXPECT)} within {R_REL:g} of the reference's")
    if off:
        raise AssertionError(f"[{R_LABEL}] the simulator departs from the reference: {off}")
    if not (duplex > 1.3 and et >= 0.95 * duplex):
        raise AssertionError(f"[{R_LABEL}] the paper's directions fail: Duplex {duplex:.4f}x, "
                             f"Duplex+PE+ET {et:.4f}x the GPU")


def sim_phase(torch, cfg, params):
    """Path r. r1: path a's engine serves ``short_requests`` through
    ``run``, then again stage by stage in one CUDA-only profile, every
    launch count set to 0 just before the second and read just after; its
    tokens must equal the first run's, kernels 1-4 launched on their
    routes, every stage's prediction finite and positive. Logs the
    modelled H100's stage times (total, breakdown, medians) beside the
    card's device time (attention kernels, MoE kernels, the rest, and each
    of kernels 1-4) and the host wall, their ratios, and the Duplex
    policies' totals over the GPU's.
    r2: ``sim_paper_numbers`` gated by ``check_paper_numbers``. Returns
    {kernel: launches} of r1."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    kw = {**ENGINE_KW, **PATHS[0][1]}
    want = short_requests(cfg)
    ServingEngine(cfg, params, device="cuda", **kw).run(want)
    reqs = short_requests(cfg)
    eng = ServingEngine(cfg, params, device="cuda", **kw)
    build.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            r.arrival_time = time.monotonic()
        mixes = drive_stages(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    t_prof = time.perf_counter() - t0
    check_path_a_launches(R_LABEL, counts)
    same = sum(r.output == w.output and len(r.output) == w.max_new_tokens
               for r, w in zip(reqs, want))
    if same != len(reqs):
        raise AssertionError(f"[{R_LABEL}] {same}/{len(reqs)} requests emit run's tokens")
    del eng
    # the card: device time by kernel and by group
    by_kernel = dict.fromkeys([k for k, _, _ in R_KERNELS] + ["other"], 0.0)
    for name, (us, _) in device_totals(prof).items():
        kernel = next((k for k, _, words in R_KERNELS if any(w in name for w in words)),
                      "other")
        by_kernel[kernel] += us / 1e3
    dev = {"attention": 0.0, "moe": 0.0, "other": by_kernel["other"]}
    for kernel, group, _ in R_KERNELS:
        dev[group] += by_kernel[kernel]
    busy = sum(dev.values())
    # the model
    t1 = time.perf_counter()
    pred = predict_stages(cfg, mixes)
    t_pred = time.perf_counter() - t1
    bad = [(p, i) for p, xs in pred.items() for i, ex in enumerate(xs)
           if not (math.isfinite(ex.time) and ex.time > 0 and math.isfinite(ex.energy))]
    if bad:
        raise AssertionError(f"[{R_LABEL}] predictions not finite and positive: {bad[:8]}")
    gpu = pred["gpu"]
    median = lambda xs: float(np.median(xs)) if xs else float("nan")
    dec = [ex.time * 1e3 for ex, m in zip(gpu, mixes) if not m.is_mixed]
    mix = [ex.time * 1e3 for ex, m in zip(gpu, mixes) if m.is_mixed]
    parts = {k: sum(ex.breakdown.get(k, 0.0) for ex in gpu) * 1e3
             for k in ("fc", "attn", "moe", "lm_head")}
    total = {p: sum(ex.time for ex in xs) * 1e3 for p, xs in pred.items()}
    log(f"sim [{R_LABEL}]: {len(mixes)} stages, decode-only {len(dec)}, mixed {len(mix)}; "
        f"{same}/{len(reqs)} requests emit run's tokens; modelled H100 (\"gpu\", one "
        f"device) {total['gpu']:.3f} ms in all: "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; median stage {median(dec):.4f} ms decode-only, {median(mix):.4f} ms mixed "
        f"(predicted in {t_pred * 1e3:.0f} ms of host)")
    log(f"sim [{R_LABEL}]: the card: device busy {busy:.3f} ms (attention kernels "
        f"{dev['attention']:.3f}, MoE kernels {dev['moe']:.3f}, the rest {dev['other']:.3f}; "
        + ", ".join(f"{k} {by_kernel[k]:.3f}" for k, _, _ in R_KERNELS)
        + f") over {wall * 1e3:.1f} ms of host wall ({100 * busy / (wall * 1e3):.1f}% busy; "
        f"{t_prof:.1f} s with the profile's collection)")
    log(f"sim [{R_LABEL}]: measured over modelled: device total {busy / total['gpu']:.4f}, "
        f"attention {dev['attention'] / parts['attn']:.4f}, MoE {dev['moe'] / parts['moe']:.4f}, "
        f"the rest over fc + lm_head {dev['other'] / (parts['fc'] + parts['lm_head']):.4f}; "
        f"host wall over modelled {wall * 1e3 / total['gpu']:.4f}; modelled Duplex over the "
        f"GPU on the port's traffic: duplex {total['duplex'] / total['gpu']:.4f}, duplex_pe "
        f"{total['duplex_pe'] / total['gpu']:.4f} ({total['duplex']:.3f}, "
        f"{total['duplex_pe']:.3f} ms)")
    check_paper_numbers(sim_paper_numbers())
    log(f"sim [{R_LABEL}]: path r in {time.perf_counter() - t_phase:.1f} s")
    return {k: counts[k] for k in PATHS[0][2]}


# path e: one 256-token system prompt shared by 16 requests, each with a
# seeded private suffix of 64-256 tokens and 32 new tokens, on a pool of a
# quarter of the pages they would need over their lifetimes without
# sharing: shared, they need less than half of that figure over their
# lifetimes, so a pool of half would evict no one
SHARED_LABEL = "shared prompt + oversubscribed pool"
SHARED_KW = dict(max_slots=16, max_len=1024, kv_page_size=16, prefill_chunk_tokens=64,
                 prefix_share=True, preemption="recompute")
SHARED_PROMPT = 256
SHARED_KERNELS = ("paged_decode_attention", "chunked_prefill_attention",
                  "ragged_moe_gemm", "ragged_moe_gemv")
# path f: the dense layout with migrate preemption, path a's 16 requests
DENSE_LABEL = "dense KV + migrate"
DENSE_KW = dict(max_slots=8, max_len=1024, prefill_chunk_tokens=64, kv_layout="dense",
                preemption="migrate")
DENSE_KERNELS = ("decode_attention", "ragged_moe_gemm", "ragged_moe_gemv")


def shared_requests(cfg):
    import numpy as np
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, SHARED_PROMPT).tolist()
    return [Request(rid=i, prompt=system + rng.integers(
        0, cfg.vocab_size, int(rng.integers(64, 257))).tolist(), max_new_tokens=32)
        for i in range(16)]


def shared_engine_kw(reqs):
    """Path e's engine flags: SHARED_KW and a pool (+ the null page) of a
    quarter of the pages ``reqs`` need over their lifetimes unshared."""
    page = SHARED_KW["kv_page_size"]
    demand = sum(-(-(len(r.prompt) + r.max_new_tokens) // page) for r in reqs)
    return dict(SHARED_KW, kv_num_pages=demand // 4 + 1)


def shared_phase(torch, cfg, params):
    """Path e; raises if a check fails. Returns each request's tokens."""
    reqs = shared_requests(cfg)
    page = SHARED_KW["kv_page_size"]
    demand = sum(-(-(len(r.prompt) + r.max_new_tokens) // page) for r in reqs)
    shared = SHARED_PROMPT // page + sum(
        -(-(len(r.prompt) - SHARED_PROMPT + r.max_new_tokens) // page) for r in reqs)
    engine_kw = shared_engine_kw(reqs)
    log(f"serve [{SHARED_LABEL}]: {len(reqs)} requests of a {SHARED_PROMPT}-token system "
        f"prompt and a 64-256-token suffix need {demand} pages of {page} over their "
        f"lifetimes without sharing, {shared} with the prompt's pages shared; the pool "
        f"holds {engine_kw['kv_num_pages'] - 1} (+ the null page)")
    counts, eng = serve_path(torch, cfg, params, SHARED_LABEL, engine_kw, reqs)
    missing = [k for k in SHARED_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"[{SHARED_LABEL}] kernels never launched on the path: {missing}")
    sm90 = counts["chunked_prefill_attention_sm90"]
    log(f"serve [{SHARED_LABEL}]: paged decode launches {counts['paged_decode_attention']}, "
        f"each the split and merge kernels of decode_sm90.cu (its one route); chunked "
        f"prefill launches {counts['chunked_prefill_attention']}, {sm90} of them on the "
        f"tensor-core route (chunk_attn_sm90.cu)")
    if sm90 != counts["chunked_prefill_attention"]:
        raise AssertionError(f"[{SHARED_LABEL}] chunked prefill left the tensor-core route")
    check_expert_routes(SHARED_LABEL, counts)
    audit = eng.kv.audit(pins={})
    peak_shared = max(r.shared_kv_pages for r in eng.reports)
    log(f"serve [{SHARED_LABEL}]: preemptions {eng.preemptions}, shared prompt positions "
        f"skipped {eng.shared_tokens_skipped}, copy-on-write copies {eng.kv.cow_copies}, "
        f"dedupe merges {eng.kv.dedup_merges}, peak shared pages {peak_shared}, peak "
        f"concurrent requests {eng.peak_active}; after the run {eng.kv.live_pages} live "
        f"pages, {eng.kv.free_pages} of {eng.kv.num_pages - 1} free, audit {audit}")
    if eng.preemptions == 0 or eng.shared_tokens_skipped == 0:
        raise AssertionError(f"[{SHARED_LABEL}] no preemption or no shared prefix")
    if audit or eng.kv.live_pages or eng.kv.free_pages != eng.kv.num_pages - 1:
        raise AssertionError(f"[{SHARED_LABEL}] the pool did not drain cleanly")
    del eng
    check_shared_against_plain(torch, cfg, params)
    return {r.rid: list(r.output) for r in reqs}


def check_shared_against_plain(torch, cfg, params):
    """One mixed stage after a shared prefix: request 0's 256-token system
    prompt is prefilled (4 chunks of 64) and indexed; a second request
    pins and adopts its pages and runs its first private chunk (64 tokens
    at 256), beside request 0's decode row whose table maps the same pages.
    The stage runs through the kernels and through the plain path, each on
    its own copy of the pool; logits to ``compare_logits``."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models.model import mixed_step
    from repro_torch.models.params import tree_map
    from repro_torch.serving.kvmanager import KVManager
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    V, page = cfg.vocab_size, 16
    system = torch.randint(0, V, (1, SHARED_PROMPT), generator=gen, device="cuda")
    suffix = torch.randint(0, V, (1, 64), generator=gen, device="cuda")
    dec = torch.randint(0, V, (1, 1), generator=gen, device="cuda")
    kv = KVManager(cfg, 2, 1024, page_size=page, num_pages=48, device="cuda")
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
    plan = lambda k: ExecutionPlan(moe_impl="duplex", k_cold=32, c_hot=64, c_cold=16,
                                   moe_ragged=k, use_kernels=k)
    a = kv.allocate()
    kv.ensure_len(a, SHARED_PROMPT)
    maxp = 32
    with torch.no_grad():
        for start in range(0, SHARED_PROMPT, 64):
            mixed_step(params, cfg, dec, system[:, start:start + 64], kv.cache,
                       attn_ctx={"lengths": i32([0]), "block_tables": i32([[0] * maxp]),
                                 "valid": i32([0]) > 0},
                       chunk_ctx={"starts": i32([start]), "chunk_lens": i32([64]),
                                  "block_tables": torch.from_numpy(
                                      kv.block_tables[a:a + 1, :maxp]).cuda()},
                       plan=plan(True))
    kv.lens[a] = SHARED_PROMPT
    kv.register_prefix(a, system[0].tolist())
    b = kv.allocate()
    covered = kv.adopt_prefix(b, kv.pin_prefix(system[0].tolist() + suffix[0].tolist()))
    if covered != SHARED_PROMPT:
        raise AssertionError(f"[{SHARED_LABEL}] adopted {covered} positions, want "
                             f"{SHARED_PROMPT}")
    kv.ensure_len(b, SHARED_PROMPT + 64)
    kv.ensure_len(a, SHARED_PROMPT + 1)      # the decode row's write opens a page
    bt = lambda s: torch.from_numpy(kv.block_tables[s:s + 1, :maxp]).cuda()
    shared = sum(kv.page_ref(p) > 1 for p in kv.block_tables[b, :SHARED_PROMPT // page])
    out = {}
    for use_kernels in (True, False):
        cache = tree_map(kv.cache, lambda t: t.clone())
        with torch.no_grad():
            dl, cl, _, _ = mixed_step(
                params, cfg, dec, suffix, cache,
                attn_ctx={"lengths": i32([SHARED_PROMPT]), "block_tables": bt(a),
                          "valid": i32([1]) > 0},
                chunk_ctx={"starts": i32([SHARED_PROMPT]), "chunk_lens": i32([64]),
                           "block_tables": bt(b)}, plan=plan(use_kernels))
        out[use_kernels] = torch.cat([dl[:, 0], cl[:, 0]]).float()
        del cache
    compare_logits(torch, SHARED_LABEL, f"one mixed stage, a chunk after an adopted "
                   f"{SHARED_PROMPT}-token prefix ({shared} pages in both tables) and a "
                   f"decode row over the same pages", out[True], out[False])


def dense_phase(torch, cfg, params):
    """Path f; raises if a check fails."""
    counts, eng = serve_path(torch, cfg, params, DENSE_LABEL, DENSE_KW)
    missing = [k for k in DENSE_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"[{DENSE_LABEL}] kernels never launched on the path: {missing}")
    check_expert_routes(DENSE_LABEL, counts)
    kv_b = eng.kv._total_bytes()
    slot_b = eng.kv.bytes_per_slot()
    log(f"serve [{DENSE_LABEL}]: dense decode launches {counts['decode_attention']}, each "
        f"the split and merge kernels of decode_sm90.cu (its one route); preemptions "
        f"{eng.preemptions}, each a {slot_b / 2**20:.1f} MiB slot row (k/v/pos/len of "
        f"{cfg.num_layers} layers x {DENSE_KW['max_len']} positions) to the host and back: "
        f"{eng.preemptions * slot_b / 2**20:.1f} MiB migrated; dense KV cache "
        f"{kv_b / 2**20:.1f} MiB ({DENSE_KW['max_slots']} slots); streamed KV bytes per "
        f"decode stage {eng._dense_kv_bytes_per_stage / 2**20:.1f} MiB; peak concurrent "
        f"requests {eng.peak_active}")
    if eng.preemptions == 0:
        raise AssertionError(f"[{DENSE_LABEL}] no request was preempted")
    del eng
    check_dense_against_plain(torch, cfg, params)
    profile_stages(torch, cfg, params, DENSE_LABEL, DENSE_KW)


def check_dense_against_plain(torch, cfg, params):
    """One dense mixed stage over 8 slots of 1024: slots 0-5 hold prefills
    of 64-384 tokens (written by chunks through the kernels) and decode,
    slot 6 takes its second chunk (64 tokens at 64) and slot 7 its first,
    through the kernels and through the plain path, each on its own copy of
    the cache; the live rows' logits to ``compare_logits``."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models.model import init_cache, mixed_step
    from repro_torch.models.params import tree_map
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    V, S = cfg.vocab_size, 8
    lens = (64, 128, 192, 256, 320, 384, 64, 0)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
    plan = lambda k: ExecutionPlan(moe_impl="duplex", k_cold=32, c_hot=64, c_cold=16,
                                   moe_ragged=k, use_kernels=k)
    cache = init_cache(cfg, S, 1024, device="cuda")
    toks = torch.randint(0, V, (S, 384), generator=gen, device="cuda")
    none = i32([0] * S) > 0
    with torch.no_grad():                    # write each slot's prefix, 64 at a time
        for start in range(0, 384, 64):
            rows = [s for s in range(S) if lens[s] > start]
            mixed_step(params, cfg, toks[:, :1], toks[rows, start:start + 64], cache,
                       attn_ctx={"valid": none},
                       chunk_ctx={"slots": i32(rows), "starts": i32([start] * len(rows)),
                                  "chunk_lens": i32([64] * len(rows))}, plan=plan(True))
    dec = torch.randint(0, V, (S, 1), generator=gen, device="cuda")
    chunk = torch.randint(0, V, (2, 64), generator=gen, device="cuda")
    valid = i32([1] * 6 + [0, 0]) > 0
    out = {}
    for use_kernels in (True, False):
        own = tree_map(cache, lambda t: t.clone())
        with torch.no_grad():
            dl, cl, _, _ = mixed_step(
                params, cfg, dec, chunk, own, attn_ctx={"valid": valid},
                chunk_ctx={"slots": i32([6, 7]), "starts": i32([64, 0]),
                           "chunk_lens": i32([64, 64])}, plan=plan(use_kernels))
        out[use_kernels] = torch.cat([dl[:6, 0], cl[:, 0]]).float()
        del own
    compare_logits(torch, DENSE_LABEL, "one dense mixed stage (6 decode rows of 64-384, "
                   "two chunk rows)", out[True], out[False])


# path g: overload and faults on OLMoE-1B-7B, in two runs. The host schedule
# (stages, aborts, evictions, sheds, expiries, the fault draws) depends on
# the lengths, the clock and the order of the fault consultations, not on
# the model's widths or numbers (no EOS; k_cold feeds no decision; page
# counts come from lengths), so each counter is gated against what the
# port's engine forms on the CPU with a narrow config
# (tests/test_torch_overload.py::test_path_g_counters_match_the_smoke_gates
# runs these same functions there and holds these constants).
CHAOS_LABEL = "chaos: shared prompt, faults injected"
CHAOS_SEED = 0
CHAOS_FAULTS = dict(p_page_alloc_fail=0.01, p_forced_evict=0.05, p_step_error=0.05,
                    p_latency_spike=0.05, max_retries=4)
OVERLOAD_LABEL = "overload: bounded queue, deadlines, cancels"
OVERLOAD_KW = dict(ENGINE_KW, queue_cap=8, overload_policy="shed-oldest", aging_rounds=4)
STAGE_S = 0.1                  # g2's virtual seconds a stage
ARRIVE_EVERY, ARRIVE_N = 5, 4  # g2: 4 arrivals every 5 stages
DEADLINE_S = 4.05              # every 8th request from rid 1: finish deadline after arrival
TTFT_SLO_S = 2.25              # every 8th request from rid 5: first-token objective
CANCEL_QUEUED_AT, CANCEL_PREFILL_AT = 12, 23   # g2 stages of its two cancels
G1_EXPECT = dict(stages=92, stage_aborts=3, retries=2, preemptions=10, forced_evictions=2,
                 fault_counts=dict(page_alloc_fail=3, forced_evict=3, step_error=2,
                                   latency_spike=5, replica_kill=0, replica_spike=0))
G2_EXPECT = dict(stages=100, shed=16, expired=2, cancelled=2, rejected=0,
                 aging_promotions=81, expired_deadline=1, expired_ttft=1, completed=12)


ASYNC_LABEL = "async loop: path a's engine"
ASYNC_KW = dict(ENGINE_KW, **PATHS[0][1])
H_PAIRS = 2                    # sync/async pairs, in the order S A, A S
# the async runs' schedule as the port's engine forms it on the CPU
# (tests/test_torch_async.py): every stage after the first planned from the
# projection and chained; the sync runs form the same stages, none chained
H_EXPECT = dict(stages=110, chained_stages=109, spec_hits=109, spec_misses=0,
                spec_miss_reasons={}, gap_stages=109, mixed=79)


def async_counters(eng):
    """Path h's gated counters: the schedule the async loop forms."""
    st = eng.stats()
    return dict({k: st[k] for k in ("stages", "chained_stages", "spec_hits", "spec_misses",
                                    "spec_miss_reasons", "gap_stages")},
                mixed=sum(r.is_mixed for r in eng.reports))


def chaos_injector():
    from repro_torch.serving.faults import FaultInjector
    return FaultInjector(CHAOS_SEED, **CHAOS_FAULTS)


def chaos_counters(eng):
    """g1's gated counters."""
    st = eng.stats()
    return dict({k: st[k] for k in ("stages", "stage_aborts", "retries", "preemptions",
                                    "forced_evictions")}, fault_counts=st["fault_counts"])


def overload_requests(cfg):
    """g2's 32 requests: path a's 16 prompt lengths twice (tokens seeded anew),
    32 new tokens each, arriving 4 every 5 stages (arrival times on the
    virtual clock); every fourth has priority 1, every eighth from rid 1 a
    finish deadline and every eighth from rid 5 a first-token SLO."""
    import numpy as np
    from repro_torch.serving.request import Request
    lens = [len(r.prompt) for r in path_a_requests(cfg)] * 2
    rng = np.random.default_rng(1)
    reqs = []
    for i, n in enumerate(lens):
        t = ARRIVE_EVERY * (i // ARRIVE_N) * STAGE_S
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=32,
            arrival_time=t, priority=1 if i % 4 == 3 else 0,
            deadline=t + DEADLINE_S if i % 8 == 1 else None,
            ttft_slo=TTFT_SLO_S if i % 8 == 5 else None))
    return reqs


def drive_overload(eng, reqs):
    """Submit and step g2 on the virtual clock (stage k at k * STAGE_S),
    cancelling at stage CANCEL_QUEUED_AT the queue's last request and at
    CANCEL_PREFILL_AT the first request in the middle of its chunked
    prefill. Returns the cancelled rids; raises if either has no such
    request or the run does not drain."""
    cancelled = []
    i = k = 0
    while i < len(reqs) or eng.scheduler.has_work:
        if k > 5000:
            raise AssertionError(f"[{OVERLOAD_LABEL}] did not drain in 5000 stages")
        now = k * STAGE_S
        while i < len(reqs) and ARRIVE_EVERY * (i // ARRIVE_N) <= k:
            eng.submit(reqs[i], now=now)     # shed-oldest sheds, never rejects
            i += 1
        if k == CANCEL_QUEUED_AT:
            q = [r for r in eng.scheduler.queue if not r.done]
            if not q:
                raise AssertionError(f"[{OVERLOAD_LABEL}] no queued request to cancel")
            cancelled.append(q[-1].rid)
        elif k == CANCEL_PREFILL_AT:
            p = [r for r in eng.scheduler.prefilling
                 if 0 < r.prefill_pos < r.prefill_total]
            if not p:
                raise AssertionError(f"[{OVERLOAD_LABEL}] no request mid-prefill to cancel")
            cancelled.append(p[0].rid)
        if k in (CANCEL_QUEUED_AT, CANCEL_PREFILL_AT) and not eng.cancel(cancelled[-1],
                                                                         now=now):
            raise AssertionError(f"[{OVERLOAD_LABEL}] cancel of {cancelled[-1]} refused")
        eng.step(now=now)
        k += 1
    return cancelled


def overload_counters(eng, reqs):
    """g2's gated counters."""
    st = eng.stats()
    exp = [r for r in reqs if r.finish_reason == "expired"]
    return dict({k: st[k] for k in ("stages", "shed", "expired", "cancelled", "rejected",
                                    "aging_promotions")},
                expired_deadline=sum(r.deadline is not None for r in exp),
                expired_ttft=sum(r.ttft_slo is not None for r in exp),
                completed=sum(r.completed for r in reqs))


def check_overload_gates(label, got, want):
    if got != want:
        raise AssertionError(f"[{label}] counters {got} differ from the CPU schedule's "
                             f"{want}")


def drained(eng):
    """The pool drained: no live page, an empty audit with no pins, every
    slot free."""
    return (eng.kv.live_pages == 0 and eng.kv.audit(pins={}) == []
            and eng.kv.free_slots == eng.kv.max_slots)


def overload_phase(torch, cfg, params, e_tokens):
    """Path g: g1, path e's requests and engine under the seeded fault
    injector on the wall clock; g2, path a's engine with a bounded queue,
    shedding and aging under 32 arrivals with deadlines, first-token SLOs
    and two cancels on a virtual clock. Each with every launch count set to
    0 before and read after; raises if a gate fails."""
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine

    def launched(label, counts):
        missing = [k for k in SHARED_KERNELS if counts[k] == 0]
        if missing:
            raise AssertionError(f"[{label}] kernels never launched on the path: {missing}")
        sm90 = counts["chunked_prefill_attention_sm90"]
        log(f"serve [{label}]: kernel launches {json.dumps(counts)}")
        if sm90 != counts["chunked_prefill_attention"]:
            raise AssertionError(f"[{label}] chunked prefill left the tensor-core route")
        check_expert_routes(label, counts)

    def stage_line(label, eng, reqs, wall):
        reps = eng.reports
        gen = sum(len(r.output) for r in reqs)
        log(f"serve [{label}]: stages={len(reps)} (with prefill {sum(r.is_mixed for r in reps)}"
            f", aborted {sum(r.aborted for r in reps)}) in {wall:.2f}s of host wall; "
            f"{gen} tokens generated, {gen / wall:.1f}/s; counters "
            f"{json.dumps({k: v for k, v in eng.stats().items() if k not in ('kv', 'delta')})}")

    # g1: chaos
    reqs = shared_requests(cfg)
    inj = chaos_injector()
    eng = ServingEngine(cfg, params, device="cuda", injector=inj, audit_stages=True,
                        **shared_engine_kw(reqs))
    build.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        r.arrival_time = eng._now()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    stage_line(CHAOS_LABEL, eng, reqs, wall)
    tbt = [t for r in reqs for t in r.tbts()]
    same = [r.rid for r in reqs if r.output == e_tokens[r.rid]]
    depart = {r.rid: next(i for i, (a, b) in enumerate(zip(r.output, e_tokens[r.rid]))
                          if a != b) for r in reqs if r.rid not in same}
    log(f"serve [{CHAOS_LABEL}]: fault counts {json.dumps(inj.counts)} (seed {CHAOS_SEED}); "
        f"median TBT={np.median(tbt) * 1e3:.1f}ms, median TTFT="
        f"{np.median([r.t2ft() for r in reqs]) * 1e3:.0f}ms (the engine clock: injected "
        f"spikes included); {len(same)}/16 requests emitted path e's fault-free tokens "
        f"exactly, the others first depart at {depart} (rid: position; an aborted or "
        f"replayed stage re-forms the stages after it, and a stage's token count sets "
        f"its MoE capacities and k_cold, so which tokens overflow an expert)")
    launched(CHAOS_LABEL, counts)
    st = eng.stats()
    if not all(r.completed for r in reqs):
        raise AssertionError(f"[{CHAOS_LABEL}] not every request completed")
    if st["audit_violations"] or not drained(eng):
        raise AssertionError(f"[{CHAOS_LABEL}] audit {eng.audit_log[:5]}; the pool did not "
                             f"drain cleanly")
    if not st["stage_aborts"] or not st["retries"]:
        raise AssertionError(f"[{CHAOS_LABEL}] no aborted stage or no retry")
    check_overload_gates(CHAOS_LABEL, chaos_counters(eng), G1_EXPECT)
    del eng

    # g2: overload on a virtual clock
    reqs = overload_requests(cfg)
    eng = ServingEngine(cfg, params, device="cuda", audit_stages=True, **OVERLOAD_KW)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    cancelled = drive_overload(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    stage_line(OVERLOAD_LABEL, eng, reqs, wall)
    reasons = {}
    for r in reqs:
        reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
    log(f"serve [{OVERLOAD_LABEL}]: finish reasons {json.dumps(reasons)}; cancelled rids "
        f"{cancelled} (queued, mid-prefill); median stage wall "
        f"{np.median([r.wall_time for r in eng.reports]) * 1e3:.1f}ms (token times are "
        f"virtual)")
    launched(OVERLOAD_LABEL, counts)
    if not all(r.done and r.finish_reason in ("length", "shed", "expired", "cancelled")
               for r in reqs):
        raise AssertionError(f"[{OVERLOAD_LABEL}] a request ended otherwise: {reasons}")
    if eng.stats()["audit_violations"] or not drained(eng):
        raise AssertionError(f"[{OVERLOAD_LABEL}] audit {eng.audit_log[:5]}; the pool did "
                             f"not drain cleanly")
    check_overload_gates(OVERLOAD_LABEL, overload_counters(eng, reqs), G2_EXPECT)
    del eng


class HostSplit:
    """The host seconds a run spends in each part of its stages, by wrapping
    the engine's methods (the outermost call counts): plan (maintenance,
    planning, chaining, validation), enqueue (``dispatch_stage``, run under
    torch's sync debug mode "error", so an implicit device sync on the
    enqueue path fails the run), wait (``_materialize``), commit
    (``_commit_critical``) and deferred (``_commit_deferred``)."""
    PARTS = {"plan": ("_stage_maintenance", "plan_stage", "_plan_speculative", "_build_chain",
                      "_validate_speculative"),
             "enqueue": ("dispatch_stage",), "wait": ("_materialize",),
             "commit": ("_commit_critical",), "deferred": ("_commit_deferred",)}

    def __init__(self, torch, eng):
        self.seconds = dict.fromkeys(self.PARTS, 0.0)
        self.depth = 0
        for part, names in self.PARTS.items():
            for name in names:
                setattr(eng, name, self._timed(torch, part, getattr(eng, name)))

    def _timed(self, torch, part, fn):
        def timed(*args, **kw):
            outer = self.depth == 0
            self.depth += 1
            t0 = time.perf_counter()
            if part == "enqueue":
                torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                if part == "enqueue":
                    torch.cuda.set_sync_debug_mode("default")
                self.depth -= 1
                if outer:
                    self.seconds[part] += time.perf_counter() - t0
        return timed


def async_run(torch, cfg, params, loop):
    """One of path h's runs: path a's engine and requests through ``run``
    ("sync") or ``run_async`` ("async"), every launch count set to 0 just
    before and read just after, the host split recorded. Raises if a gate
    fails; returns (requests, the engine, wall seconds, the host split)."""
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    reqs = path_a_requests(cfg)
    eng = ServingEngine(cfg, params, device="cuda", **ASYNC_KW)
    split = HostSplit(torch, eng)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        r.arrival_time = time.monotonic()
    (eng.run_async if loop == "async" else eng.run)(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    label = f"{ASYNC_LABEL}, {loop}"
    check_path_a_launches(label, counts)
    if not all(r.completed and len(r.output) == 32 for r in reqs) or not drained(eng):
        raise AssertionError(f"[{label}] not every request completed with 32 tokens, or the "
                             f"pool did not drain cleanly")
    want = H_EXPECT if loop == "async" else dict(H_EXPECT, chained_stages=0, spec_hits=0)
    check_overload_gates(label, async_counters(eng), want)
    return reqs, eng, wall, split.seconds


def check_path_a_launches(label, counts):
    """A run on path a's engine launched kernels 1-4, every chunk call on
    the tensor-core route, every hot GEMM and cold GEMV on theirs."""
    log(f"serve [{label}]: kernel launches "
        f"{json.dumps({k: counts[k] for k in PATHS[0][2]})}")
    missing = [k for k in PATHS[0][2] if counts[k] == 0]
    if missing:
        raise AssertionError(f"[{label}] kernels never launched on the path: {missing}")
    if counts["chunked_prefill_attention_sm90"] != counts["chunked_prefill_attention"]:
        raise AssertionError(f"[{label}] chunked prefill left the tensor-core route")
    check_expert_routes(label, counts)


def top2_gap(torch, cfg, params, tokens):
    """The top-2 logit gap of the next token after ``tokens``, from a
    one-sequence prefill (grouped MoE, the kernels)."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models.model import init_cache, prefill
    cache = init_cache(cfg, 1, ENGINE_KW["max_len"], device="cuda")
    toks = torch.tensor([tokens], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits, _ = prefill(params, cfg, {"tokens": toks}, cache,
                            torch.tensor([len(tokens)], dtype=torch.int32, device="cuda"),
                            plan=ExecutionPlan(moe_impl="grouped", use_kernels=True))
    top = logits[0, -1].float().topk(2).values
    return float(top[0] - top[1])


def async_phase(torch, cfg, params, a_tokens):
    """Path h: path a's engine and requests through the sync loop and the
    async loop, two pairs in the order S A, A S within this call (a
    run's place in a call moves host clocks by seconds). Each run: wall and
    generated tokens/s over its wall (under async the stage walls overlap),
    median TBT and TTFT, the schedule counters (gated to ``H_EXPECT``), the
    host gap, the mean host seconds a stage in each part (``HostSplit``),
    and how many requests emit path a's tokens, each other one with its
    first departing position and the top-2 logit gap there. Then one short
    profiled run in each loop for the device's busy share."""
    import numpy as np
    gaps = {}
    walls = {"sync": [], "async": []}
    for pair in range(H_PAIRS):
        for loop in (("sync", "async") if pair % 2 == 0 else ("async", "sync")):
            reqs, eng, wall, split = async_run(torch, cfg, params, loop)
            st = eng.stats()
            n = len(eng.reports)
            gen = sum(len(r.output) for r in reqs)
            tbt = [t for r in reqs for t in r.tbts()]
            same = [r.rid for r in reqs if r.output == a_tokens[r.rid]]
            depart = {}
            for r in reqs:
                if r.rid in same:
                    continue
                i = next(i for i, (x, y) in enumerate(zip(r.output, a_tokens[r.rid])) if x != y)
                key = (r.rid, i)
                if key not in gaps:
                    gaps[key] = top2_gap(torch, cfg, params, r.prompt + r.output[:i])
                depart[r.rid] = f"{i} (gap {gaps[key]:.4f})"
            walls[loop].append(wall)
            log(f"serve [{ASYNC_LABEL}, {loop}, pair {pair + 1}]: 16/16 completed in "
                f"{wall:.3f}s; generated tokens/s={gen / wall:.1f} (over the run's wall); "
                f"median TBT={np.median(tbt) * 1e3:.1f}ms, median TTFT="
                f"{np.median([r.t2ft() for r in reqs]) * 1e3:.0f}ms; stages={n} (with prefill "
                f"{sum(r.is_mixed for r in eng.reports)}), chained {st['chained_stages']}, "
                f"spec hits {st['spec_hits']}, misses {st['spec_misses']} "
                f"{json.dumps(st['spec_miss_reasons'])}; host gap {st['host_gap_s'] * 1e3:.1f}ms "
                f"over {st['gap_stages']} stages; host ms a stage: "
                + ", ".join(f"{k} {v / n * 1e3:.2f}" for k, v in split.items())
                + f"; {len(same)}/16 requests emit path a's tokens"
                + (f", the others depart at {depart} (rid: position, the top-2 logit gap "
                   f"there from a one-sequence prefill)" if depart else ""))
            del eng
    s, a = (np.mean(walls[k]) for k in ("sync", "async"))
    log(f"serve [{ASYNC_LABEL}]: mean wall sync {s:.3f}s, async {a:.3f}s (async/sync "
        f"{a / s:.3f}); per pair " + ", ".join(
            f"{x / y:.3f}" for x, y in zip(walls["async"], walls["sync"])))
    for loop in ("sync", "async"):
        profile_stages(torch, cfg, params, f"{ASYNC_LABEL}, {loop}", ASYNC_KW,
                       loop="run_async" if loop == "async" else "run")


# path i: speculative decoding on path a's engine. rids 0-7 are path a's
# first 8 prompts; rids 8-15 repeat a seeded 8-token pattern to a seeded
# 128-512 tokens, traffic whose output repeats its context (code edits,
# templated or summarising prompts)
SPEC_LABEL = "speculative decoding: path a's engine"
SPEC_KW = dict(ASYNC_KW, spec_k=4, spec_ngram=3, audit_stages=True)
SPEC_RUNS = ((0, "sync"), (4, "sync"), (4, "async"))   # (spec_k, loop); run 1 the baseline
# the top-2 logit gap (from a one-sequence prefill) up to which a departure
# from run 1's tokens counts as a bf16 near-tie; one above it fails the run
# (PERF.md, path i's predictions)
SPEC_GAP_BAND = 1.0


def spec_requests(cfg):
    """Path i's 16 requests, 32 new tokens each."""
    import numpy as np
    from repro_torch.serving.request import Request
    reqs = path_a_requests(cfg)[:8]
    rng = np.random.default_rng(26)
    for rid in range(8, 16):
        pattern = rng.integers(0, cfg.vocab_size, 8).tolist()
        n = int(rng.integers(128, 513))
        reqs.append(Request(rid=rid, prompt=(pattern * (n // 8 + 1))[:n], max_new_tokens=32))
    return reqs


def spec_gates(eng, reqs, loop, streamed):
    """Path i's gates on one run's host state (the launches aside): every
    request completed with exactly 32 tokens, the pool drained with an
    empty audit after every stage, the ``on_token`` stream equal to the
    outputs, and with speculation drafts proposed and, in the async loop,
    plans missed for a verify span or fresh drafts. Returns the failures."""
    st = eng.stats()
    fails = []
    if not all(r.completed and len(r.output) == 32 for r in reqs):
        fails.append("not every request completed with exactly 32 tokens")
    if not drained(eng) or st["audit_violations"]:
        fails.append(f"the pool did not drain cleanly (audit {eng.audit_log[:3]})")
    if streamed != {r.rid: r.output for r in reqs}:
        fails.append("the on_token stream differs from the outputs")
    if eng.spec_k and st["spec_proposed"] == 0:
        fails.append("no draft was proposed")
    misses = st["spec_miss_reasons"]
    if eng.spec_k and loop == "async" and misses.get("draft", 0) + misses.get("rewind", 0) == 0:
        fails.append(f"no plan missed for drafts or rewinds ({misses})")
    return fails


def spec_run(torch, cfg, params, spec_k, loop, capture=None):
    """One of path i's runs: its engine with ``spec_k`` through ``run``
    ("sync") or ``run_async`` ("async"), every launch count set to 0 just
    before and read just after, every ``dispatch_stage`` under torch's sync
    debug mode "error" (``HostSplit``), the ``on_token`` stream and each
    stage's chunk buckets recorded; with ``capture`` (a dict) the first
    stage with a verify span and a prefill chunk, else the first with a
    verify span, is kept for ``check_spec_against_plain``. Raises if a gate
    fails; returns (requests, engine, wall seconds, host split, [(chunk
    rows, chunk length) a stage])."""
    from repro_torch.kernels import build
    from repro_torch.serving import engine as engine_mod
    reqs = spec_requests(cfg)
    streamed = {}
    eng = engine_mod.ServingEngine(
        cfg, params, device="cuda", **dict(SPEC_KW, spec_k=spec_k),
        on_token=lambda rid, tok: streamed.setdefault(rid, []).append(tok))
    split = HostSplit(torch, eng)
    buckets = []
    chunk_inputs = eng._chunk_inputs
    eng._chunk_inputs = lambda d: buckets.append(chunk_inputs(d)) or buckets[-1]
    label = f"{SPEC_LABEL}, spec_k={spec_k} {loop}"
    build.reset_launch_counts()
    with spec_capture(torch, eng, engine_mod, capture):
        t0 = time.perf_counter()
        for r in reqs:
            r.arrival_time = time.monotonic()
        (eng.run_async if loop == "async" else eng.run)(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    check_path_a_launches(label, counts)
    fails = spec_gates(eng, reqs, loop, streamed)
    if fails:
        raise AssertionError(f"[{label}] {'; '.join(fails)}")
    return reqs, eng, wall, split.seconds, buckets


@contextlib.contextmanager
def spec_capture(torch, eng, engine_mod, capture):
    """With ``capture`` a dict, the engine's mixed steps pass through a
    recorder that keeps a copy of a spec stage's inputs, its pool and plan,
    with the rows that are verify spans: the first, replaced by any later
    one that has a prefill chunk where the kept one has none, or as many
    prefill chunks and more verify spans."""
    if capture is None:
        yield
        return
    from repro_torch.models.params import tree_map
    step, dispatch = engine_mod.mixed_step, eng._dispatch_mixed
    current = {}

    def dispatch_mixed(fut):
        current["decision"] = fut.plan.decision
        return dispatch(fut)

    def recording(params, cfg, dec, ctok, cache, *, attn_ctx, chunk_ctx, plan,
                  spec_tokens=False):
        chunks = current["decision"].chunks
        prefill = any(c.draft is None for c in chunks)
        verify = [i for i, c in enumerate(chunks) if c.draft is not None]
        if spec_tokens and (prefill, len(verify)) > (capture.get("prefill", False),
                                                     len(capture.get("verify", ()))):
            clone = lambda d: {k: v.clone() for k, v in d.items()}
            capture.clear()
            capture.update(dec=dec.clone(), ctok=ctok.clone(),
                           cache=tree_map(cache, lambda t: t.clone()),
                           attn_ctx=clone(attn_ctx), chunk_ctx=clone(chunk_ctx), plan=plan,
                           verify=verify, prefill=prefill)
        return step(params, cfg, dec, ctok, cache, attn_ctx=attn_ctx, chunk_ctx=chunk_ctx,
                    plan=plan, spec_tokens=spec_tokens)

    engine_mod.mixed_step, eng._dispatch_mixed = recording, dispatch_mixed
    try:
        yield
    finally:
        engine_mod.mixed_step = step
        del eng._dispatch_mixed


def spec_phase(torch, cfg, params):
    """Path i: path a's engine with speculation (``SPEC_KW``) on
    ``spec_requests``, three runs in one call (``SPEC_RUNS``): spec_k 0
    through ``run``, then spec_k 4 through ``run`` and ``run_async``. Each
    gated by ``spec_run``; each prints its stages (with and without a verify
    span), drafts proposed and accepted, rewinds, acceptance, wall, tokens/s,
    median TBT and TTFT, the mean chunk rows and slab tokens a stage and
    its host split, and the spec runs how many requests emit run 1's tokens,
    each other one with its first departing position and the top-2 logit
    gap there (at most ``SPEC_GAP_BAND``). Then one verify stage of run 2
    against the plain path, the float32 LM head's time over a spec stage's
    slab, and a short profiled run."""
    import numpy as np
    base, capture = None, {}
    for spec_k, loop in SPEC_RUNS:
        reqs, eng, wall, split, buckets = spec_run(
            torch, cfg, params, spec_k, loop, capture if (spec_k, loop) == (4, "sync") else None)
        st = eng.stats()
        n = len(eng.reports)
        gen = sum(len(r.output) for r in reqs)
        tbt = [t for r in reqs for t in r.tbts()]
        verify = sum(r.spec_proposed > 0 for r in eng.reports)
        line = (f"serve [{SPEC_LABEL}, spec_k={spec_k} {loop}]: 16/16 completed in "
                f"{wall:.3f}s; generated tokens/s={gen / wall:.1f}; median TBT="
                f"{np.median(tbt) * 1e3:.1f}ms (0 where a stage commits several tokens of a "
                f"request: they share its clock), mean {np.mean(tbt) * 1e3:.1f}ms, median TTFT="
                f"{np.median([r.t2ft() for r in reqs]) * 1e3:.0f}ms; stages={n} ({verify} with "
                f"a verify span, {n - verify} without; {sum(r.is_mixed for r in eng.reports)} "
                f"mixed); proposed {st['spec_proposed']}, accepted {st['spec_accepted']}, "
                f"rewinds {st['spec_rewinds']}, acceptance {st['spec_acceptance']:.3f}; mean "
                f"chunk rows a stage {np.mean([r.num_prefill for r in eng.reports]):.2f}, slab "
                f"tokens a stage {sum(b * s for b, s in buckets) / n:.1f}; spec misses "
                f"{json.dumps(st['spec_miss_reasons'])}, chained {st['chained_stages']}; host "
                f"ms a stage: " + ", ".join(f"{k} {v / n * 1e3:.2f}" for k, v in split.items()))
        if base is None:
            base = {r.rid: list(r.output) for r in reqs}
            log(line)
            del eng
            continue
        same = [r.rid for r in reqs if r.output == base[r.rid]]
        depart, wide = {}, []
        for r in reqs:
            if r.rid in same:
                continue
            i = next(i for i, (x, y) in enumerate(zip(r.output, base[r.rid])) if x != y)
            gap = top2_gap(torch, cfg, params, r.prompt + r.output[:i])
            depart[r.rid] = f"{i} (gap {gap:.4f}; {base[r.rid][i]} / {r.output[i]})"
            if gap > SPEC_GAP_BAND:
                wide.append(r.rid)
        log(line + f"; {len(same)}/16 requests emit run 1's tokens"
            + (f", the others depart at {depart} (rid: position (the top-2 logit gap there "
               f"from a one-sequence prefill; run 1's token / this run's))" if depart else ""))
        if wide:
            raise AssertionError(f"[{SPEC_LABEL}] requests {wide} depart from run 1's tokens "
                                 f"at a top-2 gap above {SPEC_GAP_BAND}")
        del eng
    check_spec_against_plain(torch, cfg, params, capture)
    del capture
    spec_head_time(torch, cfg, params)
    profile_stages(torch, cfg, params, SPEC_LABEL, SPEC_KW,
                   reqs=[dataclasses.replace(r, max_new_tokens=8)
                         for r in spec_requests(cfg)[6:10]])


def check_spec_against_plain(torch, cfg, params, cap):
    """The stage ``spec_run`` kept (a verify span, and a prefill chunk if
    one came) through the kernels and through the plain path, each on its
    own copy of the pool, the plain path on the kernel path's expert
    choices (``recorded_routes``): the logits of the decode rows, of each
    chunk row's last position and of every live verify position (the whole
    slab's LM head, recorded) to ``compare_logits``, whose argmax rule
    holds ``chunk_argmax`` there."""
    import repro_torch.models.model as model_mod
    from repro_torch.models.params import tree_map
    if not cap:
        raise AssertionError(f"[{SPEC_LABEL}] no stage carried a verify span")
    head = model_mod._lm_head
    out, routes = {}, None
    for use_kernels in (True, False):
        plan = cap["plan"] if use_kernels else dataclasses.replace(
            cap["plan"], moe_ragged=False, use_kernels=False)
        slabs = []
        model_mod._lm_head = lambda p, c, x: slabs.append(head(p, c, x)) or slabs[-1]
        try:
            cache = tree_map(cap["cache"], lambda t: t.clone())
            with torch.no_grad(), recorded_routes(torch, routes) as calls:
                dl, cl, _, _, am = model_mod.mixed_step(
                    params, cfg, cap["dec"], cap["ctok"], cache, attn_ctx=cap["attn_ctx"],
                    chunk_ctx=cap["chunk_ctx"], plan=plan, spec_tokens=True)
        finally:
            model_mod._lm_head = head
        del cache
        routes = routes or calls
        clens = cap["chunk_ctx"]["chunk_lens"].tolist()
        rows = [slabs[2][i, :clens[i]] for i in cap["verify"]]
        if not torch.equal(torch.cat([am[i, :clens[i]] for i in cap["verify"]]),
                           torch.cat(rows).argmax(-1).to(am.dtype)):
            raise AssertionError(f"[{SPEC_LABEL}] chunk_argmax is not the slab's argmax")
        live_d = cap["attn_ctx"]["valid"]
        live_c = cap["chunk_ctx"]["chunk_lens"] > 0
        out[use_kernels] = torch.cat([dl[live_d, 0], cl[live_c, 0]] + rows).float()
    n_pos = sum(cap["chunk_ctx"]["chunk_lens"][i].item() for i in cap["verify"])
    compare_logits(torch, SPEC_LABEL, f"one stage of {len(cap['verify'])} verify spans "
                   f"({n_pos} positions) {'and a prefill chunk ' if cap['prefill'] else ''}"
                   f"with {int(cap['attn_ctx']['valid'].sum())} decode rows, the kernel "
                   f"path's expert choice", out[True], out[False])


def spec_head_time(torch, cfg, params):
    """The float32 LM head a spec stage runs over its whole chunk slab (20
    rows of 64: 4 prefill chunks and 16 verify spans), against the head a
    stage without verify spans runs (each chunk row's last position and
    16 decode rows), timed by events; its bound by float32 operations."""
    from repro_torch.models.model import _lm_head
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    p32 = dict(params, lm_head_f32=head["table"].float())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    for what, shape in (("spec stage slab 20 x 64", (20, 64, cfg.d_model)),
                        ("plain stage, 4 chunk rows + 16 decode rows", (20, 1, cfg.d_model))):
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        ms = time_ms(lambda: _lm_head(p32, cfg, x))
        flops = 2 * shape[0] * shape[1] * cfg.d_model * cfg.vocab_size
        bms, by = bound_ms(cfg.vocab_size * cfg.d_model * 4 + x.numel() * 4
                           + shape[0] * shape[1] * cfg.vocab_size * 4, flops, "float32")
        log(f"serve [{SPEC_LABEL}]: float32 LM head over the {what}: {ms:.3f} ms "
            f"(bound {bms:.3f} ms by {by}, {flops / ms / 1e9:.1f} TFLOP/s)")
    del p32


# path j: the fleet. Three replicas of path e's engine (8 slots, a full pool)
# share one parameter set; 24 requests from three tenants (a chat front end
# with a few products behind a pool of replicas), each tenant its own
# seeded 256-token system prompt, each request a seeded 64-256-token
# private suffix and 32 new tokens, arriving one a tick in a seeded tenant
# order, on a virtual clock of 0.1 s a tick (tests/test_torch_fleet.py runs
# these functions on the CPU and holds J_EXPECT)
FLEET_LABEL = "fleet: three tenants over three replicas"
FLEET_KW = dict(SHARED_KW, max_slots=8, audit_stages=True)
FLEET_REPLICAS, FLEET_TENANTS, FLEET_REQUESTS = 3, 3, 24
TICK_S = 0.1
# seed 3: the first seed whose run, besides the deterministic events, draws an
# injected replica kill and lets the drained replica retire (seeds 0-2 kill the
# draining replica or none)
FLEET_SEED = 3
FLEET_FAULTS = dict(CHAOS_FAULTS, p_replica_kill=0.005, p_replica_spike=0.03)
# j3's deterministic events, (tick, event, replica), each before that
# tick's arrival: replica 1 killed mid-flight, then replica 2 replaced (a
# fresh replica joins and replica 2 drains)
FLEET_EVENTS = ((8, "kill", 1), (14, "join", None), (14, "drain", 2))
# (run, router, async_steps, faults and the deterministic events)
FLEET_RUNS = (("j1", "affinity", False, False), ("j2", "round-robin", False, False),
              ("j3", "affinity", True, True))
# each run's counters as the port's engine forms them on the CPU
# (``fleet_counters``; ``counters`` the summed STATS_DELTA_KEYS windows, the
# zero ones left out)
_J_ZERO = dict.fromkeys(("preemptions", "forced_evictions", "stage_aborts", "retries", "shed",
                         "expired", "cancelled", "rejected", "audit_violations",
                         "spec_proposed", "spec_accepted"), 0)
J_EXPECT = {
    "j1": dict(ticks=59, routed={0: 8, 1: 8, 2: 8}, skipped={0: 1792, 1: 1792, 2: 1792},
               kills=0, kills_suppressed=0, failovers=0,
               counters=dict(_J_ZERO, stages=170, shared_tokens_skipped=5376)),
    "j2": dict(ticks=68, routed={0: 8, 1: 8, 2: 8}, skipped={0: 1280, 1: 1536, 2: 1280},
               kills=0, kills_suppressed=0, failovers=0,
               counters=dict(_J_ZERO, stages=188, shared_tokens_skipped=4096)),
    "j3": dict(ticks=129, routed={0: 8, 1: 2, 2: 14, 3: 10},
               skipped={0: 1472, 1: 0, 2: 5056, 3: 2816}, kills=2, kills_suppressed=0,
               failovers=10,
               counters=dict(_J_ZERO, stages=229, preemptions=15, forced_evictions=11,
                             stage_aborts=9, retries=13, shared_tokens_skipped=9344)),
}


def fleet_requests(cfg):
    """Path j's 24 requests, rid order = arrival order."""
    import numpy as np
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(27)
    systems = [rng.integers(0, cfg.vocab_size, SHARED_PROMPT).tolist()
               for _ in range(FLEET_TENANTS)]
    tenants = rng.permutation(np.arange(FLEET_REQUESTS) % FLEET_TENANTS)
    return [Request(rid=i, prompt=systems[t] + rng.integers(
        0, cfg.vocab_size, int(rng.integers(64, 257))).tolist(), max_new_tokens=32)
        for i, t in enumerate(tenants)]


def fleet_run(cfg, params, run, device="cuda", wrap=None, on_token=None):
    """One of path j's runs (``run`` a row of FLEET_RUNS): a Fleet of
    FLEET_REPLICAS engines built on ``device`` (``wrap(engine)`` applied to
    each), the requests submitted one a tick, every tick ``step(now=tick x
    TICK_S)`` until the fleet drains; j3 also runs FLEET_EVENTS, each kill
    and drain checked to land on a live replica holding live requests.
    Returns (fleet, requests)."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import FaultInjector
    from repro_torch.serving.fleet import Fleet
    name, router, async_steps, faults = run

    def factory(i, inj):
        eng = ServingEngine(cfg, params, device=device, injector=inj, on_token=on_token,
                            **FLEET_KW)
        if wrap is not None:
            wrap(eng)
        return eng

    fleet = Fleet(factory, FLEET_REPLICAS, router=router, async_steps=async_steps,
                  injector=FaultInjector(FLEET_SEED, **FLEET_FAULTS) if faults else None,
                  min_live=1)
    reqs = fleet_requests(cfg)
    k = 0
    while k < len(reqs) or fleet.has_work:
        if k > 5000:
            raise AssertionError(f"[{FLEET_LABEL}, {name}] did not drain in 5000 ticks")
        now = k * TICK_S
        for tick, event, rid in (FLEET_EVENTS if faults else ()):
            if tick != k:
                continue
            if event == "join":
                fleet.join()
                continue
            rep = fleet._replica(rid)
            live = [r for r in rep.engine._requests.values() if not r.done]
            if rep.dead or not live:
                raise AssertionError(f"[{FLEET_LABEL}, {name}] {event} of replica {rid} at "
                                     f"tick {k}: dead {rep.dead}, {len(live)} live requests")
            (fleet.kill(rid, now=now) if event == "kill" else fleet.drain(rid))
        if k < len(reqs):
            reqs[k].arrival_time = now
            fleet.submit(reqs[k], now=now)
        fleet.step(now=now)
        k += 1
    fleet.poll()
    return fleet, reqs


def fleet_counters(fleet):
    """Path j's gated counters: ticks, requests routed to each replica (its
    engine's submits, failovers included), prompt positions skipped on
    each, kills, suppressed kills, failovers and the fleet's counters."""
    reps = sorted(fleet.replicas + fleet.retired, key=lambda rep: rep.id)
    return dict(ticks=fleet.ticks,
                routed={rep.id: len(rep.engine._requests) for rep in reps},
                skipped={rep.id: rep.engine.shared_tokens_skipped for rep in reps},
                kills=fleet.kills, kills_suppressed=fleet.kills_suppressed,
                failovers=fleet.failovers, counters=dict(fleet.counters))


def fleet_gates(fleet, reqs):
    """Path j's gates on one run's host state (the launches and counters
    aside). Returns the failures."""
    st = fleet.stats()
    fails = []
    if not (st["terminal"] == st["submitted"] == FLEET_REQUESTS
            and st["duplicate_submits"] == 0 and st["lost"] == 0):
        fails.append(f"not exactly once: terminal {st['terminal']}, submitted "
                     f"{st['submitted']}, duplicates {st['duplicate_submits']}, lost {st['lost']}")
    if not all(r.completed and len(r.output) == 32 for r in reqs):
        fails.append("not every request completed with 32 tokens")
    dirty = {i: s["audit_violations"] for i, s in st["per_replica"].items()
             if s["audit_violations"]}
    if dirty:
        fails.append(f"audit violations {dirty}")
    unclean = [rep.id for rep in fleet.replicas if not rep.dead and not drained(rep.engine)]
    unclean += [rep.id for rep in fleet.retired if rep.drain_clean is not True]
    if unclean:
        fails.append(f"replicas {unclean} did not drain clean")
    return fails


def fleet_phase(torch, cfg, params):
    """Path j: FLEET_RUNS on one parameter set, each with every launch count
    set to 0 just before and read just after and every ``dispatch_stage``
    under sync debug "error" (``HostSplit`` on each replica). Each gated by
    ``fleet_gates``, kernels 1-4 on their routes and ``J_EXPECT``; j1 must
    skip more shared prompt positions than j2, j3 must kill and fail over,
    and each request of j3 that departs from j1's tokens must do so at a
    top-2 logit gap at most SPEC_GAP_BAND. Prints each run's wall, ticks,
    tokens/s, median TBT and TTFT (host clock, from ``on_token``), the mean
    host plan ms a stage (the Op/B plan included), routing and skips by
    replica, and the peak memory."""
    import numpy as np
    from repro_torch.kernels import build
    base, skipped = None, {}
    for run in FLEET_RUNS:
        name = run[0]
        label = f"{FLEET_LABEL}, {name} ({run[1]}{', async, faults' if run[3] else ''})"
        splits, times = [], {}
        gc.collect()                    # the previous run's replicas and pools go
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        fleet, reqs = fleet_run(
            cfg, params, run, wrap=lambda eng: splits.append((eng, HostSplit(torch, eng))),
            on_token=lambda rid, tok: times.setdefault(rid, []).append(time.perf_counter()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(build.launch_counts)
        check_path_a_launches(label, counts)
        got = fleet_counters(fleet)
        st = fleet.stats()
        gen = sum(len(r.output) for r in reqs)
        tbt = [b - a for ts in times.values() for a, b in zip(ts, ts[1:])]
        ttft = [ts[0] - t0 for ts in times.values()]
        stages = sum(len(eng.reports) for eng, _ in splits)
        plan_ms = sum(s.seconds["plan"] for _, s in splits) / max(stages, 1) * 1e3
        enq_ms = sum(s.seconds["enqueue"] for _, s in splits) / max(stages, 1) * 1e3
        bw = [r.bandwidth_flop_fraction for eng, _ in splits for r in eng.reports
              if not r.is_mixed and not r.aborted]
        log(f"serve [{label}]: {sum(r.completed for r in reqs)}/{FLEET_REQUESTS} completed "
            f"in {wall:.3f}s, {got['ticks']} ticks, {stages} stages; generated tokens/s="
            f"{gen / wall:.1f}; median TBT={np.median(tbt) * 1e3:.1f}ms, median TTFT="
            f"{np.median(ttft) * 1e3:.0f}ms (host clock); host ms a stage: plan {plan_ms:.2f} "
            f"(the Op/B plan included), enqueue {enq_ms:.2f}; decode-stage bandwidth-path "
            f"FLOP fraction {np.mean(bw):.3f}; routed {got['routed']}, skipped "
            f"{got['skipped']}; kills {got['kills']} (suppressed {got['kills_suppressed']}), "
            f"failovers {got['failovers']}, health {st['healthy']} healthy / "
            f"{st['degraded']} degraded / {st['dead']} dead / {st['retired']} retired; "
            f"counters {json.dumps(got['counters'])}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        fails = fleet_gates(fleet, reqs)
        if got != J_EXPECT[name]:
            fails.append(f"counters {got} differ from the CPU schedule's {J_EXPECT[name]}")
        if fails:
            raise AssertionError(f"[{label}] {'; '.join(fails)}")
        skipped[name] = sum(got["skipped"].values())
        if name == "j1":
            base = {r.rid: list(r.output) for r in reqs}
        if name == "j3":
            if got["kills"] < 1 or got["failovers"] < 1:
                raise AssertionError(f"[{label}] no kill or no failover")
            same = [r.rid for r in reqs if r.output == base[r.rid]]
            depart, wide = {}, []
            for r in reqs:
                if r.rid in same:
                    continue
                i = next(i for i, (x, y) in enumerate(zip(r.output, base[r.rid])) if x != y)
                gap = top2_gap(torch, cfg, params, r.prompt + r.output[:i])
                depart[r.rid] = f"{i} (gap {gap:.4f})"
                if gap > SPEC_GAP_BAND:
                    wide.append(r.rid)
            log(f"serve [{label}]: {len(same)}/{FLEET_REQUESTS} requests emit j1's tokens"
                + (f", the others depart at {depart} (rid: position (the top-2 logit gap "
                   f"there from a one-sequence prefill))" if depart else ""))
            if wide:
                raise AssertionError(f"[{label}] requests {wide} depart from j1's tokens at "
                                     f"a top-2 gap above {SPEC_GAP_BAND}")
        del fleet, splits
    log(f"serve [{FLEET_LABEL}]: shared prompt positions skipped j1 {skipped['j1']}, j2 "
        f"{skipped['j2']}, j3 {skipped['j3']}")
    if not skipped["j1"] > skipped["j2"]:
        raise AssertionError(f"[{FLEET_LABEL}] affinity skipped no more positions than "
                             f"round-robin")
    log(f"card: {gpu_name_and_power()}")


# path k: the serve CLI (k1, k2) and sampling at a temperature (k3)
CLI_LABEL = "serve CLI"
CLI_ARGS = ("--arch olmoe-1b-7b --requests 16 --l-in 256 --l-out 32 --max-slots 16 "
            "--max-len 1024 --kv-layout paged --kv-page-size 16 --prefill-chunk 64 "
            "--kernels").split()
CLI_FLEET_ARGS = "--replicas 2 --prefix-share --chaos 0 --async".split()
SAMPLE_LABEL = "sampling: path a's engine at temperature 0.8"
SAMPLE_PARAMS = dict(temperature=0.8, top_k=50, top_p=0.95)


def cli_phase(torch, a_tokens):
    """Path k: k1, ``repro_torch.launch.serve.main(CLI_ARGS)`` in-process;
    k2, the same with CLI_FLEET_ARGS and ``--profile`` into a temporary
    directory; each with every launch count set to 0 just before and read
    just after, the engines it builds recorded: exit code 0, 16/16
    completed, kernels 1-4 on their routes, the k_cold range and the
    decode-stage bandwidth-path FLOP fraction of its engines printed, and
    for k2 a trace file. Then k3: path a's engine and requests at
    SAMPLE_PARAMS with seed 0, twice (``sample_run``)."""
    import io
    import tempfile
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    for name, extra in (("k1", []), ("k2", CLI_FLEET_ARGS)):
        engines = []
        make = serve.ServingEngine

        def recording(*a, **kw):
            engines.append(make(*a, **kw))
            return engines[-1]

        label = f"{CLI_LABEL}, {name}"
        with tempfile.TemporaryDirectory() as tmp:
            argv = CLI_ARGS + extra + (["--profile", tmp] if name == "k2" else [])
            log(f"serve [{label}]: python -m repro_torch.launch.serve {' '.join(argv)}")
            serve.ServingEngine, out = recording, io.StringIO()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    rc = serve.main(argv)
                torch.cuda.synchronize()
            finally:
                serve.ServingEngine = make
                text = out.getvalue()
                sys.stdout.write(text)            # the CLI's report lines
            wall = time.perf_counter() - t0
            counts = dict(build.launch_counts)
            traces = [p for p in Path(tmp).rglob("*.json") if p.stat().st_size > 0]
            trace_mb = sum(p.stat().st_size for p in traces) / 2**20
        reps = [r for eng in engines for r in eng.reports]
        kc = [r.k_cold for r in reps]
        bw = [r.bandwidth_flop_fraction for r in reps if not r.is_mixed and not r.aborted]
        log(f"serve [{label}]: exit {rc} in {wall:.1f}s (weights made by the CLI included); "
            f"{len(engines)} engine(s), {len(reps)} stages, k_cold min={min(kc)} max={max(kc)}, "
            f"decode-stage bandwidth-path FLOP fraction {np.mean(bw):.3f}"
            + (f"; trace files {len(traces)}, {trace_mb:.1f} MiB" if name == "k2" else ""))
        check_path_a_launches(label, counts)
        n = argv[len(argv) - argv[::-1].index("--requests")]    # the last one counts
        if rc != 0 or f"{n}/{n} completed" not in text:
            raise AssertionError(f"[{label}] exit {rc}, or not {n}/{n} completed")
        if name == "k1" and not ("bandwidth-path FLOP fraction" in text and "k_cold" in text):
            raise AssertionError(f"[{label}] no bandwidth-path FLOP fraction or k_cold line")
        if name == "k2" and not traces:
            raise AssertionError(f"[{label}] --profile wrote no trace file")
        del engines, reps
    gc.collect()
    torch.cuda.empty_cache()
    sample_phase(torch, a_tokens)


def sample_phase(torch, a_tokens):
    """k3: path a's engine and requests through ``run`` at SAMPLE_PARAMS and
    seed 0, twice, every ``dispatch_stage`` under sync debug "error": each
    16/16 with 32 in-vocabulary tokens and kernels 1-4 on their routes, the
    two runs' tokens equal, and at least one request off path a's greedy
    tokens."""
    import numpy as np
    from repro_torch.configs import resolve_config
    from repro_torch.kernels import build
    from repro_torch.models.params import init_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampling import SamplingParams
    cfg = resolve_config("olmoe-1b-7b")
    params = init_model(cfg, seed=0, device="cuda")
    outs = []
    for i in range(2):
        label = f"{SAMPLE_LABEL}, run {i + 1}"
        reqs = path_a_requests(cfg)
        eng = ServingEngine(cfg, params, device="cuda", sampling=SamplingParams(**SAMPLE_PARAMS),
                            seed=0, **ASYNC_KW)
        split = HostSplit(torch, eng)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        for r in reqs:
            r.arrival_time = time.monotonic()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(build.launch_counts)
        check_path_a_launches(label, counts)
        ok = all(r.completed and len(r.output) == 32
                 and all(0 <= t < cfg.vocab_size for t in r.output) for r in reqs)
        outs.append({r.rid: list(r.output) for r in reqs})
        n = len(eng.reports)
        greedy = sum(outs[-1][rid] == a_tokens[rid] for rid in a_tokens)
        log(f"serve [{label}]: {sum(r.completed for r in reqs)}/16 completed in {wall:.3f}s, "
            f"stages={n}; generated tokens/s={sum(len(r.output) for r in reqs) / wall:.1f}; "
            f"host ms a stage: " + ", ".join(f"{k} {v / n * 1e3:.2f}"
                                             for k, v in split.seconds.items())
            + f"; {greedy}/16 requests emit path a's greedy tokens; distinct tokens "
            f"{len({t for o in outs[-1].values() for t in o})}")
        if not ok or not drained(eng):
            raise AssertionError(f"[{label}] not 16/16 with 32 in-vocabulary tokens, or the "
                                 f"pool did not drain")
        if greedy == 16:
            raise AssertionError(f"[{label}] every request emitted the greedy tokens")
        del eng
    if outs[0] != outs[1]:
        raise AssertionError(f"[{SAMPLE_LABEL}] two runs from seed 0 emitted other tokens")
    del params


def check_expert_routes(label, counts):
    """Every hot GEMM and cold GEMV launch of a (bf16) path ran the
    tensor-core kernels of ``moe_gemm_sm90.cu`` and ``moe_gemv_sm90.cu``."""
    for name in ("ragged_moe_gemm", "moe_gemm", "ragged_moe_gemv", "moe_gemv"):
        if counts[name]:
            sm90 = counts[f"{name}_sm90"]
            log(f"serve [{label}]: {name} launches {counts[name]}, {sm90} of them on the "
                f"tensor-core route ({name.replace('ragged_', '')}_sm90.cu)")
            if sm90 != counts[name]:
                raise AssertionError(f"[{label}] {name} left the tensor-core route")


def path_a_requests(cfg):
    """The 16 seeded requests of paths a-c and f: prompts of 128-512 random
    tokens, 32 new tokens each."""
    import numpy as np
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(128, 513))).tolist(),
                    max_new_tokens=32) for i in range(16)]


def serve_path(torch, cfg, params, label, engine_kw, reqs=None):
    """One path's run (path a's requests unless ``reqs`` is given): every
    launch count set to 0 just before it and read just after. Returns
    (launch counts, the engine)."""
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    reqs = path_a_requests(cfg) if reqs is None else reqs
    n_req, l_out = len(reqs), reqs[0].max_new_tokens
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

    done = sum(r.completed for r in reqs)
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


# path t: path a's engine in float32 at full width and depth: OLMoE-1B-7B
# with dtype and param_dtype float32 (6.92B parameters, 27.7 GB), path r's
# four requests; every chunk call on the 3xTF32 route (chunk_f32_sm90.cu),
# the paged decode (kernel 1 in float32) and the MoE's float32 kernels
# (moe_gemm.cu, moe_gemv.cu) launched; greedy tokens equal to the plain
# float32 path's on the same engine, the kernel run's expert choices pinned
T_LABEL = "olmoe float32: path a's engine"
T_KERNELS = ("paged_decode_attention", "chunked_prefill_attention", "ragged_moe_gemm",
             "ragged_moe_gemv")


def f32_phase(torch):
    """Path t. Returns {row of the kernels line: launches}: the float32
    chunk route's, the float32 MoE kernels', and kernel 1's."""
    from repro_torch.configs import resolve_config
    from repro_torch.kernels import build
    from repro_torch.models.params import init_model
    from repro_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(resolve_config("olmoe-1b-7b"), dtype="float32",
                              param_dtype="float32")
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"serve [{T_LABEL}]: random init (seed 0), float32 weights "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB in {time.perf_counter() - t_phase:.1f}s")
    kw = {**ENGINE_KW, **PATHS[0][1]}
    reqs = short_requests(cfg)
    eng = ServingEngine(cfg, params, device="cuda", **kw)
    build.reset_launch_counts()
    with recorded_routes(torch) as routes:
        t0 = time.perf_counter()
        for r in reqs:
            r.arrival_time = time.monotonic()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    stages = len(eng.reports)
    del eng
    gen = sum(len(r.output) for r in reqs)
    log(f"serve [{T_LABEL}]: {sum(r.completed for r in reqs)}/{len(reqs)} completed, "
        f"{stages} stages in {wall:.2f}s, generated tokens/s={gen / wall:.1f}; kernel "
        f"launches {json.dumps({k: counts[k] for k in T_KERNELS})}")
    missing = [k for k in T_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"[{T_LABEL}] kernels never launched on the path: {missing}")
    f32, chunks = counts["chunked_prefill_attention_f32_sm90"], counts["chunked_prefill_attention"]
    scalar = chunks - f32 - counts["chunked_prefill_attention_sm90"]
    log(f"serve [{T_LABEL}]: chunked prefill launches {chunks}, {f32} of them on the 3xTF32 "
        f"route (chunk_f32_sm90.cu), {scalar} on the scalar kernel (decode_attn.cu); hot GEMM "
        f"{counts['ragged_moe_gemm']} and cold GEMV {counts['ragged_moe_gemv']} launches, all "
        f"float32 (moe_gemm.cu, moe_gemv.cu): {counts['ragged_moe_gemm_sm90']} and "
        f"{counts['ragged_moe_gemv_sm90']} on the bf16 routes")
    if f32 != chunks:
        raise AssertionError(f"[{T_LABEL}] chunked prefill left the 3xTF32 route")
    if counts["ragged_moe_gemm_sm90"] or counts["ragged_moe_gemv_sm90"]:
        raise AssertionError(f"[{T_LABEL}] a float32 MoE call took a bf16 route")
    # the plain path on the same engine: no kernel, the duplex MoE on every
    # stage as the kernel path runs it, so each router call takes the kernel
    # run's expert choice (a router near-tie is no fault)
    plain = short_requests(cfg)
    eng = ServingEngine(cfg, params, device="cuda", use_kernels=False, **kw)
    eng.moe_ragged = True
    t0 = time.perf_counter()
    with recorded_routes(torch, routes) as calls:
        eng.run(plain)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    del eng
    same = sum(a.output == b.output for a, b in zip(reqs, plain))
    log(f"serve [{T_LABEL}]: the plain float32 path on the kernel run's {len(routes)} router "
        f"calls ({len(calls)} made) in {t_plain:.2f}s: {same}/{len(reqs)} requests emit the "
        f"kernel path's greedy tokens")
    if same != len(reqs) or len(calls) != len(routes):
        raise AssertionError(f"[{T_LABEL}] the kernel path's tokens differ from the plain "
                             f"path's")
    profile_stages(torch, cfg, params, T_LABEL, kw)
    log(f"serve [{T_LABEL}]: path t in {time.perf_counter() - t_phase:.1f} s")
    return {"chunked_prefill_attention_f32_sm90": f32,
            "ragged_moe_gemm_f32": counts["ragged_moe_gemm"],
            "ragged_moe_gemv_f32": counts["ragged_moe_gemv"],
            "paged_decode_attention": counts["paged_decode_attention"]}


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
    log(f"serve [{HYBRID_LABEL}]: dense decode launches {counts['decode_attention']}, each "
        f"the split and merge kernels of decode_sm90.cu (its one route)")
    check_expert_routes(HYBRID_LABEL, counts)
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


# ---------------------------------------------------------------------------
# path l: gemma3-4b, rings for its sliding-window layers; l2: int8 dense
# caches; phase m: the dense decoders and Mamba2-2.7B at full width
# ---------------------------------------------------------------------------

RING_LABEL = "gemma3-4b dense KV + rings"
RING_INT8_LABEL = "gemma3-4b int8 dense KV + rings"
# the layout the reference gives a windowed stack: dense slots, whole-prompt
# legacy prefill; max_len past the window, so 29 of the 34 layers keep rings
RING_KW = dict(max_slots=16, max_len=4096, kv_layout="dense", prefill_chunk_tokens=None)
RING_NEW = 64
# 256 ... 2048: the 9 prompts over 1024 wrap their rings in prefill, the one
# of 973 wraps them in decode
RING_LENS = tuple(round(256 + i * 1792 / 15) for i in range(16))
# the ring check's requests, one at each side of the window: 256 (no wrap),
# 973 (wraps in decode), 1092 (wraps in prefill), 2048
RING_CHECK_RIDS = (0, 6, 7, 15)
RING_CHECK_LAST = 8                # decode positions a request is checked at
# path l's schedule, formed by the port's engine on the CPU
# (tests/test_torch_ring.py); kernel 7 runs once a decode stage in each of
# the 5 global layers, kernel 9 once a layer in each legacy prefill whose
# bucket passes the 512-position q block
L_EXPECT = dict(stages=67, decode_stages=66, prefill_stages=4, long_prefill_stages=4)
L_GLOBAL_LAYERS = 5
RING_KERNELS = ("decode_attention", "flash_attention")


def ring_requests(cfg):
    import numpy as np
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=RING_NEW) for i, n in enumerate(RING_LENS)]


def ring_engine(cfg, params, device="cuda", **kw):
    """Path l's engine, recording each legacy prefill's length bucket in
    ``eng.prefill_buckets`` (the bucket the engine pads that stage's
    prompts to)."""
    from repro_torch.serving import engine as engine_mod
    eng = engine_mod.ServingEngine(cfg, params, device=device, **RING_KW, **kw)
    eng.prefill_buckets = []
    dispatch = eng._dispatch_legacy_prefill

    def recording(fut):
        longest = max(len(c.req.token_stream(c.end)) for c in fut.plan.decision.chunks)
        eng.prefill_buckets.append(engine_mod._bucket(longest, eng.prefill_len_buckets))
        return dispatch(fut)
    eng._dispatch_legacy_prefill = recording
    return eng


def ring_counters(eng):
    reps = eng.reports
    return dict(stages=len(reps), decode_stages=sum(r.num_decode > 0 for r in reps),
                prefill_stages=len(eng.prefill_buckets),
                long_prefill_stages=sum(b > 512 for b in eng.prefill_buckets))


def dense_kv_bytes(eng):
    """The bytes of the K/V leaves (and their scales) of a dense cache."""
    return sum(t.numel() * t.element_size() for seg in eng.kv.cache for blk in seg["blocks"]
               for name, t in blk.items() if name in ("k", "v", "k_scale", "v_scale"))


def ring_kv_formula(cfg, per_token):
    """``per_token`` bytes a (slot, position, layer) over path l's slots: the
    global layers' max_len rows and the local layers' rings of window + 1."""
    slots, max_len = RING_KW["max_slots"], RING_KW["max_len"]
    n_global = sum(k.mixer == "attn" for k in cfg.layer_kinds())
    n_local = cfg.num_layers - n_global
    return slots * per_token * (n_global * max_len
                                + n_local * (min(max_len, cfg.sliding_window) + 1))


@contextlib.contextmanager
def recorded_decode_logits(torch, eng, rids, first):
    """Inside, each dense decode stage of ``eng`` keeps the float32 logits
    row of every request of ``rids`` that has committed at least ``first``
    tokens, keyed (rid, tokens committed): the logits its next token was
    sampled from."""
    from repro_torch.serving import engine as engine_mod
    step, rows = engine_mod.decode_step, {}

    def recording(*a, **kw):
        logits, cache, counts = step(*a, **kw)
        for slot, r in eng._slot_req.items():
            if r.rid in rids and len(r.output) >= first:
                rows[(r.rid, len(r.output))] = logits[slot, 0].float().clone()
        return logits, cache, counts

    engine_mod.decode_step = recording
    try:
        yield rows
    finally:
        engine_mod.decode_step = step


def check_ring_against_forward(torch, cfg, params, reqs, rows):
    """Ring correctness at full width: for each checked request, ``forward``
    over its prompt and generated tokens through the plain versions (so the
    oracle does not share kernel 9 with the engine's prefill), its logits
    at each of the last ``RING_CHECK_LAST`` positions against the engine's
    decode logits there, held to ``compare_logits``."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models.model import forward
    a, b = [], []
    for rid in RING_CHECK_RIDS:
        r = reqs[rid]
        seq = list(r.prompt) + list(r.output[:-1])
        toks = torch.tensor([seq], dtype=torch.int64, device="cuda")
        with torch.no_grad():
            logits, _ = forward(params, cfg, {"tokens": toks},
                                plan=ExecutionPlan(use_kernels=False))
        for j in range(RING_NEW - RING_CHECK_LAST, RING_NEW):
            a.append(rows[(rid, j)])
            b.append(logits[0, len(r.prompt) + j - 1])
        del logits
    compare_logits(torch, RING_LABEL, f"decode logits of requests {RING_CHECK_RIDS} (prompts "
                   f"{[RING_LENS[i] for i in RING_CHECK_RIDS]}) at their last "
                   f"{RING_CHECK_LAST} positions, against forward through the plain versions",
                   torch.stack(a), torch.stack(b))


def check_int8_dense_decode(torch, cfg, params):
    """Path l2's model-level rule, the reference's (``test_kv_quant.py``):
    prefill the checked requests' prompts, then one decode step, once into
    a dense cache in the model's dtype and once into an int8 one; the decode
    logits' largest difference over the largest |logit| of the first under
    0.05. The gate runs it in the reference test's arithmetic: the same
    weights in float32, both decodes through the plain path, so that only
    the cache's quantization differs. In bf16 the same rule is printed
    beside it, against the bf16 decode through the kernels and through the
    plain path: at gemma3-4b's width the int8 cache alone moves the logits
    by 3.4-4.7% at any depth (2-34 layers, bf16 or float32), and the bf16
    kernels' own arithmetic by 0.5-1.9% (NVIDIA H100 80GB HBM3, 700 W)."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.params import tree_map
    lens = [RING_LENS[i] for i in RING_CHECK_RIDS]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (len(lens), max(lens)), generator=gen,
                         device="cuda")
    true_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = tree_map(params, lambda t: t.float())

    def step(c, p, kv_quant, use_kernels, nxt=None):
        cache = init_cache(c, len(lens), RING_KW["max_len"], device="cuda", kv_quant=kv_quant)
        plan = ExecutionPlan(use_kernels=use_kernels)
        with torch.no_grad():
            lg, _ = prefill(p, c, {"tokens": toks}, cache, true_len, plan=plan)
            if nxt is None:
                nxt = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
            return decode_step(p, c, nxt, cache, {}, plan=plan)[0].float(), nxt

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()
    bf16, nxt = step(cfg, params, False, True)
    rows = {"bf16, kernels": bf16, "bf16, plain": step(cfg, params, False, False, nxt)[0],
            "int8": step(cfg, params, True, True, nxt)[0]}
    f32 = step(cfg32, params32, False, False, nxt)[0]
    i8_32 = step(cfg32, params32, True, False, nxt)[0]
    del params32
    got = rel(i8_32, f32)
    same = (i8_32.argmax(-1) == f32.argmax(-1)).float().mean().item()
    log(f"serve [{RING_INT8_LABEL}]: one decode step after prefills of {lens}, int8 dense "
        f"cache against the model's dtype (max |dlogit| / max |logit|): float32 weights, "
        f"plain path {got:.4f} (limit 0.05; argmax equal on {same:.2f} of the rows); bf16 "
        f"(no gate): against the kernels {rel(rows['int8'], rows['bf16, kernels']):.4f}, "
        f"against the plain path {rel(rows['int8'], rows['bf16, plain']):.4f}, the kernels "
        f"against the plain path {rel(rows['bf16, kernels'], rows['bf16, plain']):.4f}")
    if not bool(torch.isfinite(i8_32).all() and torch.isfinite(rows["int8"]).all()) \
            or got >= 0.05:
        raise AssertionError(f"[{RING_INT8_LABEL}] int8 dense decode departs from float32")


def ring_phase(torch):
    """Paths l and l2: gemma3-4b at full width and depth, random weights from
    seed 0, 16 requests (prompts of 256-2048 tokens, 64 new) on the dense
    layout with rings and the legacy prefill, kernels on; then the same with
    int8 dense caches. Returns path l's {kernel: launches}."""
    import numpy as np
    from repro_torch.configs import resolve_config
    from repro_torch.kernels import build
    from repro_torch.models.params import init_model, tree_leaves
    from repro_torch.serving.kvmanager import kv_token_bytes
    cfg = resolve_config("gemma3-4b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"serve: {cfg.name} at full width and depth ({cfg.num_layers} layers: "
        f"{cfg.num_layers - L_GLOBAL_LAYERS} with a {cfg.sliding_window}-position window, "
        f"{L_GLOBAL_LAYERS} global; head_dim {cfg.resolved_head_dim}, {cfg.num_heads} heads "
        f"over {cfg.num_kv_heads}), random init (seed 0) {n_params / 1e9:.2f}B params in "
        f"{time.perf_counter() - t0:.1f}s")
    tokens = {}
    launches = None
    for label, kv_quant in ((RING_LABEL, False), (RING_INT8_LABEL, True)):
        reqs = ring_requests(cfg)
        eng = ring_engine(cfg, params, kv_quant=kv_quant)
        kv_b = dense_kv_bytes(eng)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        for r in reqs:
            r.arrival_time = time.monotonic()
        first = RING_NEW - RING_CHECK_LAST
        with recorded_decode_logits(torch, eng, RING_CHECK_RIDS, first) as rows:
            eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(build.launch_counts)
        got = ring_counters(eng)
        reps = eng.reports
        dec_only = [r for r in reps if not r.num_prefill]
        gen = sum(len(r.output) for r in reqs)
        done = sum(r.completed and len(r.output) == RING_NEW
                   and all(0 <= t < cfg.vocab_size for t in r.output) for r in reqs)
        tbt = [t for r in reqs for t in r.tbts()]
        log(f"serve [{label}]: {done}/{len(reqs)} completed, "
            f"{sum(len(r.prompt) for r in reqs)} prompt tokens, {gen} generated, "
            f"schedule {json.dumps(got)} (CPU: {json.dumps(L_EXPECT)}), prefill buckets "
            f"{eng.prefill_buckets}, in {wall:.2f}s; generated tokens/s={gen / wall:.1f}; "
            f"decode-only stage ms median={np.median([r.wall_time for r in dec_only]) * 1e3:.1f}"
            f"; median TBT={np.median(tbt) * 1e3:.1f}ms, median TTFT="
            f"{np.median([r.t2ft() for r in reqs]) * 1e3:.0f}ms; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"serve [{label}]: kernel launches on the path: {json.dumps(counts)}")
        if done != len(reqs):
            raise AssertionError(f"[{label}]: {done}/{len(reqs)} completed")
        if got != L_EXPECT:
            raise AssertionError(f"[{label}] schedule {got} is not the CPU's {L_EXPECT}")
        want = dict(decode_attention=0 if kv_quant else got["decode_stages"] * L_GLOBAL_LAYERS,
                    flash_attention=got["long_prefill_stages"] * cfg.num_layers)
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"[{label}] launches {counts} are not {want}")
        per_tok = kv_token_bytes(cfg, kv_quant=kv_quant)
        formula = ring_kv_formula(cfg, per_tok)
        full = RING_KW["max_slots"] * per_tok * cfg.num_layers * RING_KW["max_len"]
        log(f"serve [{label}]: dense KV {kv_b} B ({kv_b / 2**30:.3f} GiB), streamed a decode "
            f"stage {eng._dense_kv_bytes_per_stage} B; formula {formula} B = 16 slots x "
            f"{per_tok} B x ({L_GLOBAL_LAYERS} x {RING_KW['max_len']} + "
            f"{cfg.num_layers - L_GLOBAL_LAYERS} x {cfg.sliding_window + 1}); full-length "
            f"caches would be {full / 2**30:.3f} GiB")
        if kv_b != formula or eng._dense_kv_bytes_per_stage != formula:
            raise AssertionError(f"[{label}] KV bytes {kv_b} / {eng._dense_kv_bytes_per_stage} "
                                 f"are not the formula's {formula}")
        tokens[kv_quant] = {r.rid: list(r.output) for r in reqs}
        if not kv_quant:
            launches = {k: counts[k] for k in RING_KERNELS}
            check_ring_against_forward(torch, cfg, params, reqs, rows)
            profile_stages(torch, cfg, params, label, RING_KW)
            l_bytes = kv_b
        else:
            log(f"serve [{label}]: KV bytes {kv_b / l_bytes:.6f} of path l's "
                f"({per_tok} / {kv_token_bytes(cfg)} = {per_tok / kv_token_bytes(cfg):.6f})")
        del eng, rows
    agree = sum(tokens[True][i] == tokens[False][i] for i in tokens[False])
    same = np.mean([a == b for i in tokens[False]
                    for a, b in zip(tokens[True][i], tokens[False][i])])
    log(f"serve [{RING_INT8_LABEL}]: greedy tokens equal to path l's on {agree}/16 requests, "
        f"{same:.3f} of the tokens (no gate)")
    check_int8_dense_decode(torch, cfg, params)
    return launches


# phase m: (config, engine flags, the kernels its run must launch); depth cut
# to 2 layers, the fewest that keep each structure
M_LAYERS = 2
M_CONFIGS = (
    ("qwen3-8b", ENGINE_KW, ("paged_decode_attention", "chunked_prefill_attention")),
    ("command-r-35b", ENGINE_KW, ("paged_decode_attention", "chunked_prefill_attention")),
    ("mistral-large-123b", ENGINE_KW,
     ("paged_decode_attention", "chunked_prefill_attention")),
    ("mamba2-2.7b", dict(max_slots=16, max_len=1024, prefill_chunk_tokens=None),
     ("ssd_decode",)),
)


def configs_phase(torch):
    """Phase m: each config of ``M_CONFIGS`` at full width and ``M_LAYERS``
    layers, random weights from seed 0: one engine run of 4 requests
    (128-512 tokens, 8 new) with its kernels launched, then one stage
    through the kernels against the plain path (paged: a mixed stage with
    decode rows; Mamba: path c's dense decode stages)."""
    import numpy as np
    from repro_torch.configs import resolve_config
    from repro_torch.configs.base import Segment
    from repro_torch.models.params import init_model, tree_leaves
    from repro_torch.serving.request import Request
    for name, kw, kernels in M_CONFIGS:
        full = resolve_config(name)
        (seg,) = full.segments
        cfg = dataclasses.replace(full, num_layers=M_LAYERS,
                                  segments=(Segment(seg.pattern, M_LAYERS),)).validate()
        label = f"{name} cut to {M_LAYERS} of {full.num_layers} layers"
        torch.cuda.reset_peak_memory_stats()
        params = init_model(cfg, seed=0, device="cuda")
        n_params = sum(t.numel() for t in tree_leaves(params))
        log(f"serve: {label}, random init (seed 0) {n_params / 1e9:.2f}B params")
        rng = np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   int(rng.integers(128, 513))).tolist(),
                        max_new_tokens=8) for i in range(4)]
        counts, eng = serve_path(torch, cfg, params, label, kw, reqs)
        del eng
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"[{label}] kernels never launched on the path: {missing}")
        if "ssd_decode" in kernels:
            check_decode_against_plain(torch, cfg, params, label)
        else:
            check_against_plain(torch, cfg, params, label, {})
        del params
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# paths n, o, p: the last three architectures. n: deepseek-moe-16b (shared
# experts) served by the engine at full width and depth; o: whisper-small
# (an encoder and cross-attention) and p: internvl2-1b (patch embeddings)
# through prefill + decode_step at full width and depth
# ---------------------------------------------------------------------------

N_LABEL = "deepseek-moe-16b paged KV + ragged MoE + shared experts"
N_KERNELS = ("paged_decode_attention", "chunked_prefill_attention", "ragged_moe_gemm",
             "ragged_moe_gemv")


def deepseek_phase(torch):
    """Path n: deepseek-moe-16b at full width and depth (28 layers: a dense
    FFN, then 27 layers of 64 routed experts top-6 and 2 shared ones),
    random weights from seed 0, path a's engine and requests. Gates: 16/16
    completed, kernels 1-4 launched, every MoE layer of every stage on the
    kernels (hot GEMM launches = MoE layers x stages with a hot expert, cold
    GEMV launches = MoE layers x stages with a cold one, all on the
    tensor-core routes), one mixed stage through the kernels against the
    plain path on the kernel path's expert choices, and the shared experts'
    part of that stage's logits. Returns {kernel: launches}."""
    from repro_torch.configs import resolve_config
    from repro_torch.configs.base import MOE
    from repro_torch.models.params import init_model, tree_leaves
    from repro_torch.serving.kvmanager import kv_token_bytes
    cfg = resolve_config("deepseek-moe-16b")
    log(f"serve: before {cfg.name}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"still allocated")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    log(f"serve: {cfg.name} at full width and depth ({cfg.num_layers} layers), random init "
        f"(seed 0) {sum(t.numel() for t in leaves) / 1e9:.2f}B params "
        f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f}s")
    counts, eng = serve_path(torch, cfg, params, N_LABEL, ENGINE_KW)
    missing = [k for k in N_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"[{N_LABEL}] kernels never launched on the path: {missing}")
    check_expert_routes(N_LABEL, counts)
    n_moe = sum(seg.repeats for seg in cfg.segments for k in seg.pattern if k.ffn == MOE)
    E = cfg.moe.num_experts
    want = {"ragged_moe_gemm": n_moe * sum(r.k_cold < E for r in eng.reports),
            "ragged_moe_gemv": n_moe * sum(r.k_cold > 0 for r in eng.reports)}
    log(f"serve [{N_LABEL}]: MoE launches {[counts[k] for k in want]}, "
        f"{n_moe} MoE layers x the stages with a hot / a cold expert {list(want.values())}")
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"[{N_LABEL}] an MoE layer of a stage left the kernels")
    mixed = collections.Counter(r.k_cold for r in eng.reports if r.is_mixed)
    log(f"serve [{N_LABEL}]: KV pool {eng.kv._total_bytes() / 2**30:.3f} GiB, "
        f"{kv_token_bytes(cfg) * cfg.num_layers} B a token over {cfg.num_layers} layers; "
        f"the mixed stages' commonest k_cold {mixed.most_common(3)}")
    del eng
    check_against_plain(torch, cfg, params, N_LABEL, {})
    profile_stages(torch, cfg, params, N_LABEL, ENGINE_KW)
    log(f"serve [{N_LABEL}]: peak memory since the weights were made "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return {k: counts[k] for k in N_KERNELS}


def greedy_generate(torch, cfg, params, batch, true_len, new, *, plan, max_len, enc_len=0,
                    forced=None, keep=()):
    """``prefill`` then ``new - 1`` ``decode_step``s on a fresh dense cache,
    greedy (argmax), or taking the tokens of ``forced`` (B, new) instead.
    Returns (tokens (B, new), {i: float32 logits (B, V) of the step that
    made token i, for i in ``keep``}, prefill seconds, decode seconds)."""
    from repro_torch.models.model import decode_step, init_cache, prefill
    B = true_len.shape[0]
    cache = init_cache(cfg, B, max_len, device="cuda", enc_len=enc_len)
    kept, toks = {}, []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = prefill(params, cfg, batch, cache, true_len, plan=plan)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(new):
            if i:
                logits, _, _ = decode_step(params, cfg, toks[-1], cache, {}, plan=plan)
            if i in keep:
                kept[i] = logits[:, 0].float()
            toks.append(logits[:, 0].argmax(-1, keepdim=True) if forced is None
                        else forced[:, i:i + 1])
        torch.cuda.synchronize()
    return torch.cat(toks, 1), kept, t1 - t0, time.perf_counter() - t1


def generate_path(torch, cfg, params, label, batch, true_len, new, *, max_len, enc_len=0,
                  want=None):
    """A path of ``greedy_generate`` through the kernels, every launch count
    set to 0 just before it and read just after (equal to ``want``), then
    the plain path on the kernel path's tokens: the logits of 8 decode
    steps held to ``compare_logits``. Returns (tokens, launch counts)."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.kernels import build
    keep = tuple(sorted({1 + (new - 2) * i // 7 for i in range(8)}))
    build.reset_launch_counts()
    toks, kept, t_pre, t_dec = greedy_generate(
        torch, cfg, params, batch, true_len, new, plan=ExecutionPlan(use_kernels=True),
        max_len=max_len, enc_len=enc_len, keep=keep)
    counts = dict(build.launch_counts)
    B = toks.shape[0]
    log(f"serve [{label}]: {B} requests x {new} new tokens (greedy) in "
        f"{t_pre + t_dec:.3f}s: prefill (TTFT) {t_pre * 1e3:.1f} ms, a decode step (TBT) "
        f"{t_dec / (new - 1) * 1e3:.2f} ms, generated tokens/s {B * new / (t_pre + t_dec):.1f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"serve [{label}]: kernel launches on the path: "
        f"{json.dumps({k: n for k, n in counts.items() if n})} (want {json.dumps(want)})")
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"[{label}] launches {counts} are not {want}")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"[{label}] tokens out of the vocabulary")
    _, plain, _, _ = greedy_generate(torch, cfg, params, batch, true_len, new,
                                     plan=ExecutionPlan(), max_len=max_len, enc_len=enc_len,
                                     forced=toks, keep=keep)
    a = torch.cat([kept[i] for i in keep])
    b = torch.cat([plain[i] for i in keep])
    compare_logits(torch, label, f"decode steps {list(keep)} ({B} rows each, the kernel "
                   f"path's tokens)", a, b)
    return toks, counts


O_LABEL = "whisper-small encoder + decoder, dense KV + cross caches"
O2_LABEL = "whisper-small training step"
O_CLIPS, O_FRAMES, O_PROMPT, O_NEW, O_MAX_LEN = 8, 1500, 4, 64, 448
O2_CLIPS = 4


def whisper_phase(torch):
    """Paths o and o2: whisper-small at full width and depth (12 encoder and
    12 decoder layers), random weights from seed 0, bf16. o: 8 clips of
    1500 seeded frame embeddings (whisper's n_audio_ctx) and a 4-token
    decoder prompt, 64 new tokens through ``prefill`` and ``decode_step``
    on a dense cache of max_len 448 (n_text_ctx) with cross caches of 1500:
    the flash forward (non-causal) once an encoder layer, the dense decode
    once a decoder layer a step; decode logits against the plain path, and
    prefill's logits against ``forward``'s at the last position. o2: one
    ``loss_fn`` and backward on 4 clips x (1500 frames + 448 tokens)
    through the flash forward and backward (12 launches each) against the
    plain path. Returns {kernel: launches} of o and o2 together."""
    from repro_torch.configs import resolve_config
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models.model import forward
    from repro_torch.models.params import init_model, tree_leaves
    cfg = resolve_config("whisper-small")
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, seed=0, device="cuda")
    log(f"serve: {cfg.name} at full width and depth ({cfg.enc_num_layers} encoder + "
        f"{cfg.num_layers} decoder layers), random init (seed 0) "
        f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f}B params")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    frames = torch.randn((O_CLIPS, O_FRAMES, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (O_CLIPS, O_PROMPT), generator=gen, device="cuda")
    batch = {"frames": frames, "dec_tokens": prompt}
    true_len = torch.full((O_CLIPS,), O_PROMPT, dtype=torch.int32, device="cuda")
    want = {"flash_attention": cfg.enc_num_layers,
            "decode_attention": cfg.num_layers * (O_NEW - 1)}
    toks, counts = generate_path(torch, cfg, params, O_LABEL, batch, true_len, O_NEW,
                                 max_len=O_MAX_LEN, enc_len=O_FRAMES, want=want)
    plan = ExecutionPlan(use_kernels=True)
    _, pre, _, _ = greedy_generate(torch, cfg, params, batch, true_len, 1, plan=plan,
                                   max_len=O_MAX_LEN, enc_len=O_FRAMES, keep=(0,))
    with torch.no_grad():
        fwd, _ = forward(params, cfg, batch, plan=plan)
    compare_logits(torch, O_LABEL, "prefill against forward at the prompt's last position",
                   pre[0], fwd[:, -1].float())
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    log(f"serve [{O_LABEL}]: cross caches {2 * cfg.num_layers * O_CLIPS * O_FRAMES * kv * hd * 2 / 2**20:.1f} "
        f"MiB (K+V x {cfg.num_layers} layers x {O_CLIPS} clips x {O_FRAMES} frames x {kv} "
        f"heads x {hd} x 2 B), self-attention KV "
        f"{2 * cfg.num_layers * O_CLIPS * O_MAX_LEN * kv * hd * 2 / 2**20:.1f} MiB")
    del fwd, frames, batch
    launches = {k: counts[k] for k in want}
    for k, n in whisper_train_check(torch, cfg, params).items():
        launches[k] = launches.get(k, 0) + n
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def whisper_train_check(torch, cfg, params):
    """Path o2: one ``loss_fn`` and backward on O2_CLIPS clips of O_FRAMES
    frames and O_MAX_LEN decoder tokens through the kernels (the launch
    counts set to 0 just before and read just after: the flash forward and
    backward once an encoder layer each; the decoder's 448 positions stay
    under the 512-row q block, its attention unblocked) and through the
    plain path: the loss within 1e-2 relative and encoder layer 0's
    attention gradients within 5e-2 of their largest entry (path d's
    bands). Returns the kernel run's {kernel: launches}."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.kernels import build
    from repro_torch.models.model import loss_fn
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    batch = {"frames": torch.randn((O2_CLIPS, O_FRAMES, cfg.d_model), generator=gen,
                                   device="cuda").to(torch.bfloat16),
             "dec_tokens": torch.randint(0, cfg.vocab_size, (O2_CLIPS, O_MAX_LEN),
                                         generator=gen, device="cuda")}
    mixer = params["encoder"]["segments"][0]["blocks"][0]["mixer"]
    names = ("wq", "wk", "wv", "wo")
    weights = [mixer[n]["kernel"] for n in names]
    for w in weights:
        w.requires_grad_(True)
    out, want = {}, {"flash_attention": cfg.enc_num_layers,
                     "flash_attention_bwd": cfg.enc_num_layers}
    try:
        for use_kernels in (True, False):
            build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = loss_fn(params, cfg, batch, plan=ExecutionPlan(use_kernels=use_kernels))
            grads = torch.autograd.grad(loss, weights)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if use_kernels:
                counts = dict(build.launch_counts)
            out[use_kernels] = (loss.item(), [g[0].float() for g in grads], wall)
            del loss, grads
    finally:
        for w in weights:
            w.requires_grad_(False)
    (lk, gk, wk), (lp, gp, wp) = out[True], out[False]
    rel = abs(lk - lp) / abs(lp)
    errs = [((a - b).abs().max().item(), b.abs().max().item()) for a, b in zip(gk, gp)]
    log(f"train [{O2_LABEL}]: {O2_CLIPS} clips x ({O_FRAMES} frames + {O_MAX_LEN} tokens), "
        f"loss + backward {wk * 1e3:.1f} ms through the kernels ({wp * 1e3:.1f} ms plain); "
        f"launches {json.dumps({k: counts[k] for k in want})} (want {json.dumps(want)}); "
        f"loss {lk:.5f} vs {lp:.5f} plain (rel {rel:.2e}, tolerance 1e-2); encoder layer 0 "
        "attention gradients " + ", ".join(f"{n}: max|d|={e:.3e} of max|g|={m:.3e}"
                                           for n, (e, m) in zip(names, errs))
        + " (tolerance 5e-2 x max|g|)")
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"[{O2_LABEL}] launches {counts} are not {want}")
    if not math.isfinite(lk) or rel > 1e-2 or any(e > 5e-2 * m for e, m in errs):
        raise AssertionError(f"[{O2_LABEL}] kernel path disagrees with the plain path")
    return {k: counts[k] for k in want}


P_LABEL = "internvl2-1b patches + text, dense KV"
P_REQS, P_PATCHES, P_NEW, P_MAX_LEN = 8, 1024, 32, 1536


def vlm_phase(torch):
    """Path p: internvl2-1b at full width and depth (24 layers, 14 heads
    over 2, head_dim 64), random weights from seed 0, bf16: 8 requests of
    1024 seeded patch embeddings and P_TEXT_LENS seeded text tokens, 32 new
    tokens through ``prefill`` (true_len = 1024 + text) and ``decode_step``
    on a dense cache of max_len 1536: the flash forward (causal, qpk 7)
    once a layer in the prefill, the dense decode once a layer a step;
    decode logits against the plain path, and prefill's logits against
    each request's own ``forward`` at its last position. Returns {kernel:
    launches}."""
    from repro_torch.configs import resolve_config
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models.model import forward
    from repro_torch.models.params import init_model, tree_leaves
    cfg = resolve_config("internvl2-1b")
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, seed=0, device="cuda")
    log(f"serve: {cfg.name} at full width and depth ({cfg.num_layers} layers), random init "
        f"(seed 0) {sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f}B params")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    patches = torch.randn((P_REQS, P_PATCHES, cfg.d_model), generator=gen,
                          device="cuda").to(torch.bfloat16)
    text = torch.randint(0, cfg.vocab_size, (P_REQS, max(P_TEXT_LENS)), generator=gen,
                         device="cuda")
    batch = {"tokens": text, "patch_embeds": patches}
    true_len = torch.tensor([P_PATCHES + n for n in P_TEXT_LENS], dtype=torch.int32,
                            device="cuda")
    want = {"flash_attention": cfg.num_layers, "decode_attention": cfg.num_layers * (P_NEW - 1)}
    toks, counts = generate_path(torch, cfg, params, P_LABEL, batch, true_len, P_NEW,
                                 max_len=P_MAX_LEN, want=want)
    plan = ExecutionPlan(use_kernels=True)
    _, pre, _, _ = greedy_generate(torch, cfg, params, batch, true_len, 1, plan=plan,
                                   max_len=P_MAX_LEN, keep=(0,))
    rows = []
    with torch.no_grad():
        for b, n in enumerate(P_TEXT_LENS):
            fwd, _ = forward(params, cfg, {"tokens": text[b:b + 1, :n],
                                           "patch_embeds": patches[b:b + 1]}, plan=plan)
            rows.append(fwd[0, -1].float())
            del fwd
    compare_logits(torch, P_LABEL, "prefill against each request's forward at its last "
                   "position", pre[0], torch.stack(rows))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want}


# path c's decode checks: (seed, prompt lengths of the rows; the last row
# dead). The first is a four-row stage; the others hold eight rows from
# three seeds.
DECODE_CHECKS = ((1, (320, 257, 130, 64)),) + tuple(
    (seed, (320, 257, 130, 64, 300, 200, 96, 16)) for seed in (1, 2, 3))


@contextlib.contextmanager
def recorded_routes(torch, pins=None):
    """Inside, the duplex MoE layer's router records each call's expert
    choice (top-k indices) and its margin (the k-th minus the (k+1)-th
    probability), its own choice even when pinned. With ``pins`` (an earlier
    run's record, in call order) each call takes the pinned experts
    instead, gated by its own probabilities of them, normalised and masked
    as ``models/moe.py::route`` does."""
    import repro_torch.core.duplex_moe as dm
    route, calls = dm.route, []

    def recording(params, m, x_flat, valid=None):
        out = route(params, m, x_flat, valid)
        probs = torch.softmax(torch.matmul(x_flat.float(), params["router"].float()), dim=-1)
        top = torch.topk(probs, m.top_k + 1, dim=-1).values
        calls.append((out.expert_idx, top[:, -2] - top[:, -1]))
        if pins is None:
            return out
        idx = pins[len(calls) - 1][0]
        gates = probs.gather(-1, idx)
        if m.norm_topk_probs:
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        one_hot = torch.nn.functional.one_hot(idx, m.num_experts)
        if valid is not None:
            gates = torch.where(valid[:, None], gates, torch.zeros_like(gates))
            one_hot = one_hot * valid[:, None, None]
        return out._replace(expert_idx=idx, gates=gates, counts=one_hot.sum(dim=(0, 1)))

    dm.route = recording
    try:
        yield calls
    finally:
        dm.route = route


def check_decode_against_plain(torch, cfg, params, label):
    """One dense decode stage for each of ``DECODE_CHECKS`` (prefills of
    the given lengths, the last row dead) through the kernels (dense decode
    attention, SSD decode, ragged MoE at k_cold 8) and through the plain
    torch path, each on its own copy of the prefilled cache. The plain path
    takes the kernel path's expert choice in every MoE layer
    (``recorded_routes``): where two experts' router probabilities nearly
    tie, bf16 noise upstream may flip the choice, which moves a row's
    logits by several times the band while no kernel is wrong (seen on
    Jamba-v0.1). So both paths compute one function, and every live row's
    logits are held to ``compare_logits``. Each row's top-2 logit gap is printed
    beside its largest difference, and beside that the difference from a
    third run, the plain path on its own expert choice, with the MoE
    layers where that choice differs and the router's margin there: a
    near-tie can be told from a fault."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.params import tree_map
    for seed, lens in DECODE_CHECKS:
        B, S = len(lens), max(lens)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
        true_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        cache = init_cache(cfg, B, 1024, device="cuda")
        with torch.no_grad():
            prefill(params, cfg, {"tokens": toks}, cache, true_len,
                    plan=ExecutionPlan(moe_impl="grouped", use_kernels=True))
        nxt = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device="cuda")
        valid = torch.arange(B, device="cuda") < B - 1
        out, routes = {}, {}
        for path in ("kernels", "plain", "plain, own choice"):
            use_kernels = path == "kernels"
            own = tree_map(cache, lambda t: t.clone())
            plan = ExecutionPlan(moe_impl="duplex", k_cold=8, c_hot=8, c_cold=8,
                                 moe_ragged=use_kernels, use_kernels=use_kernels)
            pins = routes["kernels"] if path == "plain" else None
            with torch.no_grad(), recorded_routes(torch, pins) as calls:
                logits, _, _ = decode_step(params, cfg, nxt, own, {"valid": valid}, plan=plan)
            out[path], routes[path] = logits[:B - 1, 0].float(), calls
        del cache
        a, b, free = out["kernels"], out["plain"], out["plain, own choice"]
        top2 = b.topk(2, dim=-1).values
        rows = []
        for r, (gap, diff, diff_free, same) in enumerate(zip(
                (top2[:, 0] - top2[:, 1]).tolist(), (a - b).abs().amax(-1).tolist(),
                (a - free).abs().amax(-1).tolist(), (a.argmax(-1) == b.argmax(-1)).tolist())):
            ties = [f" MoE layer {i} (router margin {m[r].item():.1e})" for i, ((k, _), (p, m))
                    in enumerate(zip(routes["kernels"], routes["plain, own choice"]))
                    if not torch.equal(k[r].sort().values, p[r].sort().values)]
            rows.append(f"{gap:.4f}/{diff:.4f}/{diff_free:.4f}/{'y' if same else 'n'}"
                        f"{''.join(ties)}")
        log(f"serve [{label}]: decode check seed {seed}, {B - 1} live rows (top-2 gap of the "
            f"plain logits / max |dlogit| / the same against the plain path's own expert "
            f"choice / argmax equal; MoE layers where that choice differs): " + ", ".join(rows))
        compare_logits(torch, label, f"one decode stage (seed {seed}, {B - 1} live rows, "
                       f"the kernel path's expert choice)", a, b)


def short_requests(cfg):
    """The four seeded requests of the short profiled runs: prompts of
    128-256 random tokens, 8 new tokens each."""
    import numpy as np
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(1)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(128, 257))).tolist(),
                    max_new_tokens=8) for i in range(4)]


def profile_stages(torch, cfg, params, label, engine_kw, top: int = 12, loop: str = "run",
                   reqs=None):
    """A short profiled run (by default 4 requests, 8 new tokens each,
    through the engine's ``loop``) in torch.profiler, device activity only
    (each kernel counted once, no host-op events): device time by kernel
    and the device's busy share of the run's host wall time (tracing
    overhead can only inflate the wall time, so the busy share is a lower
    bound)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ServingEngine
    reqs = short_requests(cfg) if reqs is None else reqs
    eng = ServingEngine(cfg, params, device="cuda", **engine_kw)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        getattr(eng, loop)(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_profile(prof, label, f"{len(eng.reports)} stages", wall, top,
                also=("chunk", "decode", "cold"))


def device_totals(prof):
    """{kernel name: [device microseconds, events]} of a CUDA-only profile,
    summed straight from the profiler's raw results."""
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            t = totals.setdefault(e.name(), [0.0, 0])
            t[0] += e.duration_ns() / 1e3
            t[1] += 1
    return totals


def log_profile(prof, label, what, wall, top, also=()):
    """Device time by kernel from a CUDA-only profile, and the device's busy
    share of ``wall`` (host seconds): the ``top`` items, then any other
    whose name holds one of the words in ``also``. The device events are
    summed by name straight from the profiler's raw results: turning a
    20-stage profile's ~170k events into ``FunctionEvent``s and averaging
    them (``prof.key_averages()``) took ~15 s on an H100 host, this loop
    about a second, with the same sums."""
    ranked = sorted(((us, n, name) for name, (us, n) in device_totals(prof).items() if us > 0),
                    reverse=True)
    if not ranked:
        log(f"profile [{label}]: the profiler recorded no device events; no breakdown")
        return
    busy_ms = sum(us for us, _, _ in ranked) / 1e3
    log(f"profile [{label}]: {what} in {wall * 1e3:.1f} ms host wall, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / (wall * 1e3):.1f}%)")
    for i, (us, n, name) in enumerate(ranked):
        if i < top or any(w in name for w in also):
            log(f"profile [{label}]: {us / 1e3:9.2f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
                f"x{n:<6d} {name[:110]}")


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
    the first run's {"launches" {kernel: launches}, "losses", "median" step
    time, "peak" memory}; raises if a check fails."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch.train import make_step
    from repro_torch.training.data import DataConfig, SyntheticLMData
    from repro_torch.training.optimizer import OptConfig
    full, cfg = olmoe_cut(TRAIN_LAYERS)
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
        runs.append(train_run(torch, cfg, full, opt, step_fn, batch_fn,
                              f"{TRAIN_LABEL} run {run + 1}"))
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
    return dict(launches={k: runs[0]["launches"][k] for k in TRAIN_KERNELS},
                **{k: runs[0][k] for k in ("losses", "median", "peak")})


def train_run(torch, cfg, full, opt, step_fn, batch_fn, label, steps=TRAIN_STEPS,
              tokens=TRAIN_BATCH * TRAIN_SEQ, watch_layer=0, card=""):
    """One training run from fresh seed-0 weights of ``cfg`` (``full`` cut
    in depth): ``steps`` steps of ``tokens`` tokens through ``train_loop``,
    each timed to a device sync, the launch counts set to 0 just before the
    loop and read just after. Checks that each flash kernel launched once a
    layer a step (the forward twice under full remat), finite losses and
    grad norms, and that ``watch_layer``'s wq moved; returns {state,
    launches, losses, median, peak}. Path d's values are the defaults."""
    from repro_torch.kernels import build
    from repro_torch.models.params import init_model, tree_leaves
    from repro_torch.training.loop import LoopConfig, train_loop
    from repro_torch.training.train_state import make_train_state
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

    watch = state["params"]["segments"][0]["blocks"][watch_layer]["mixer"]["wq"]["kernel"]
    before = watch.detach().clone()
    build.reset_launch_counts()
    loop = train_loop(state, timed_step, batch_fn, LoopConfig(total_steps=steps,
                                                              log_every=1), log=log)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    times = [r[0] for r in record]
    losses = [float(r[1]) for r in record]
    norms = [float(r[2]) for r in record]
    med = sorted(times)[len(times) // 2]
    on = f" on {card}" if card else ""
    log(f"train [{label}]: {loop.step} steps of {tokens} tokens{on}, remat={TRAIN_REMAT}; "
        f"losses {losses}; grad norms {[round(x, 4) for x in norms]}; "
        f"lr {[r[3] for r in record]}; step times (s) {[round(x, 4) for x in times]}, median "
        f"{med:.4f} s, {tokens / med:.0f} tokens/s; stragglers={loop.stragglers}; peak "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"train [{label}]: kernel launches on the path: {json.dumps(launches)}")
    fwd_per_layer = 2 if TRAIN_REMAT == "full" else 1   # the recompute runs the forward again
    want = {"flash_attention": cfg.num_layers * steps * fwd_per_layer,
            "flash_attention_bwd": cfg.num_layers * steps}
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if bad:
        raise AssertionError(f"[{label}] launches (got, want): {bad}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"[{label}] non-finite loss or grad norm")
    if torch.equal(before, watch.detach()):
        raise AssertionError(f"[{label}] the parameters did not move")
    return dict(state=state, launches=launches, losses=losses, median=med, peak=peak)


def check_train_against_plain(torch, cfg, params, batch, label=TRAIN_LABEL, layers=(0,),
                              chains=(False,)):
    """The loss and the gradients of the attention projections of
    ``layers`` (of the first segment's pattern) from the same parameters and
    batch through the kernels and through the plain path
    (``use_kernels=False``), for each setting of the bf16 score chain in
    ``chains``: the loss within 1e-2 relative, each gradient within 5e-2 of
    its largest entry (bf16 activations, summed in other orders by the two
    paths' attention). With both settings, the kernels' response to the
    flag (K1 - K0, each layer's gradients with the chain less those
    without) must point the way of the plain path's at the kernel's key
    tiles (T1 - T0; ``key_tile``): cosine over CHAIN_COS. Printed beside
    it: the loss of each run, each layer's ``chain_gate`` readings against
    T1 and T0, and those against the plain path at 512-key blocks."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models.model import loss_fn
    names = ("wq", "wk", "wv", "wo")
    leaves = [(i, n) for i in layers for n in names]
    blocks = params["segments"][0]["blocks"]

    def step(use_kernels, chain, **tiles):
        plan = ExecutionPlan(moe_impl="grouped", use_kernels=use_kernels,
                             attn_score_bf16=chain, **tiles)
        loss, _ = loss_fn(params, cfg, batch, plan=plan, remat=TRAIN_REMAT)
        grads = torch.autograd.grad(loss, [blocks[i]["mixer"][n]["kernel"] for i, n in leaves])
        return loss.item(), [g[0].float() for g in grads]

    runs = {(k, c): step(k, c) for k in (True, False) for c in chains}
    bad = []
    for chain in chains:
        (lk, gk), (lp, gp) = runs[True, chain], runs[False, chain]
        rel = abs(lk - lp) / abs(lp)
        errs = [((a - b).abs().max().item(), b.abs().max().item()) for a, b in zip(gk, gp)]
        what = ", bf16 score chain" if chain else ""
        log(f"train [{label}]: kernels vs plain path on one step{what}: loss {lk:.5f} vs "
            f"{lp:.5f} (rel {rel:.2e}, tolerance 1e-2); attention gradients "
            + ", ".join(f"layer {i} {n}: max|d|={e:.3e} of max|g|={m:.3e}"
                        for (i, n), (e, m) in zip(leaves, errs))
            + " (tolerance 5e-2 x max|g|)")
        if not math.isfinite(lk) or rel > 1e-2 or any(e > 5e-2 * m for e, m in errs):
            bad.append(f"kernel path disagrees with the plain path{what}")
    if set(chains) == {False, True}:
        tile = key_tile(torch, getattr(torch, cfg.dtype), cfg.resolved_head_dim)
        for c in (True, False):
            runs["tile", c] = step(False, c, attn_q_block=tile, attn_kv_block=tile)
        flat = lambda key: [torch.cat([g.flatten() for (i, _), g in zip(leaves, runs[key][1])
                                       if i == layer]) for layer in layers]
        k1, k0, t1, t0, p1, p0 = (flat(key) for key in ((True, True), (True, False),
                                                       ("tile", True), ("tile", False),
                                                       (False, True), (False, False)))
        names = [f"layer {i} gradients" for i in layers]
        resp, cos = [], []
        for i, a1, a0, b1, b0, c1, c0 in zip(layers, k1, k0, t1, t0, p1, p0):
            dk, dt, dp = a1 - a0, b1 - b0, c1 - c0
            cos.append((dk * dt).sum().item() / max((dk.norm() * dt.norm()).item(), 1e-30))
            cos_p = (dk * dp).sum().item() / max((dk.norm() * dp.norm()).item(), 1e-30)
            resp.append(f"layer {i} cosine {cos[-1]:.3f} ({cos_p:.3f} against P1 - P0)")
        ok = all(c > CHAIN_COS for c in cos)
        log(f"train [{label}]: bf16 score chain through the kernels (K1; K0 without) against "
            f"the plain path at {tile}-key blocks (T1, T0) and at 512 (P1, P0): loss "
            f"{runs[True, True][0]:.5f} vs T1 {runs['tile', True][0]:.5f}, T0 "
            f"{runs['tile', False][0]:.5f}, P1 {runs[False, True][0]:.5f}, P0 "
            f"{runs[False, False][0]:.5f}; against T: {chain_gate(k1, t1, t0, names)[1]}; "
            f"against P: {chain_gate(k1, p1, p0, names)[1]}; response K1 - K0 against "
            f"T1 - T0: " + ", ".join(resp) + f" (gate cosine > {CHAIN_COS}) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            bad.append("the kernels do not respond to the score chain as the plain path does")
    if bad:
        raise AssertionError(f"[{label}] {'; '.join(bad)}")


def profile_train_step(torch, step_fn, state, batch, top: int = 12, label=TRAIN_LABEL,
                       card=""):
    """One more step under torch.profiler (device activity only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    what = "one training step" + (f" on {card}" if card else "")
    log_profile(prof, label, what, wall, top, also=("flash", "index"))


# path s: gemma3-4b trained at full width (d_model 2560, head_dim 256, 8
# heads over 4, d_ff 10240, a 262144-token vocabulary, window 1024, qk-norm,
# tied embeddings) and one period of its 34 layers, 5 local and 1 global:
# the whole model's ~3.9B parameters need ~47 GB of bf16 weights and
# gradients and float32 AdamW moments before activations, and the smoke's
# time is nearly spent
S_LABEL = "gemma3-4b training"
S_STEPS = 3
S_BATCH, S_SEQ = 2, 2048               # past the 512-row q block: the flash core runs
S_CHECK_LAYERS = (0, 5)                # a local layer and the global one


def gemma_train_phase(torch, card):
    """Path s: ``make_step`` (the trainer's default plan: the flash kernels,
    here their head_dim-256 plans) driven by ``train_run`` on gemma3-4b at
    full width and one period of its layers, random weights from seed 0,
    ``SyntheticLMData`` batches (seed 0, S_BATCH x S_SEQ), S_STEPS steps, no
    remat. Then one step's loss and the attention gradients of layers 0
    (local) and 5 (global) through the kernels against the plain path,
    without and with the bf16 score chain, and one profiled step's device
    time by kernel beside the card. Returns {kernel: launches}."""
    from repro_torch.configs import RunConfig, resolve_config
    from repro_torch.configs.base import Segment
    from repro_torch.launch.train import make_step
    from repro_torch.training.data import DataConfig, SyntheticLMData
    from repro_torch.training.optimizer import OptConfig
    full = resolve_config("gemma3-4b")
    period = full.segments[0].pattern
    cfg = dataclasses.replace(full, num_layers=len(period),
                              segments=(Segment(period, 1),)).validate()
    opt = OptConfig(learning_rate=1e-3, total_steps=S_STEPS,
                    warmup_steps=max(S_STEPS // 10, 1))
    data = SyntheticLMData(DataConfig(cfg.vocab_size, S_SEQ, S_BATCH, seed=0))
    batch_fn = lambda step: {"tokens": torch.from_numpy(data.batch_at(step)["tokens"]).cuda()}
    n_local = sum(k.mixer != "attn" for k in cfg.layer_kinds())
    log(f"train [{S_LABEL}]: {cfg.name} at full width (d_model {cfg.d_model}, head_dim "
        f"{cfg.resolved_head_dim}, {cfg.num_heads} heads over {cfg.num_kv_heads}, window "
        f"{cfg.sliding_window}), {n_local} local and {cfg.num_layers - n_local} global layers")
    step_fn = make_step(cfg, opt, RunConfig(remat_policy=TRAIN_REMAT))
    run = train_run(torch, cfg, full, opt, step_fn, batch_fn, S_LABEL, steps=S_STEPS,
                    tokens=S_BATCH * S_SEQ, watch_layer=S_CHECK_LAYERS[-1], card=card)
    state, batch = run["state"], batch_fn(S_STEPS)
    check_train_against_plain(torch, cfg, state["params"], batch, S_LABEL, S_CHECK_LAYERS,
                              chains=(False, True))
    profile_train_step(torch, step_fn, state, batch, label=S_LABEL, card=card)
    return {k: run["launches"][k] for k in TRAIN_KERNELS}


# path d2: checkpoints and resume. OLMoE-1B-7B at full width cut to one
# layer (every layer is the same attention + 64-expert MoE block, stacked
# under a leading layer dim all the same): the embedding and LM head (2 x
# 103M) and the layer (419.6M) make 0.626B parameters, 10 bytes each in a
# checkpoint (bf16 parameters, float32 mu and nu; the gradients are not
# state). The path's time is its checkpoint writes and reads, which scale
# with the state; at 2 layers it took 162 s of the smoke's time limit
RESUME_LABEL = "olmoe resume"
RESUME_LAYERS = 1
RESUME_STEPS = 6
RESUME_EVERY = 2
RESUME_KEEP = 2
RESUME_SIGNAL_STEP = 3         # R2 sends itself SIGTERM during its third step
RESUME_OTHER_SEED = 1          # R3's weights before the restore
# path d3: remat on path d's configuration
REMAT_LABEL = "olmoe remat"
REMAT_STEPS = 3


def olmoe_cut(layers):
    from repro_torch.configs import resolve_config
    from repro_torch.configs.base import Segment
    full = resolve_config("olmoe-1b-7b")
    return full, dataclasses.replace(full, num_layers=layers, segments=(
        Segment(full.segments[0].pattern, layers),)).validate()


def states_equal(torch, a, b) -> bool:
    """Two trees of tensors and ints hold the same values, bit for bit."""
    from repro_torch.models.params import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def writer_busy() -> bool:
    """Whether an ``AsyncCheckpointer`` write is in flight."""
    import threading
    from repro_torch.training.checkpoint import AsyncCheckpointer
    return any(t.name == AsyncCheckpointer.THREAD_NAME and t.is_alive()
               for t in threading.enumerate())


def resume_phase(torch):
    """Path d2: three runs of ``train_loop`` with async keep-2 checkpoints
    every 2 steps on OLMoE-1B-7B at full width and RESUME_LAYERS layers,
    seq 2048 x batch 4, 6 steps, ``SyntheticLMData`` seed 0. R1 runs
    uninterrupted from seed-0 weights; R2, from the same weights, sends
    itself SIGTERM (from the main thread) during step 3, so it checkpoints
    at step 3 and stops; R3 starts from seed-1 weights, restores step 3 and
    runs to step 6. Gates: R2's losses then R3's equal R1's bit for bit,
    R3's final parameters and optimizer state ``torch.equal`` to R1's,
    ``list_checkpoints`` honours keep, one leaf of the card's checkpoint
    restores on the CPU with equal bits, and R3's restore (into its state's
    tensors) raises the allocator's peak by under a twentieth of the state,
    i.e. makes no second copy of it. Logs the free disk
    (raises under (keep + 1) checkpoints' bytes), the bytes written, the
    seconds of a sync save, of an async save's snapshot and of its write,
    of a restore, and the median step with an async write in flight
    against without one. The checkpoint directory goes at the end, and
    when the path fails. Returns {kernel: launches a run} of R1."""
    import shutil
    import signal
    import tempfile
    from repro_torch.configs import RunConfig
    from repro_torch.kernels import build
    from repro_torch.launch.train import make_step
    from repro_torch.models.params import DTYPES, init_model, model_specs, tree_leaves
    from repro_torch.training.checkpoint import (list_checkpoints, restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.data import DataConfig, SyntheticLMData
    from repro_torch.training.loop import LoopConfig, train_loop
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_state import make_train_state
    full, cfg = olmoe_cut(RESUME_LAYERS)
    opt = OptConfig(learning_rate=1e-3, total_steps=RESUME_STEPS,
                    warmup_steps=max(RESUME_STEPS // 10, 1))
    data = SyntheticLMData(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    batch_fn = lambda step: {"tokens": torch.from_numpy(data.batch_at(step)["tokens"]).cuda()}
    step_fn = make_step(cfg, opt, RunConfig(remat_policy="none"))
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        def run(label, seed, ckpt_dir, signal_at=None):
            state = make_train_state(init_model(cfg, seed=seed, device="cuda"), opt)
            torch.cuda.synchronize()
            steps, last = [], {}
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()

            def step(state, batch):
                n = state["step"] + 1
                if not steps:               # the restore's (if any) and a batch's peak
                    last["lead_rise"] = torch.cuda.max_memory_allocated() - base
                if n == signal_at:
                    handler = signal.getsignal(signal.SIGTERM)
                    if not getattr(handler, "__qualname__", "").startswith("train_loop"):
                        raise AssertionError(f"[{label}] the loop's SIGTERM handler is not "
                                             f"installed: {handler!r}")
                    os.kill(os.getpid(), signal.SIGTERM)
                busy = writer_busy()
                t = time.perf_counter()
                state, m = step_fn(state, batch)
                torch.cuda.synchronize()
                steps.append((n, time.perf_counter() - t, busy, t, time.perf_counter()))
                last["state"] = state
                return state, m

            build.reset_launch_counts()
            t = time.perf_counter()
            loop = train_loop(state, step, batch_fn, LoopConfig(
                total_steps=RESUME_STEPS, ckpt_dir=ckpt_dir, ckpt_every=RESUME_EVERY,
                keep=RESUME_KEEP, async_ckpt=True, log_every=1), log=log)
            wall = time.perf_counter() - t
            # the loop's start to its first step: the restore (if any) and a
            # batch; its last step's end to its return: the wait for the
            # write still in flight, then the last boundary's snapshot and
            # write, which the loop waits for
            last["lead_s"], last["tail_s"] = steps[0][3] - t, t + wall - steps[-1][4]
            launches = {k: build.launch_counts[k] for k in TRAIN_KERNELS}
            log(f"train [{label}]: steps {[s[0] for s in steps]} in {wall:.2f} s with its "
                f"saves; losses {loop.losses}; step times (s) "
                f"{[round(s[1], 4) for s in steps]}, a write in flight at "
                f"{[s[0] for s in steps if s[2]]}; interrupted={loop.interrupted}; "
                f"checkpoints {list_checkpoints(ckpt_dir)}; launches {launches}")
            if not all(math.isfinite(x) for x in loop.losses):
                raise AssertionError(f"[{label}] non-finite loss")
            if launches != {k: RESUME_LAYERS * len(steps) for k in TRAIN_KERNELS}:
                raise AssertionError(f"[{label}] launches {launches}")
            return loop, last, steps, launches

        specs = tree_leaves(model_specs(cfg))
        n_params = sum(math.prod(s.shape) for s in specs)
        state_bytes = sum(math.prod(s.shape) * (DTYPES[s.dtype].itemsize + 8) for s in specs)
        free = shutil.disk_usage(root).free
        need = (RESUME_KEEP + 1) * state_bytes
        log(f"train [{RESUME_LABEL}]: {cfg.name} cut to {cfg.num_layers} of {full.num_layers} "
            f"layers, {n_params / 1e9:.3f}B parameters, {state_bytes / 1e9:.2f} GB of "
            f"checkpointed state (bf16 parameters, float32 mu and nu); free disk at the "
            f"checkpoint directory {free / 1e9:.1f} GB, needs (keep + 1) x state = "
            f"{need / 1e9:.1f} GB")
        if free < need:
            raise AssertionError(f"[{RESUME_LABEL}] {free / 1e9:.1f} GB free, the path "
                                 f"needs {need / 1e9:.1f} GB")
        d1, d2 = os.path.join(root, "r1"), os.path.join(root, "r2")
        r1, last1, steps1, launches = run(f"{RESUME_LABEL} R1", 0, d1)
        final1 = last1["state"]
        kept = list_checkpoints(d1)
        written = os.path.getsize(os.path.join(d1, f"step_{kept[-1]:08d}", "state.npz"))
        # one sync save of R1's final state (step 7)
        t = time.perf_counter()
        save_checkpoint(d1, RESUME_STEPS + 1, final1, keep=RESUME_KEEP)
        sync_s = time.perf_counter() - t
        # R1's async saves: the caller's snapshot is the gap after step 2 less
        # the gap after step 1 (a batch alone); the loop's tail holds the
        # rest of step 4's write and all of step 6's save
        gap = lambda n: steps1[n][3] - steps1[n - 1][4]
        snap_s = gap(RESUME_EVERY) - gap(RESUME_EVERY - 1)
        log(f"train [{RESUME_LABEL}]: a checkpoint is {written} bytes; sync save "
            f"{sync_s:.2f} s ({written / sync_s / 1e9:.2f} GB/s); async save: the "
            f"caller's snapshot {snap_s:.2f} s; the loop's tail after step "
            f"{RESUME_STEPS} (the rest of the write before, then this save) "
            f"{last1['tail_s']:.2f} s")
        if list_checkpoints(d1) != [RESUME_STEPS, RESUME_STEPS + 1]:
            raise AssertionError(f"[{RESUME_LABEL}] checkpoints {list_checkpoints(d1)}")
        shutil.rmtree(d1)
        r2, _, steps2, _ = run(f"{RESUME_LABEL} R2", 0, d2, signal_at=RESUME_SIGNAL_STEP)
        if not r2.interrupted or list_checkpoints(d2) != [RESUME_EVERY, RESUME_SIGNAL_STEP]:
            raise AssertionError(f"[{RESUME_LABEL} R2] interrupted={r2.interrupted}, "
                                 f"checkpoints {list_checkpoints(d2)}")
        r3, last3, steps3, _ = run(f"{RESUME_LABEL} R3", RESUME_OTHER_SEED, d2)
        final3 = last3["state"]
        equal_params = states_equal(torch, final3["params"], final1["params"])
        equal_opt = states_equal(torch, final3["opt"], final1["opt"])
        kept = list_checkpoints(d2)
        leaf = final3["params"]["embed"]["table"]
        cpu, _ = restore_checkpoint(d2, {"params": {"embed": {"table": torch.empty(
            leaf.shape, dtype=leaf.dtype, device="meta")}}}, device="cpu")
        cpu = cpu["params"]["embed"]["table"]
        cpu_equal = cpu.device.type == "cpu" and torch.equal(cpu, leaf.detach().cpu())
        rise = last3["lead_rise"]
        log(f"train [{RESUME_LABEL}]: R3's restore (into its state's tensors) and first "
            f"batch raised the allocator's peak by {rise / 2**20:.1f} MiB over the "
            f"{state_bytes / 1e9:.2f} GB of state it restored")
        if rise > state_bytes / 20:
            raise AssertionError(f"[{RESUME_LABEL}] the restore raised the peak by {rise} "
                                 f"bytes: a second copy of the state")
        busy = [s[1] for s in steps1[1:] + steps2[1:] + steps3[1:] if s[2]]
        idle = [s[1] for s in steps1[1:] + steps2[1:] + steps3[1:] if not s[2]]
        med = lambda xs: sorted(xs)[len(xs) // 2] if xs else float("nan")
        log(f"train [{RESUME_LABEL}]: R2 + R3 losses equal R1's at every step: "
            f"{r2.losses + r3.losses == r1.losses}; R3's final parameters equal R1's: "
            f"{equal_params}, optimizer state: {equal_opt}; checkpoints kept {kept} "
            f"(keep {RESUME_KEEP}); the embedding of the newest restored on the CPU "
            f"equal to the card's: {cpu_equal}; R3's restore of step {RESUME_SIGNAL_STEP} "
            f"onto the card (and one batch) {last3['lead_s']:.2f} s, a warm read (the file "
            f"was just written); median step (each run's first left out) "
            f"with a write in flight {med(busy):.4f} s over {len(busy)}, without "
            f"{med(idle):.4f} s over {len(idle)}")
        if r2.losses + r3.losses != r1.losses or not (equal_params and equal_opt):
            raise AssertionError(f"[{RESUME_LABEL}] the resumed run departs from R1: "
                                 f"{r2.losses} + {r3.losses} vs {r1.losses}")
        if kept != [RESUME_STEPS - RESUME_EVERY, RESUME_STEPS] or not cpu_equal:
            raise AssertionError(f"[{RESUME_LABEL}] checkpoints {kept}, CPU leaf equal "
                                 f"{cpu_equal}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def remat_phase(torch, path_d):
    """Path d3: path d's configuration and data (TRAIN_LAYERS layers, 4 x
    2048, seed 0, path d's optimizer) for REMAT_STEPS steps under
    ``remat="dots"`` and ``remat="full"``, each from fresh seed-0 weights,
    the previous run's state freed first. Gates: each run's losses equal
    path d's first REMAT_STEPS losses bit for bit (remat changes no
    arithmetic: the CPU tests show "dots" and "full" equal to "none" in
    loss and every gradient), and each flash kernel's launches: the
    forward twice a layer a step (the recompute runs it again in the
    backward), the backward once. Logs, beside path d's ("none"), the
    median step, the peak memory and the launches a step."""
    from repro_torch.configs import RunConfig
    from repro_torch.kernels import build
    from repro_torch.launch.train import make_step
    from repro_torch.models.params import init_model
    from repro_torch.training.data import DataConfig, SyntheticLMData
    from repro_torch.training.loop import LoopConfig, train_loop
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_state import make_train_state
    full, cfg = olmoe_cut(TRAIN_LAYERS)
    opt = OptConfig(learning_rate=1e-3, total_steps=TRAIN_STEPS,
                    warmup_steps=max(TRAIN_STEPS // 10, 1))
    data = SyntheticLMData(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    batch_fn = lambda step: {"tokens": torch.from_numpy(data.batch_at(step)["tokens"]).cuda()}
    rows = {"none": dict(median=path_d["median"], peak=path_d["peak"],
                         fwd=path_d["launches"]["flash_attention"] / TRAIN_STEPS,
                         bwd=path_d["launches"]["flash_attention_bwd"] / TRAIN_STEPS)}
    for remat in ("dots", "full"):
        label = f"{REMAT_LABEL} {remat}"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = make_train_state(init_model(cfg, seed=0, device="cuda"), opt)
        step_fn = make_step(cfg, opt, RunConfig(remat_policy=remat))
        times = []

        def step(state, batch):
            t = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            return state, m

        build.reset_launch_counts()
        loop = train_loop(state, step, batch_fn, LoopConfig(total_steps=REMAT_STEPS,
                                                            log_every=1), log=log)
        torch.cuda.synchronize()
        fwd, bwd = (build.launch_counts[k] for k in TRAIN_KERNELS)
        rows[remat] = dict(median=sorted(times)[len(times) // 2],
                           peak=torch.cuda.max_memory_allocated(), fwd=fwd / REMAT_STEPS,
                           bwd=bwd / REMAT_STEPS)
        want = path_d["losses"][:REMAT_STEPS]
        log(f"train [{label}]: losses {loop.losses} (path d's {want}); step times (s) "
            f"{[round(x, 4) for x in times]}")
        if loop.losses != want:
            raise AssertionError(f"[{label}] losses {loop.losses} differ from path d's {want}")
        if (fwd, bwd) != (2 * TRAIN_LAYERS * REMAT_STEPS, TRAIN_LAYERS * REMAT_STEPS):
            raise AssertionError(f"[{label}] flash launches (forward, backward) {fwd, bwd}")
        del state, loop
    for remat, r in rows.items():
        log(f"train [{REMAT_LABEL}]: remat={remat}: median step {r['median']:.4f} s, "
            f"{TRAIN_BATCH * TRAIN_SEQ / r['median']:.0f} tokens/s, peak memory "
            f"{r['peak'] / 2**30:.2f} GiB, flash forward {r['fwd']:g} and backward "
            f"{r['bwd']:g} launches a step")


# path q: the sharded step builders (``launch/steps.py``) on a one-rank NCCL
# mesh at OLMoE-1B-7B's full width, the dry run of the same three steps in a
# fake one-rank group, and one production cell of the dry run. No step runs
# a kernel (the reference's steps run ``use_kernels=False``). Shapes not in
# the cell grid's ``SHAPES``, each listed as reduced on its line:
Q_LABEL = "steps"
Q_TRAIN = dict(layers=TRAIN_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=3)  # path d's
Q_PREFILL = (1, 8192)                    # (batch, seq) at full depth
# the flash core's tiles of the prefill step, its dry run and its unsharded
# twin: the grid's prefill_32k tiles (at 512 the trace took ~45 s of the smoke)
Q_PREFILL_TILE = 4096
Q_DECODE = (16, 4096)                    # rows over a cache of this many positions
Q_CELL = ("olmoe-1b-7b", "decode_32k")   # the quickest OLMoE cell of the CPU grid
Q_PEAK_BAND = 0.25                       # predicted vs measured per-device peak
Q_ROOF_MAX = 1.05                        # a roofline fraction past this is a miscount


def q_measure(torch, fn, *args, profiled=False):
    """``fn(*args)`` once: its outputs, the step's per-device peak (the bytes
    of its arguments' storages plus what the step allocated over what was
    allocated when it began: the quantity the dry run predicts) and, with
    ``profiled``, the device's summed kernel time from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.op_cost import storage_bytes
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) if profiled else \
            contextlib.nullcontext() as prof:
        out = fn(*args)
        torch.cuda.synchronize()
    peak = storage_bytes(args) + torch.cuda.max_memory_allocated() - before
    device_ms = 0.0
    if profiled:
        device_ms = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                        if str(e.device_type()).endswith("CUDA")) / 1e6
    return out, peak, device_ms


def q_train_run(torch, cfg, opt, batch_fn, step_fn, steps, sharded):
    """``steps`` steps from fresh seed-0 weights (``make_train_state``); with
    ``sharded`` the state and batches are DTensors on the one-rank mesh.
    Returns (losses, the first step's peak, the last step's device ms)."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.params import init_model, tree_leaves
    from repro_torch.training.train_state import make_train_state
    state = make_train_state(init_model(cfg, seed=0, device="cuda"), opt)
    if sharded:
        state = tsteps.distribute_tree(state, sharded["in_pl"][0], sharded["mesh"])
        for leaf in tree_leaves(state["params"]):
            leaf.requires_grad_(True)
    losses, peak, device_ms = [], 0, 0.0
    for step in range(steps):
        batch = batch_fn(step)
        if sharded:
            batch = tsteps.distribute_tree(batch, sharded["in_pl"][1], sharded["mesh"])
        (state, m), p, ms = q_measure(torch, step_fn, state, batch,
                                      profiled=step == steps - 1)
        loss = m["loss"]
        losses.append(float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss))
        peak, device_ms = (p, device_ms) if step == 0 else (peak, ms)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return losses, peak, device_ms


def q_trace(torch, cfg, shape, run, opt=None):
    """The dry run of one step in a fake one-rank group: the walker's cost,
    the memory record and the roofline terms at the H100's constants."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dryrun import fake_group, memory_dict, stand_ins, trace_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import model_bytes, model_flops, terms_from_cost
    from repro_torch.launch.steps import make_cell_step
    with fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        fn, specs, in_pl, _, meta = make_cell_step(cfg, shape, mesh, run, opt)
        with FakeTensorMode():
            args = stand_ins(meta, specs, in_pl, mesh)
            out, mode, _, secs = trace_step(fn, args, sites=False, flop_counter=False)
            mem = memory_dict(args, out, mode)
    terms = terms_from_cost(mode.cost, 1, model_fl=model_flops(cfg, shape),
                            model_by=model_bytes(cfg, shape))
    return mode.cost, mem, terms, secs


def q_check_trace(torch, card, rec):
    """The dry run of a step the card ran (``rec``: what, cfg, shape, run,
    opt, the measured peak and device ms), printed beside the card's run:
    the predicted peak must be within ``Q_PEAK_BAND`` of the measured one
    and the roofline fraction finite and at most ``Q_ROOF_MAX``."""
    cost, mem, terms, secs = q_trace(torch, rec["cfg"], rec["shape"], rec["run"],
                                     rec.get("opt"))
    what, measured, device_ms = rec["what"], rec["peak"], rec["device_ms"]
    pred = mem["peak_size_in_bytes"]
    rel = abs(pred - measured) / measured
    frac = terms.roofline_fraction
    log(f"{Q_LABEL} [{what}] ({card}): dry run (fake one-rank group, traced in {secs:.1f} s "
        f"on the host): {cost.ops} ops, {cost.flops:.4e} FLOPs, {cost.bytes:.4e} bytes, "
        f"collectives {cost.collective_bytes:.0f} bytes; predicted peak {pred / 2**30:.3f} GiB "
        f"(arguments {mem['argument_size_in_bytes'] / 2**30:.3f} + temp "
        f"{mem['temp_size_in_bytes'] / 2**30:.3f}) against the card's "
        f"{measured / 2**30:.3f} GiB (arguments + torch.cuda.max_memory_allocated over the "
        f"step's start; {100 * rel:.1f}%, band {100 * Q_PEAK_BAND:.0f}%); t_ideal "
        f"{terms.t_ideal * 1e3:.3f} ms at the H100's constants beside the step's device time "
        f"{device_ms:.3f} ms (torch.profiler); t_bound {terms.t_bound * 1e3:.3f} ms "
        f"({terms.dominant}), roofline_fraction {frac:.4f}")
    if rel > Q_PEAK_BAND:
        raise AssertionError(f"[{Q_LABEL} {what}] predicted peak {pred} vs measured "
                             f"{measured}: {rel:.3f} > {Q_PEAK_BAND}")
    if not math.isfinite(frac) or frac > Q_ROOF_MAX:
        raise AssertionError(f"[{Q_LABEL} {what}] roofline_fraction {frac} (at most "
                             f"{Q_ROOF_MAX}): the floor's count is wrong")


def q_train(torch, mesh, card):
    """Three ``make_train_step`` steps at n_micro 1 and 2 against three of
    ``launch/train.py::make_step`` under the same plan, each from seed-0
    weights: every loss within path d's band (1e-2 relative). Returns the
    record of the n_micro 1 run for its dry run."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.train import make_step
    from repro_torch.training.data import DataConfig, SyntheticLMData
    from repro_torch.training.optimizer import OptConfig
    _, cfg = olmoe_cut(Q_TRAIN["layers"])
    B, S, n = Q_TRAIN["batch"], Q_TRAIN["seq"], Q_TRAIN["steps"]
    shape = ShapeConfig(f"train_{B}x{S}", "train", S, B)
    opt = OptConfig(learning_rate=1e-3, total_steps=n, warmup_steps=max(n // 10, 1))
    data = SyntheticLMData(DataConfig(cfg.vocab_size, S, B, seed=0))
    batch_fn = lambda step: {"tokens": torch.from_numpy(data.batch_at(step)["tokens"]).cuda()}
    runs = {}
    for n_micro in (1, 2):
        run = RunConfig(remat_policy=TRAIN_REMAT, microbatch_size=B // n_micro)
        fn, _, in_pl, _, got, _ = tsteps.make_train_step(cfg, shape, mesh, run, opt)
        assert got == n_micro, (got, n_micro)
        runs[n_micro] = q_train_run(torch, cfg, opt, batch_fn, fn, n,
                                    {"in_pl": in_pl, "mesh": mesh})
    plan = ExecutionPlan(moe_impl="grouped", use_kernels=False)
    step_fn = make_step(cfg, opt, RunConfig(remat_policy=TRAIN_REMAT), plan=plan)
    plain = q_train_run(torch, cfg, opt, batch_fn, step_fn, n, None)
    what = (f"train {cfg.name} {cfg.num_layers} of 16 layers, {B} x {S} (reduced: not in "
            f"SHAPES), remat={TRAIN_REMAT}")
    for n_micro, (losses, peak, device_ms) in runs.items():
        diffs = [abs(a - b) / abs(b) for a, b in zip(losses, plain[0])]
        log(f"{Q_LABEL} [{what}] ({card}): make_train_step n_micro {n_micro} losses {losses} "
            f"vs make_step {plain[0]}; largest relative difference {max(diffs):.3e} "
            f"(band 1e-2); first step's peak {peak / 2**30:.3f} GiB, last step's device "
            f"time {device_ms:.1f} ms")
        if not all(math.isfinite(x) for x in losses) or max(diffs) > 1e-2:
            raise AssertionError(f"[{Q_LABEL} train n_micro {n_micro}] losses depart from "
                                 f"make_step's: {losses} vs {plain[0]}")
    return dict(what=what + ", n_micro 1", cfg=cfg, shape=shape, opt=opt,
                run=RunConfig(remat_policy=TRAIN_REMAT, microbatch_size=B),
                peak=runs[1][1], device_ms=runs[1][2])


def q_serve(torch, mesh, card):
    """The prefill step (1 x 8192, flash tiles of ``Q_PREFILL_TILE``) and the
    serve step (16 rows over a cache of 4096, ``duplex_k_cold``'s plan) at
    full depth against the unsharded ``prefill`` / ``decode_step`` on the
    same weights, inputs and tiles: equal next tokens. Returns the two
    steps' records for their dry runs."""
    import numpy as np
    from repro_torch.configs import resolve_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.params import init_model
    cfg = resolve_config("olmoe-1b-7b")
    params = init_model(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(7)
    run = RunConfig()
    recs = []
    # prefill: 1 x 8192 into a fresh cache, at the grid's prefill tiles
    B, S = Q_PREFILL
    shape = ShapeConfig(f"prefill_{B}x{S}", "prefill", S, B)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    run_p = RunConfig(attn_q_block=Q_PREFILL_TILE, attn_kv_block=Q_PREFILL_TILE)
    fn, _, in_pl, _, _ = tsteps.make_prefill_step(cfg, shape, mesh, run_p)
    p_dt = tsteps.distribute_tree(params, in_pl[0], mesh)
    true_len = torch.full((B,), S, dtype=torch.int32, device="cuda")
    batch = tsteps.distribute_tree({"tokens": toks, "true_len": true_len}, in_pl[1], mesh)
    with torch.no_grad():
        (tok_s, cache_s), peak, dev_ms = q_measure(torch, fn, p_dt, batch, profiled=True)
        tok_s = tok_s.full_tensor()
        del cache_s
        cache = init_cache(cfg, B, S, device="cuda")
        logits, cache = prefill(params, cfg, {"tokens": toks}, cache, true_len,
                                plan=ExecutionPlan(use_kernels=False,
                                                   attn_q_block=Q_PREFILL_TILE,
                                                   attn_kv_block=Q_PREFILL_TILE))
        tok_u = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        del cache, logits
    what = (f"prefill {cfg.name} full depth, {B} x {S} (reduced: not in SHAPES), flash "
            f"tiles {Q_PREFILL_TILE}")
    log(f"{Q_LABEL} [{what}] ({card}): make_prefill_step next tokens {tok_s.tolist()} vs "
        f"prefill {tok_u.tolist()}; device time {dev_ms:.1f} ms, peak {peak / 2**30:.3f} GiB")
    if not torch.equal(tok_s, tok_u):
        raise AssertionError(f"[{Q_LABEL} prefill] next tokens differ")
    recs.append(dict(what=what, cfg=cfg, shape=shape, run=run_p, peak=peak, device_ms=dev_ms))
    gc.collect()
    torch.cuda.empty_cache()
    # decode: 16 rows over a 4096-position cache filled by an unsharded prefill
    B, S = Q_DECODE
    shape = ShapeConfig(f"decode_{B}x{S}", "decode", S, B)
    lens = rng.integers(S // 4, S - 1, B).astype(np.int32)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    with torch.no_grad():
        cache = init_cache(cfg, B, S, device="cuda")
        logits, cache = prefill(params, cfg, {"tokens": toks}, cache,
                                torch.from_numpy(lens).cuda(),
                                plan=ExecutionPlan(use_kernels=False))
        first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        del logits
    fn, _, in_pl, _, plan, _ = tsteps.make_serve_step(cfg, shape, mesh, run)
    cache_s = tsteps.distribute_tree([{"blocks": tuple({k: v.clone() for k, v in b.items()}
                                                       for b in seg["blocks"])}
                                      for seg in cache], in_pl[2], mesh)
    batch = tsteps.distribute_tree({"tokens": first}, in_pl[1], mesh)
    gc.collect()
    with torch.no_grad():
        (tok_s, _), peak, dev_ms = q_measure(torch, fn, p_dt, batch, cache_s, profiled=True)
        tok_s = tok_s.full_tensor()
        del cache_s
        plan_u = ExecutionPlan(moe_impl=plan.moe_impl, k_cold=plan.k_cold, use_kernels=False)
        logits, _, _ = decode_step(params, cfg, first, cache,
                                   {"valid": torch.ones(B, dtype=torch.bool, device="cuda")},
                                   plan=plan_u)
        tok_u = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    what = (f"decode {cfg.name} full depth, {B} rows over {S} positions (reduced: not in "
            f"SHAPES), {plan.moe_impl} k_cold {plan.k_cold}")
    log(f"{Q_LABEL} [{what}] ({card}): make_serve_step next tokens {tok_s.tolist()} vs "
        f"decode_step {tok_u.tolist()}; device time {dev_ms:.1f} ms, peak "
        f"{peak / 2**30:.3f} GiB")
    if not torch.equal(tok_s, tok_u):
        raise AssertionError(f"[{Q_LABEL} decode] next tokens differ")
    recs.append(dict(what=what, cfg=cfg, shape=shape, run=run, peak=peak, device_ms=dev_ms))
    del cache, params, p_dt
    gc.collect()
    torch.cuda.empty_cache()
    return recs


def q_cell(card):
    """``python -m repro_torch.launch.dryrun`` for ``Q_CELL`` in a subprocess:
    it must end ok on 256 fake ranks."""
    import shutil
    import tempfile
    root = Path(__file__).resolve().parent
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        arch, shape = Q_CELL
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                            "--shape", shape, "--mesh", "single", "--out", out],
                           capture_output=True, text=True, timeout=600, env=env, cwd=root)
        wall = time.perf_counter() - t0
        path = Path(out) / f"{arch}__{shape}__single.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        devices = rec.get("mesh_info", {}).get("num_devices")
        log(f"{Q_LABEL} [dry run {arch} x {shape} x single] ({card}): exit {r.returncode}, "
            f"status {rec.get('status')}, {devices} devices, trace {rec.get('trace_s', 0):.1f} s, "
            f"{wall:.1f} s of wall with the interpreter's start; t_bound "
            f"{rec.get('roofline', {}).get('t_bound')}")
        if r.returncode != 0 or rec.get("status") != "ok" or devices != 256:
            raise AssertionError(f"[{Q_LABEL}] the dry run failed: {r.stdout[-2000:]}"
                                 f"{r.stderr[-2000:]}")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def steps_phase(torch):
    """Path q: the train, prefill and serve step builders on a one-rank NCCL
    mesh, their dry runs in a fake one-rank group, and a production cell.
    The launch counts are set to 0 just before and read just after: no
    kernel may launch (the steps run the plain paths, as the reference's)."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh, process_group
    card = gpu_name_and_power()
    t0 = time.perf_counter()
    build.reset_launch_counts()
    with process_group("cuda"):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        recs = [q_train(torch, mesh, card)] + q_serve(torch, mesh, card)
    launched = {k: n for k, n in build.launch_counts.items() if n}
    log(f"{Q_LABEL} ({card}): kernel launches on the path: {json.dumps(launched)}")
    if launched:
        raise AssertionError(f"[{Q_LABEL}] the steps launched kernels: {launched}")
    for rec in recs:                      # the dry runs need the real group gone
        q_check_trace(torch, card, rec)
    q_cell(card)
    log(f"{Q_LABEL} ({card}): path q took {time.perf_counter() - t0:.1f} s")


def check_against_plain(torch, cfg, params, label, flags):
    """One mixed stage (a 64-token chunk after a written 64-token prefix,
    plus two decode rows) through the path's kernels and through the plain
    torch path, each on its own fresh cache; the logits are held to
    ``compare_logits`` (its 5% band also covers, with int8 pages, the
    kernels' per-page against the plain path's whole-row requantization of
    p*v_scale). The plain path takes the kernel path's expert choices
    (``recorded_routes``: a router near-tie flipped by bf16 noise is no
    fault; deepseek-moe-16b routes top-6 of 64). A model with shared
    experts runs the kernel path a
    third time with them zeroed: their part of the logits must exceed the
    kernel path's difference from the plain path."""
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
    out, routes = {}, None
    ragged = flags.get("moe_ragged", True)
    runs = [("kernels", True, params), ("plain", False, params)]
    if cfg.moe is not None and cfg.moe.num_shared_experts:
        from repro_torch.models.params import tree_map
        zeroed = dict(params, segments=tuple(
            dict(seg, blocks=tuple(dict(blk, ffn=dict(blk["ffn"], shared=tree_map(
                blk["ffn"]["shared"], torch.zeros_like))) if "shared" in blk["ffn"] else blk
                for blk in seg["blocks"])) for seg in params["segments"]))
        runs.append(("kernels, shared experts zeroed", True, zeroed))
    for name, use_kernels, weights in runs:
        plan = ExecutionPlan(moe_impl="duplex", k_cold=32, c_hot=64, c_cold=16,
                             moe_ragged=ragged and use_kernels, use_kernels=use_kernels)
        cache = init_cache(cfg, page_size=page, num_pages=32, device="cuda",
                           kv_quant=flags.get("kv_quant", False))
        pins = routes if name == "plain" else None
        with torch.no_grad(), recorded_routes(torch, pins) as calls:
            # write the prefix, then run the chunk with two decode rows
            mixed_step(weights, cfg, dec[:1], prefix, cache,
                       attn_ctx={"lengths": i32([0]), "block_tables": bt_dec[:1],
                                 "valid": i32([1]) > 0},
                       chunk_ctx={"starts": i32([0]), "chunk_lens": i32([64]),
                                  "block_tables": bt}, plan=plan)
            dl, cl, _, _ = mixed_step(
                weights, cfg, dec, chunk, cache,
                attn_ctx={"lengths": i32([1, 0]), "block_tables": bt_dec,
                          "valid": i32([1, 0]) > 0},
                chunk_ctx={"starts": i32([64]), "chunk_lens": i32([64]),
                           "block_tables": bt}, plan=plan)
        routes = calls if name == "kernels" else routes
        out[name] = torch.cat([dl[:1, 0], cl[:, 0]]).float()
        del cache
    compare_logits(torch, label, "one mixed stage (the kernel path's expert choices)",
                   out["kernels"], out["plain"])
    if "kernels, shared experts zeroed" in out:
        moved = (out["kernels"] - out["kernels, shared experts zeroed"]).abs().max().item()
        noise = (out["kernels"] - out["plain"]).abs().max().item()
        log(f"serve [{label}]: the same stage with the shared experts zeroed moves the logits "
            f"by {moved:.4f} (max |dlogit|; the kernels against the plain path {noise:.4f})")
        if not moved > noise:
            raise AssertionError(f"[{label}] the shared experts do not reach the logits")


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


def ptxas_entries(text):
    """{entry function: (registers, spill bytes stored + loaded)} from a
    ``-Xptxas -v`` report."""
    entries, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            entries[cur] = [0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entries[cur][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in entries.items()}


def log_hd256_ptxas(build) -> None:
    """The registers and spills of the flash kernels' head_dim-256
    instantiations (path s's plans), one line each."""
    for src in ("flash_fwd_sm90.cu", "flash_bwd_sm90.cu"):
        text = build._lib_path(src).with_suffix(".log").read_text()
        for name, (regs, spill) in ptxas_entries(text).items():
            m = re.search(r"(flash_\w+?_kernel)ILi256E(Lb([01])E)?", name)
            if m:
                chain = {None: "", "0": " (no score chain)", "1": " (bf16 score chain)"}[m.group(3)]
                log(f"ptxas {src} hd 256: {m.group(1)}{chain}: {regs} registers, {spill} bytes "
                    f"of spill stores and loads")


def tensor_core_sass(build) -> None:
    """Counts the tensor-core instructions in each built library's SASS
    (``cuobjdump -sass``): warpgroup products (HGMMA; IGMMA on int8) and
    warp ones (HMMA, TF32 ones too; IMMA on int8). The bf16 flash forward
    and backward and the bf16 chunk attention must hold HGMMA, the bf16 hot
    GEMM and cold GEMV and the float32 chunk attention HMMA or HGMMA, the
    int8 chunk attention IMMA or IGMMA."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    for src in build.SOURCES:
        sass = subprocess.run([str(tool), "-sass", str(build._lib_path(src))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        n = {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HGMMA", "HMMA", "IGMMA", "IMMA")}
        log(f"sass {src}: " + ", ".join(f"{v} {op}" for op, v in n.items()) + " instructions "
            f"({'tensor cores' if any(n.values()) else 'no tensor-core instruction'})")
        if src in ("flash_fwd_sm90.cu", "flash_bwd_sm90.cu", "chunk_attn_sm90.cu") \
                and not n["HGMMA"]:
            raise AssertionError(f"the SASS of {src} holds no HGMMA")
        if src in ("moe_gemv_sm90.cu", "moe_gemm_sm90.cu", "chunk_f32_sm90.cu") \
                and not (n["HGMMA"] or n["HMMA"]):
            raise AssertionError(f"the SASS of {src} holds no HMMA or HGMMA")
        if src == "chunk_int8_sm90.cu" and not (n["IGMMA"] or n["IMMA"]):
            raise AssertionError(f"the SASS of {src} holds no IMMA or IGMMA")


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
    t_main = t0 = time.perf_counter()
    phase_s = {}                          # wall seconds of each phase
    build.build_all()
    phase_s["build"] = round(time.perf_counter() - t0, 1)
    log(f"build: {len(build.SOURCES)} sources with nvcc in "
        f"{time.perf_counter() - t0:.1f}s")
    for src in build.SOURCES:
        entries = ptxas_entries(build._lib_path(src).with_suffix(".log").read_text())
        log(f"ptxas {src}: {len(entries)} kernels, at most "
            f"{max((r for r, _ in entries.values()), default=0)} registers, "
            f"{sum(b for _, b in entries.values())} bytes of spill stores and loads")
    log_hd256_ptxas(build)
    tensor_core_sass(build)

    rows = timed(phase_s, "kernels", kernel_phase, torch)
    by_path = {}

    def count(path, launches):
        """Each path's launches of each kernel; a kernel's row sums them."""
        for name, n in launches.items():
            rows[name]["launches"] = (rows[name]["launches"] or 0) + n
            by_path.setdefault(name, {})[path] = n

    if not args.kernels_only:
        launches, r_launches, a_tokens = serve_phase(torch, phase_s)
        count("a, b", launches)
        count("r", r_launches)
        gc.collect()                      # the OLMoE model and its caches go
        torch.cuda.empty_cache()
        count("t", timed(phase_s, "t", f32_phase, torch))
        gc.collect()                      # the float32 OLMoE goes
        torch.cuda.empty_cache()
        timed(phase_s, "k", cli_phase, torch, a_tokens)   # the CLI makes its own OLMoE weights
        gc.collect()
        torch.cuda.empty_cache()
        count("c", timed(phase_s, "c", hybrid_phase, torch))
        gc.collect()                      # the Jamba model and its caches go
        torch.cuda.empty_cache()
        timed(phase_s, "l, l2", ring_phase, torch)
        gc.collect()                      # gemma3-4b and its caches go
        torch.cuda.empty_cache()
        timed(phase_s, "m", configs_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        count("n", timed(phase_s, "n", deepseek_phase, torch))
        gc.collect()                      # deepseek-moe-16b and its pool go
        torch.cuda.empty_cache()
        count("o, o2", timed(phase_s, "o, o2", whisper_phase, torch))
        count("p", timed(phase_s, "p", vlm_phase, torch))
        path_d = timed(phase_s, "d", train_phase, torch)
        count("d", path_d["launches"])
        gc.collect()                      # path d's state goes
        torch.cuda.empty_cache()
        count("s", timed(phase_s, "s", gemma_train_phase, torch, card))
        gc.collect()                      # path s's state goes
        torch.cuda.empty_cache()
        timed(phase_s, "d2", resume_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed(phase_s, "d3", remat_phase, torch, path_d)
        gc.collect()
        torch.cuda.empty_cache()
        timed(phase_s, "q", steps_phase, torch)
        log(f"kernels: launches by path (each counted from 0 over its own run): "
            f"{json.dumps(by_path)}")
    log(f"phases (s): {json.dumps(phase_s)}; {time.perf_counter() - t_main:.1f} s since the "
        f"build began")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
