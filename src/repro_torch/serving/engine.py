"""Continuous-batching serving engine with the duplex MoE (port of
``repro/serving/engine.py``), on the paged or the dense KV layout, with
prefix sharing, preemption, overload handling, the async loop and
speculative decoding.

Each stage is one token stream: the scheduler picks decode rows and prefill
spans; the engine stages the inputs into bucketed shapes (powers of two,
exactly the reference's buckets — they decide the MoE capacities and so
which tokens overflow), runs the model, samples (greedy by default; at a
temperature, with top-k and top-p, from a generator seeded with ``seed``),
and commits. The Duplex planner picks the stage's ``k_cold`` from an EMA of
the previous stages' actual router counts, and the Op/B dispatch model
(``core/dispatch.py``) routes each layer component of the stage to the
modelled compute or bandwidth path (``StageReport.bandwidth_flop_fraction``);
on the device the experts are re-ranked by the live counts and the cold /
hot paths run the GEMV / ragged GEMM kernels (or, with ``moe_ragged=False``,
the capacity-padded GEMV / GEMM kernels).

Full self-attention stacks run chunked (or, with
``prefill_chunk_tokens=None``, whole-prompt) spans and decode rows through
``mixed_step`` together, or ``decode_step`` when there is no span, on
either layout (``kv_layout`` None takes "paged"). With ``spec_k`` an n-gram
drafter proposes up to ``spec_k`` tokens for each decode row it can match;
a drafted row rides the mixed stage as a verify span (its last token and
the draft, a chunk row), the step returns the argmax at every chunk
position, and the commit keeps the longest agreeing prefix plus the
verifier's own next token, then rewinds the rejected tail's KV (paged:
block-table surgery; dense: the device-side lengths, from staged indices).
The layouts:

* paged: block tables grow on the host; the decode rows are the stage's
  rows. With ``kv_quant`` the page pools hold int8 K/V with float32 scales
  and the int8 attention kernels run. With ``prefix_share`` a queued
  prompt pins the resident pages of its full-page prefix, adopts them at
  admission and starts its prefill after them; a write into a shared page
  copies it first, and each chunk's full pages are indexed at commit.
* dense: every slot owns a ``max_len`` row; the decode half runs over all
  ``max_slots`` rows (dead rows masked out of MoE routing), and a chunk row
  names its slot. With ``kv_quant`` the rows hold int8 K/V with float32
  scales.

Every other stack (Mamba, hybrid, or with sliding-window layers, whose
dense rows are rings of ``min(max_len, window) + 1`` slots) takes the dense
layout with ``prefill_chunk_tokens=None``: the dense decode over all rows
first, then
the legacy monolithic prefill of the admitted prompts, padded to a
``prefill_len_buckets`` length, into a fresh local cache under the grouped
MoE plan; at commit the prompts claim slots and their cache rows are
scattered in.

``preemption`` reclaims capacity when it runs out: a starving queue head
with no free slot evicts the least-progressed decoding request, and on the
paged layout a pool that cannot cover the next stage's growth evicts
page-granularly first, so ``kv_num_pages`` may oversubscribe the pool.
"migrate" (dense only) saves the victim's cache row to the host and
restores it later; "recompute" drops it and prefills prompt plus output
again. Each host step happens in the reference's order, because parity is
judged on tokens.

Overload and faults: the admission queue may be bounded (``queue_cap``,
``overload_policy``: a full queue rejects with ``AdmissionRejected`` or
sheds a queued request), queued requests age into higher priority bands
(``aging_rounds``), ``cancel`` ends a request wherever it is, and a
per-stage sweep expires requests past their deadline or first-token SLO;
each releases its slot, pages and pins. A seeded ``FaultInjector`` fails
page allocations and stage steps, forces evictions and spikes the clock.
The KV cache is written in place, so every fault of a stage is drawn
before its first device step; a dense legacy stage, like the reference's,
runs its decode before the prefill's draw. All clock reads go through
``_now(now)``: a caller's virtual ``now`` drives deadlines
deterministically, and injected latency adds to it.

A stage is ``plan_stage`` (maintenance, admission, the scheduler's stage;
host work), ``dispatch_stage`` (slots, pages, input staging and the device
step, enqueued without waiting; an injected fault raises out of it and
``_abort_stage`` sends the stage's admissions back to the queue head) and
``commit_stage`` (the one wait, the durable commit, then the report and,
with ``audit_stages``, the KV audit). ``step`` runs the three in turn;
``run`` steps to drain, its watchdog raising ``EngineStalledError``
instead of spinning. ``run_async`` and ``step_async`` pipeline them: while
stage N runs on the device, the host plans N+1 from N's projected
post-commit state and, when N+1's decode tokens are rows of N's sampled
tokens, enqueues it before N is read, its tokens gathered on the device
(``_select_tokens``); N's accounting runs after N+1's dispatch. A commit
that contradicts the projection, or any submit, cancel, eviction or expiry
(the mutation epoch), sends the plan back to be formed from real state. A
stage carrying verify spans is never projected past (its acceptance is
unknown until read: "rewind"), with the drafter on a projected stage with
decode rows is formed after the commit instead (its drafts must read the
committed tokens: "draft"), and no chain crosses a verify span. An
``on_token(rid, token)`` callback sees every committed token, fired from
the deferred commit, off the critical section.

The device boundary: inputs are staged in two alternating sets of host
buffers (pinned on the card, uploaded without blocking), and each stage's
outputs are copied into pinned host tensors behind one CUDA event, which
is all ``_materialize`` waits for; nothing else on the enqueue path waits
for the device. Where the reference keys one jitted function per bucketed
shape, the port calls the model with the same bucketed shapes. The engine
runs on ``device`` ("cuda" unless the caller asks for the CPU, as the
tests do); asking for CUDA without a card raises.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ATTN_LOCAL, MAMBA, MOE, ModelConfig
from repro_torch.core.costmodel import DUPLEX
from repro_torch.core.dispatch import plan_stage as core_plan_stage
from repro_torch.core.duplex_moe import default_capacities, moe_traffic_model
from repro_torch.core.execution import ExecutionPlan
from repro_torch.core.opb import StageMix
from repro_torch.core.partition import DuplexPlanner, build_luts
from repro_torch.models.model import decode_step, init_cache, mixed_step, prefill
from repro_torch.models.params import DTYPES, tree_map
from repro_torch.serving import preemption as pre
from repro_torch.serving.drafter import NgramDrafter
from repro_torch.serving.faults import FaultInjector, InjectedFault, InjectedStepError
from repro_torch.serving.kvmanager import KVManager, kv_token_bytes
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.sampling import SamplingParams, sample
from repro_torch.serving.scheduler import (AdmissionRejected,
                                           ContinuousBatchingScheduler,
                                           StageDecision)

MAX_PREFILL_SEQS = 4     # chunk spans per stage (the reference's default)
MAX_PREFILL_TOKENS = 8192   # whole-prompt tokens per stage (the reference's default)
# legacy prefill lengths (the reference's default buckets; max_len joins them)
PREFILL_LEN_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pow2_buckets(n_max: int) -> Tuple[int, ...]:
    out = []
    b = 1
    while b < n_max:
        out.append(b)
        b *= 2
    out.append(n_max)
    return tuple(out)


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _select_tokens(prev_nxt, prev_cn, src_nxt, src_cn, fallback, mode: str):
    """A chained stage's decode input tokens, gathered on the device from
    the previous stage's sampled tokens before the host has read them: row
    i takes ``prev_nxt[src_nxt[i]]`` or ``prev_cn[src_cn[i]]`` where the
    index is >= 0, else the host-known ``fallback[i]``. ``mode`` (see
    ``ChainInfo.mode``) skips the gathers a stage does not need: "pure"
    reads only ``prev_nxt`` (``src_cn`` and ``fallback`` unused),
    "nxt_only" no chunk source, "full" both. Returns (n, 1) int32."""
    flat_n = prev_nxt.reshape(-1)
    if mode == "pure":
        return flat_n.index_select(0, src_nxt)[:, None].to(torch.int32)
    t = torch.where(src_nxt >= 0, flat_n.index_select(0, src_nxt.clamp_min(0)), fallback)
    if mode == "full":
        flat_c = prev_cn.reshape(-1)
        t = torch.where(src_cn >= 0, flat_c.index_select(0, src_cn.clamp_min(0)), t)
    return t[:, None].to(torch.int32)


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool}


@dataclass
class StageReport:
    stage_index: int
    is_mixed: bool
    num_decode: int
    num_prefill: int             # prefill-chunk rows this stage
    k_cold: int
    bandwidth_flop_fraction: float   # the Op/B plan's (0.0 for an aborted stage)
    wall_time: float             # host clock, plan to commit
    kv_bytes_streamed: int = 0   # K+V bytes of the stage's live pages
    moe_bytes_streamed: int = 0  # modelled MoE bytes from the actual counts
    moe_flops_live: int = 0
    moe_flops_padded: int = 0
    chunk_tokens: int = 0        # prefill positions the stage's spans cover
    stage_tokens: int = 0        # live tokens through the MoE stream
    shared_kv_pages: int = 0     # pages mapped by more than one owner after it
    # robustness: ``aborted`` marks a stage an injected fault unwound (its
    # admissions went back to the queue head, nothing advanced); the rest
    # are this stage's deltas of the engine's totals
    aborted: bool = False
    shed: int = 0
    expired: int = 0
    cancelled: int = 0
    retries: int = 0
    audit_violations: int = 0
    # speculative decoding: draft tokens the stage's verify spans carried and
    # those the verifier agreed with (the verifier's own token each row
    # commits on top is not counted)
    spec_proposed: int = 0
    spec_accepted: int = 0


@dataclass
class ChainInfo:
    """Device-side token chaining for a speculative stage N+1 dispatched
    before stage N is read. ``src_nxt`` / ``src_cn`` map each of N+1's
    decode input rows to the row of N's ``nxt`` / ``cn`` that feeds it (-1:
    none, take ``fallback``, a token the host knows); ``proj_lens`` holds
    each paged decode slot's length once N commits, which the staging reads
    in place of ``kv.lens``."""
    src_nxt: np.ndarray
    src_cn: np.ndarray
    fallback: np.ndarray
    prev_nxt: Any                 # stage N's nxt (device)
    prev_cn: Any                  # stage N's cn (device), None without chunks
    proj_lens: Dict[int, int]     # slot -> projected length before the write

    @property
    def mode(self) -> str:
        """"full" when a row reads N's ``cn``; else "pure" when every row
        reads N's ``nxt``, "nxt_only" otherwise."""
        if (self.src_cn >= 0).any():
            return "full"
        return "pure" if (self.src_nxt >= 0).all() else "nxt_only"


@dataclass
class StagePlan:
    """A formed stage not yet dispatched: the scheduler's decision, its
    k_cold and Op/B dispatch plan (``splan``), the host clock at plan
    start, the (shed, expired, cancelled, retries) totals before it and the
    engine clock its tokens are stamped with. A ``speculative`` plan was
    formed against the projected post-commit state of an in-flight stage
    (the scheduler is activated at dispatch); ``epoch`` is the mutation
    epoch it assumed; with ``chain`` it dispatches before its predecessor
    is read; ``evict_seq`` is the engine's eviction count at its dispatch
    (``_stale_rows``)."""
    decision: StageDecision
    k_cold: int
    t0: float
    snap: Tuple[int, int, int, int]
    tnow: float
    speculative: bool = False
    epoch: int = -1
    chain: Optional[ChainInfo] = None
    splan: Optional[Any] = None
    evict_seq: int = 0


@dataclass
class StageFuture:
    """A dispatched stage: its device outputs and what the commit needs.
    Nothing durable (lengths, tokens, scheduler positions) has moved yet."""
    plan: StagePlan
    nxt: Any = None               # decode next tokens (device)
    cn: Any = None                # chunk next tokens (device)
    cn_all: Any = None            # argmax at every chunk position (verify spans)
    counts: Any = None            # summed per-expert router counts (device)
    legacy_nxt: Any = None        # legacy prefill next tokens (device)
    legacy_cache: Any = None      # legacy prefill's local cache, scattered at commit
    kv_bytes: int = 0
    moe_caps: Optional[Tuple[int, int, int]] = None
    # the stage's (shed, expired, cancelled, retries) deltas, frozen at commit
    deltas: Tuple[int, int, int, int] = (0, 0, 0, 0)
    t_dispatch: float = 0.0
    # the outputs on the host (on the card pinned copies, complete once
    # ``event`` has passed)
    host: Dict[str, Any] = field(default_factory=dict)
    event: Any = None
    # the stage's draft and accept counts, frozen at commit for its report
    spec_proposed: int = 0
    spec_accepted: int = 0
    # (rid, token) committed this stage in commit order, for ``on_token``
    # (filled only when a callback is set)
    emitted: List[Tuple[int, int]] = field(default_factory=list)


class EngineStalledError(RuntimeError):
    """``run``'s watchdog: no stage can make progress (capacity livelock, a
    fault schedule that never relents, or a spent stage or wall budget).
    The message lists the stuck request ids, queue depth and free
    capacity."""


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int, max_len: int,
                 kv_layout: Optional[str] = None, kv_page_size: int = 64,
                 kv_num_pages: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 use_duplex: bool = True, use_kernels: bool = True,
                 kv_quant: bool = False, moe_ragged: bool = True,
                 moe_c_block: int = 256, preemption: str = "none",
                 prefix_share: bool = False, queue_cap: Optional[int] = None,
                 overload_policy: str = "reject", aging_rounds: Optional[int] = None,
                 injector: Optional[FaultInjector] = None,
                 audit_stages: Optional[bool] = None,
                 sampling: SamplingParams = SamplingParams(), spec_k: int = 0,
                 spec_ngram: int = 3,
                 on_token: Optional[Callable[[int, int], None]] = None, device="cuda",
                 seed: int = 0):
        """``sampling`` is greedy by default; at a temperature > 0 each stage
        draws from a ``torch.Generator`` on ``device`` seeded with ``seed``,
        so a run is reproducible from its seed. ``kv_layout`` None takes
        "paged" for a full self-attention stack and "dense" for the others. Paged: the page
        pool holds ``kv_num_pages`` pages (default every slot at max_len,
        plus the null page); ``kv_quant`` keeps the pages in int8 with
        float32 per-(token, KV head) scales; ``prefix_share`` shares
        full-page prompt prefixes between requests. Dense: every slot owns a
        max_len cache row (and, for Mamba layers, a state). ``preemption``
        is "none", "migrate" (dense only) or "recompute". With
        ``use_kernels`` the attention and SSD kernels run, and the MoE runs
        the duplex ragged kernels, or with ``moe_ragged=False`` the
        capacity-padded ones; without ``use_duplex`` the MoE is the plain
        grouped path, as the reference runs XLA there. Chunked prefill
        (``prefill_chunk_tokens``) needs a full self-attention stack, as in
        the reference. ``queue_cap`` bounds the admission queue and
        ``overload_policy`` ("reject", "shed-oldest", "shed-past-deadline")
        decides what a submit to a full one does; ``aging_rounds`` promotes
        a queued request one band per that many stages. ``injector`` (a
        ``FaultInjector``) injects faults into the KV manager and the stage
        loop; ``audit_stages`` audits the KV manager after every stage, by
        default exactly when an injector is given. ``spec_k`` > 0 turns on
        speculative decoding with an n-gram drafter over ``spec_ngram``-token
        tails (greedy sampling and a full self-attention stack only);
        ``on_token(rid, token)`` is called for every committed token. It
        serves decoder-only models, as the reference's engine: an
        encoder-decoder (whisper) raises ValueError and is served through
        ``models/model.py``'s ``prefill`` and ``decode_step``."""
        if cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name}: the engine serves decoder-only models; an "
                             f"encoder-decoder serves through model.prefill and "
                             f"model.decode_step")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine(device='cuda') but no CUDA device "
                               "is available; pass device='cpu' explicitly")
        if preemption not in ("none", "migrate", "recompute"):
            raise ValueError(f"preemption must be 'none', 'migrate' or 'recompute', "
                             f"got {preemption!r}")
        # the sampling stream (drawn from only at a temperature > 0)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, engine device is "
                             f"{self.device}")
        self.cfg = cfg
        # one float32 copy of the LM head table, made here instead of on
        # every stage (models/model.py::_lm_head)
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        self.params = dict(params, lm_head_f32=head["table"].float())
        # the unified token stream covers full self-attention stacks; Mamba
        # needs a state carried across chunks, and a ring would overwrite
        # prefix slots mid-chunk, so those stacks keep the legacy monolithic
        # prefill (the reference's rule)
        self._unified = all(kind.mixer == ATTN
                            for seg in cfg.segments for kind in seg.pattern)
        if prefill_chunk_tokens is not None and not self._unified:
            raise NotImplementedError(
                "chunked prefill needs a full self-attention decoder stack "
                "(mamba/windowed/cross mixers still prefill monolithically)")
        if spec_k > 0 and sampling.temperature > 0.0:
            raise ValueError(
                "speculative decoding requires greedy sampling (temperature == 0): "
                "acceptance compares the verifier's argmax against the draft; sampled "
                "decoding would need rejection sampling to keep the output distribution")
        if spec_k > 0 and not self._unified:
            raise NotImplementedError(
                "speculative decoding rides the unified mixed-stage chunk path "
                "(full self-attention decoder stacks only)")
        if kv_layout is None:
            kv_layout = "paged" if self._unified else "dense"
        if not self._unified and kv_layout == "paged":
            raise ValueError("a Mamba, hybrid or windowed stack has no paged KV cache; "
                             "use kv_layout='dense' (the default for such a stack)")
        self.injector = injector
        self.audit_stages = (injector is not None if audit_stages is None
                             else bool(audit_stages))
        self.kv = KVManager(cfg, max_slots, max_len, layout=kv_layout,
                            page_size=kv_page_size, num_pages=kv_num_pages,
                            kv_quant=kv_quant, device=self.device, injector=injector)
        self.paged = self.kv.paged
        if self.paged and preemption == "migrate":
            raise NotImplementedError(
                "migrate gathers dense slot rows to host; paged preemption "
                "uses the recompute-replay path (preemption='recompute')")
        if prefix_share and not self.paged:
            raise ValueError("prefix_share needs kv_layout='paged' (sharing maps "
                             "refcounted pages between block tables)")
        self.preemption = preemption
        self.prefix_share = bool(prefix_share)
        self.preemptions = 0
        # prefill positions skipped because their KV was already resident
        self.shared_tokens_skipped = 0
        self.peak_active = 0
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.scheduler = ContinuousBatchingScheduler(
            max_prefill_seqs=MAX_PREFILL_SEQS,
            prefill_chunk_tokens=prefill_chunk_tokens, max_prefill_target=max_len,
            max_prefill_tokens=MAX_PREFILL_TOKENS, queue_cap=queue_cap,
            overload_policy=overload_policy, aging_rounds=aging_rounds)
        # robustness totals over the engine's life; StageReport carries each
        # stage's deltas, stats() the roll-up and a window's deltas
        self.cancelled = 0
        self.expired = 0
        self.shed = 0
        self.rejected = 0
        self.retries = 0
        self.stage_aborts = 0
        self.forced_evictions = 0
        self.audit_violations = 0
        self.audit_log: List[str] = []
        self._stats_base: Dict[str, int] = {}
        # injected latency and retry backoff, added to every clock read
        self.fault_delay = 0.0
        # every submitted request by rid: cancel finds it anywhere
        self._requests: Dict[int, Request] = {}
        # submit, cancel, step and stats hold it: calls from other threads
        # land between stages
        self._lock = threading.RLock()
        self.use_duplex = use_duplex and cfg.moe is not None
        self.use_kernels = use_kernels
        self.moe_ragged = bool(moe_ragged and use_kernels and self.use_duplex)
        self.moe_c_block = moe_c_block
        # chunk-row buckets: with speculation every decode row may also carry
        # a verify span (the reference's buckets, which decide the MoE
        # capacities and so the per-stage k_cold)
        row_cap = MAX_PREFILL_SEQS + (max_slots if spec_k > 0 else 0)
        self.seq_buckets = tuple(sorted({1, 2, MAX_PREFILL_SEQS, row_cap}
                                        | set(_pow2_buckets(row_cap))))
        self.chunk_len_buckets = _pow2_buckets(
            min(prefill_chunk_tokens, max_len) if prefill_chunk_tokens else max_len)
        # legacy prefill lengths: max_len is always a bucket, so no prompt
        # within the KV capacity is truncated
        self.prefill_len_buckets = tuple(sorted(
            {b for b in PREFILL_LEN_BUCKETS if b < max_len} | {max_len}))
        self.decode_bs_buckets = _pow2_buckets(max_slots)
        if self.paged:
            self.pages_buckets = _pow2_buckets(self.kv.max_pages_per_slot)
        self.planner: Optional[DuplexPlanner] = None
        if self.use_duplex:
            # the xPU LUT models what the hot kernel executes: ragged ->
            # block-quantized live tokens; padded -> the full capacity grid
            ch, _, cb = self._moe_caps(max_slots, 0)
            hot_kw = (dict(hot_block=cb) if self.moe_ragged
                      else dict(hot_block=cb, hot_capacity=ch))
            max_stage_tokens = (max(4 * max_slots, 512)
                                + MAX_PREFILL_SEQS * self.chunk_len_buckets[-1])
            lut_x, lut_p = build_luts(DUPLEX, cfg.d_model, cfg.moe.d_ff_expert,
                                      max_tokens=max_stage_tokens, **hot_kw)
            self.planner = DuplexPlanner(lut_x, lut_p, cfg.moe.num_experts)
        self._ema_counts: Optional[np.ndarray] = None
        self._count_ema_decay = 0.5
        # streamed K+V bytes per live token over the attention layers, in the
        # cache's actual storage (int8 values plus their float32 scales when
        # quantized); Mamba layers hold O(1) state and are not counted. The
        # dense decode streams every slot's whole row: max_len positions of a
        # full-attention layer, the min(max_len, window) + 1 slots of a
        # sliding-window one
        n_attn = sum(seg.repeats for seg in cfg.segments
                     for kind in seg.pattern if kind.mixer != MAMBA)
        per_tok = kv_token_bytes(cfg, kv_quant=kv_quant)
        self._kv_bytes_per_token = per_tok * n_attn
        dense_row = sum(seg.repeats * (min(max_len, cfg.sliding_window) + 1
                                       if kind.mixer == ATTN_LOCAL and cfg.sliding_window > 0
                                       else max_len)
                        for seg in cfg.segments for kind in seg.pattern if kind.mixer != MAMBA)
        self._dense_kv_bytes_per_stage = max_slots * per_tok * dense_row
        self._moe_layers = sum(seg.repeats for seg in cfg.segments
                               for kind in seg.pattern if kind.ffn == MOE)
        self._param_itemsize = DTYPES[cfg.param_dtype].itemsize
        self._tokens = np.zeros((max_slots,), np.int32)   # last token per slot
        # the request each claimed slot belongs to: a commit applies a row
        # only to the request that still owns its slot (``_row_live``)
        self._slot_req: Dict[int, Request] = {}
        self._stage_idx = 0
        self.reports: List[StageReport] = []
        # the async loop: the mutation epoch (every submit, cancel, shed,
        # expiry and eviction bumps it; a speculative plan formed under
        # another epoch is rejected), the stage ``step_async`` leaves in
        # flight, and the host gap (from a stage's outputs arriving on the
        # host to the next dispatch, over the stages that waited for one)
        self._epoch = 0
        # evictions in sequence, and each request's last one: a row of a
        # stage in flight whose request was evicted after the dispatch is
        # stale (``_stale_rows``)
        self._evict_seq = 0
        self._evicted_at: Dict[int, int] = {}
        self._stale: frozenset = frozenset()
        self._inflight: Optional[StageFuture] = None
        self._t_sync_done: Optional[float] = None
        self.host_gap_s = 0.0
        self.gap_stages = 0
        self.spec_hits = 0           # speculative plans dispatched as formed
        self.spec_misses = 0         # invalidated, formed again from real state
        self.spec_miss_reasons: Dict[str, int] = {}
        self.chained_stages = 0      # dispatched before the previous stage was read
        # two sets of staging buffers, flipped once a dispatch (``_staging``)
        self._staging_bufs: List[Dict[str, Any]] = [{}, {}]
        self._staging_idx = 0
        self.sampling = sampling
        self.spec_k = int(spec_k)
        self.drafter = NgramDrafter(k=self.spec_k, ngram=spec_ngram) if self.spec_k > 0 else None
        self.spec_proposed = 0       # draft tokens sent to verification
        self.spec_accepted = 0       # draft tokens the verifier agreed with
        self.spec_rewinds = 0        # verify rows whose KV was rolled back
        self.on_token = on_token

    # ------------------------------------------------------------- planning
    def _moe_caps(self, T: int, k_cold: int) -> Tuple[int, int, int]:
        """(c_hot, c_cold, c_block) for a stage of T bucketed (padded) tokens;
        the hot capacity snaps up to a power-of-two count of c_block blocks."""
        if self.cfg.moe is None:
            return 0, 0, self.moe_c_block
        ch, cc = default_capacities(T, self.cfg.moe, k_cold)
        cb = min(self.moe_c_block, _pow2_ceil(ch))
        blocks = _pow2_ceil(-(-ch // cb))
        return blocks * cb, cc, cb

    def _moe_plan(self, k_cold: int, c_hot: int, c_cold: int) -> ExecutionPlan:
        duplex = k_cold > 0 or self.moe_ragged
        return ExecutionPlan(moe_impl="duplex" if duplex else "grouped",
                             k_cold=k_cold, c_hot=c_hot if duplex else None,
                             c_cold=c_cold if duplex else None,
                             moe_ragged=self.moe_ragged, use_kernels=self.use_kernels)

    def _expected_counts(self, T: int) -> np.ndarray:
        """EMA of actual router counts rescaled to T live tokens (uniform
        until the first stage reports back)."""
        m = self.cfg.moe
        total = float(T * m.top_k)
        if self._ema_counts is None or self._ema_counts.sum() <= 0:
            return np.full(m.num_experts, total / m.num_experts)
        return self._ema_counts * (total / self._ema_counts.sum())

    def _update_counts(self, counts_sum) -> Optional[np.ndarray]:
        """Fold one stage's summed-over-layers counts into the EMA; returns
        the per-layer count vector."""
        if counts_sum is None:
            return None
        c = np.asarray(counts_sum, np.float64)
        if self._moe_layers:
            c = c / self._moe_layers
        if c.sum() <= 0:
            return c
        if self._ema_counts is None:
            self._ema_counts = c
        else:
            d = self._count_ema_decay
            self._ema_counts = d * self._ema_counts + (1.0 - d) * c
        return c

    # ------------------------------------------------- sharing and preemption
    def _match_prefix(self, req: Request) -> None:
        """Prefix sharing: pin the resident pages of the request's full-page
        prefix and move its ``prefill_pos`` to the first unshared position
        (capped at its target - 1: the last position is always processed,
        since its logits give the next token, and its shared page is copied
        before the write). Upgrades only to a longer match; skipped while
        the index is unchanged since the last try."""
        if not (self.paged and self.prefix_share):
            return
        if req.match_version == self.kv.index_version:
            return
        req.match_version = self.kv.index_version
        total = min(req.l_in + len(req.output), self.kv.max_len)
        if req.shared_pages is not None and \
                len(req.shared_pages) >= total // self.kv.page_size:
            return
        pids = self.kv.pin_prefix(req.token_stream(total))
        old = req.shared_pages or []
        if len(pids) <= len(old):
            self.kv.unpin(pids)
            return
        if old:
            self.kv.unpin(old)
        start = min(len(pids) * self.kv.page_size, total - 1)
        self.shared_tokens_skipped += start - req.prefill_pos
        req.shared_pages = pids
        req.prefill_pos = start

    def _maybe_preempt(self, tnow: float) -> None:
        """Paged: evict until the pool covers the next stage's growth. Both
        layouts: a fresh queue head starving with no free slot evicts the
        least-progressed decoding request (a preempted head evicts no one,
        so two requests never evict each other in turn)."""
        if self.preemption == "none":
            return
        if self.paged:
            self._preempt_for_pages(tnow)
        if self.kv.free_slots > 0:
            return
        q = self.scheduler.queue
        if not q or q[0].was_preempted:
            return
        victim = pre.pick_victim(self.scheduler.running, tnow)
        if victim is not None:
            self._evict(victim)

    def _forced_evict(self, tnow: float) -> None:
        """Injected fault: evict a victim although capacity is fine, unless
        fewer than two requests are resident (the rule genuine page pressure
        keeps)."""
        cands = [r for r in self.scheduler.running + self.scheduler.prefilling
                 if r.slot >= 0]
        if len(cands) < 2:
            return
        victim = (pre.pick_victim_paged(cands, tnow) if self.paged
                  else pre.pick_victim(self.scheduler.running, tnow))
        if victim is None:
            return
        self._evict(victim)
        self.forced_evictions += 1

    def _evict(self, victim: Request) -> None:
        self._evicted_at[victim.rid] = self._evict_seq
        self._evict_seq += 1
        self._slot_req.pop(victim.slot, None)
        if self.preemption == "migrate":
            pre.migrate_out(self.kv, victim)
        else:
            pre.recompute_out(self.kv, victim)
        self.scheduler.resubmit_preempted(victim)
        # the replay may re-match prefix pages that survived under other owners
        victim.match_version = -1
        self._match_prefix(victim)
        self.preemptions += 1
        self._epoch += 1

    def _stage_page_need(self) -> int:
        """Fresh pages the next stage's admitted work may need: one per
        decoding slot whose next token opens a page, each in-flight
        prefill's next chunk, and with sharing one copy-on-write page per
        prefill."""
        page = self.kv.page_size
        need = 0
        for r in self.scheduler.running:
            if r.slot >= 0 and int(self.kv.lens[r.slot]) % page == 0:
                need += 1
        budget = self.prefill_chunk_tokens or self.kv.max_len
        for r in self.scheduler.prefilling:
            if r.slot < 0:
                continue
            end = min(r.prefill_pos + budget, r.prefill_total)
            need += max(-(-end // page) - self.kv.slot_page_count(r.slot), 0)
            if self.prefix_share:
                need += 1
        return need

    def _lifetime_pages(self, req: Request) -> int:
        total = min(req.l_in + req.max_new_tokens, self.kv.max_len)
        return -(-total // self.kv.page_size)

    def _remaining_demand_pages(self) -> int:
        """Fresh pages the admitted work needs over the rest of its lifetime,
        plus a copy-on-write page per prefill with sharing."""
        need = 0
        for r in self.scheduler.running + self.scheduler.prefilling:
            if r.slot >= 0:
                need += max(self._lifetime_pages(r) - self.kv.slot_page_count(r.slot), 0)
        if self.prefix_share:
            need += len(self.scheduler.prefilling)
        return need

    def _preempt_for_pages(self, tnow: float) -> None:
        """Evict page-granularly until the pool covers the next stage's
        growth; never the last resident request (a context that outgrows
        the pool alone cannot be saved by eviction)."""
        while self.kv.free_pages < self._stage_page_need():
            cands = [r for r in self.scheduler.running + self.scheduler.prefilling
                     if r.slot >= 0]
            if len(cands) <= 1:
                return
            victim = pre.pick_victim_paged(cands, tnow)
            if victim is None:
                return
            self._evict(victim)

    def _admit_restored(self, req: Request) -> None:
        """A migrated request comes back: its saved cache row into a fresh
        slot, and decoding resumes."""
        slot = self.kv.allocate()
        pre.restore_slot(self.kv, slot, req.saved_cache)
        req.saved_cache = None
        req.slot = slot
        self._slot_req[slot] = req
        self._tokens[slot] = req.output[-1]
        req.state = RequestState.DECODE

    def _stage_maintenance(self, now: Optional[float] = None) -> float:
        """Before a stage, in the reference's order: injected latency lands
        on the clock, the expiry sweep releases past-deadline work,
        preemption and the injected forced eviction reshape residency, and
        the admissible queue heads re-match the prefix index (requests
        submitted together find their donor's pages only once it has
        prefilled). Returns the stage clock."""
        if self.injector is not None:
            self.fault_delay += self.injector.latency_spike()
        tnow = self._now(now)
        for r in self.scheduler.sweep_expired(tnow):
            self._finish_abnormal(r, "expired", tnow)
        self._maybe_preempt(tnow)
        if (self.injector is not None and self.preemption != "none"
                and self.injector.forced_eviction()):
            self._forced_evict(tnow)
        if self.paged and self.prefix_share:
            for r in list(self.scheduler.queue)[:self.scheduler.max_prefill_seqs]:
                if r.saved_cache is None and not r.done:
                    self._match_prefix(r)
        return tnow

    def _page_admission_cap(self) -> int:
        """Paged admission: walk the queue in admission order, adding each
        candidate's page demand less the prefix pages it already shares, and
        admit the prefix that fits. Without preemption the demand is the
        whole lifetime of admitted and candidate work, so ``ensure_len``
        never fails; with it, only the next stage's growth and each
        candidate's first chunk (eviction reclaims the rest)."""
        page = self.kv.page_size
        conservative = self.preemption == "none"
        budget = self.prefill_chunk_tokens or self.kv.max_len
        need = (self._remaining_demand_pages() if conservative
                else self._stage_page_need())
        admit = 0
        for r in list(self.scheduler.queue)[:self.scheduler.max_prefill_seqs]:
            shared = len(r.shared_pages or ())
            if conservative:
                d = max(self._lifetime_pages(r) - shared, 0)
            else:
                total = min(r.l_in + len(r.output), self.kv.max_len)
                end = min(r.prefill_pos + budget, total)
                d = max(-(-end // page) - shared, 0)
            need += d + (1 if shared and self.prefix_share else 0)
            if self.kv.free_pages < need:
                break
            admit += 1
        return admit

    def _k_cold(self, mix: StageMix) -> int:
        """The planner's k_cold from the count EMA, rescaled to this stage's
        live tokens (one-stage-stale statistics)."""
        n = mix.num_tokens
        if not self.use_duplex or n == 0:
            return 0
        return self.planner.k_cold_static(self._expected_counts(n))

    # --------------------------------------------------------------- stages
    def _staging(self, name: str, shape, dtype) -> np.ndarray:
        """A zeroed host staging buffer from the current set, as an array to
        fill; ``_upload(name)`` sends it to the device, from pinned memory
        and without blocking on the card. ``dispatch_stage`` flips the two
        sets once a dispatch, so the set stage N+1 fills is stage N-1's.
        Two are enough: stage N-1's uploads precede its outputs' copies and
        event on the one stream, and that event has been waited for
        (``_materialize``) before stage N+1 is dispatched, since at most one
        stage is in flight beside the one being dispatched."""
        buf = self._host_buf(name, tuple(shape), _TORCH_DTYPES[np.dtype(dtype)]).numpy()
        buf.fill(0)
        return buf

    def _host_buf(self, name: str, shape, dtype) -> torch.Tensor:
        """A host tensor of the current staging set, pinned on the card: a
        view from the start of a block kept under ``name`` (grown, never
        shrunk, so steady state allocates nothing)."""
        bufs = self._staging_bufs[self._staging_idx]
        n = int(np.prod(shape))
        flat = bufs[name][0] if name in bufs else None
        if flat is None or flat.numel() < n or flat.dtype != dtype:
            flat = torch.empty((max(n, 1),), dtype=dtype,
                               pin_memory=self.device.type == "cuda")
        view = flat[:n].view(shape)
        bufs[name] = (flat, view)
        return view

    def _upload(self, name: str) -> torch.Tensor:
        """The current set's staging buffer ``name`` on the device."""
        buf = self._staging_bufs[self._staging_idx][name][1]
        if self.device.type != "cuda":
            return buf.clone()
        return buf.to(self.device, non_blocking=True)

    def _stage_outputs(self, fut: StageFuture) -> None:
        """Copy the stage's outputs to the host without blocking: on the card
        into pinned tensors of the current staging set, behind one event
        (``_materialize`` waits for it alone); on the CPU they are there."""
        outs = {k: v for k, v in (("nxt", fut.nxt), ("cn", fut.cn), ("cn_all", fut.cn_all),
                                  ("counts", fut.counts), ("legacy_nxt", fut.legacy_nxt))
                if v is not None}
        if self.device.type == "cuda":
            for k, v in outs.items():
                outs[k] = self._host_buf(f"o_{k}", v.shape, v.dtype)
                outs[k].copy_(v, non_blocking=True)
            fut.event = torch.cuda.Event()
            fut.event.record()
        fut.host = outs

    def _invoke(self, fn):
        """Run a stage's device step ``fn`` through the injector's
        transient-error schedule: each attempt may fail (a drawn step
        error), costing a retry and a virtual backoff; ``max_retries``
        consecutive failures raise InjectedStepError and the stage aborts.
        Every draw comes before ``fn`` touches the device, so a retry reads
        the cache the failed attempt would have."""
        if self.injector is not None:
            attempt = 0
            while self.injector.step_error():
                attempt += 1
                self.retries += 1
                self.fault_delay += self.injector.backoff(attempt)
                if attempt >= self.injector.max_retries:
                    raise InjectedStepError(
                        f"stage step failed {attempt} consecutive times "
                        f"(max_retries={self.injector.max_retries})")
        return fn()

    def _unique_page_bytes(self, slot_pages) -> int:
        seen = set()
        for s, n in slot_pages:
            seen.update(self.kv.block_tables[s, :n].tolist())
        seen.discard(0)
        return len(seen) * self.kv.page_size * self._kv_bytes_per_token

    def _decode_tokens(self, chain: Optional[ChainInfo]):
        """The decode rows' input tokens on the device, as a call for the
        step: the staged "d_tokens", or for a chained stage the gather of
        the previous stage's sampled tokens (its index arrays staged
        here)."""
        if chain is None:
            return lambda: self._upload("d_tokens")
        mode = chain.mode
        for name, a in (("c_src_nxt", chain.src_nxt), ("c_src_cn", chain.src_cn),
                        ("c_fallback", chain.fallback)):
            self._staging(name, a.shape, np.int32)[:] = a
        return lambda: _select_tokens(
            chain.prev_nxt, chain.prev_cn, self._upload("c_src_nxt"),
            self._upload("c_src_cn") if mode == "full" else None,
            self._upload("c_fallback") if mode != "pure" else None, mode)

    def _decode_inputs(self, slots, n_min: int = 0, proj: Optional[Dict[int, int]] = None):
        """Grow the decode slots' tables by one position (copying a shared
        page the write lands in) and stage their bucketed tokens, lengths
        and block tables ("d_tokens", "d_lengths", "d_bt"). A chained stage
        passes ``proj``, each slot's length once the in-flight stage
        commits, read in place of ``kv.lens``; its tokens come from the
        device. Returns the batch bucket and each slot's live page count."""
        page = self.kv.page_size
        live_pages = []
        for s in slots:
            cur = int(self.kv.lens[s]) if proj is None else proj[s]
            target = min(cur + 1, self.kv.max_len)
            self.kv.ensure_len(s, target)
            if self.prefix_share:
                # no write into a shared or indexed page: the write position
                # clamps to max_len - 1 as the attention step's does
                wpos = min(cur, self.kv.max_len - 1)
                self.kv.ensure_writable(s, wpos, wpos + 1)
            live_pages.append(-(-target // page))
        nb = _bucket(max(len(slots), n_min), self.decode_bs_buckets)
        mp = _bucket(max(live_pages + [1]), self.pages_buckets)
        tokens = self._staging("d_tokens", (nb, 1), np.int32) if proj is None else None
        lengths = self._staging("d_lengths", (nb,), np.int32)   # pad: length 0 -> null page
        bt = self._staging("d_bt", (nb, mp), np.int32)
        for i, s in enumerate(slots):
            if proj is None:
                tokens[i, 0] = self._tokens[s]
                lengths[i] = self.kv.lens[s]
            else:
                lengths[i] = proj[s]
            bt[i] = self.kv.block_tables[s, :mp]
        return nb, live_pages

    def _dense_decode_inputs(self, decision: StageDecision, chain: Optional[ChainInfo]) -> None:
        """The dense decode half's staged inputs: the live rows ("d_valid")
        and every slot's last token ("d_tokens", unless chained)."""
        valid = self._staging("d_valid", (self.kv.max_slots,), bool)
        for r in decision.decoding:
            valid[r.slot] = True
        if chain is None:
            self._staging("d_tokens", (self.kv.max_slots, 1), np.int32)[:, 0] = self._tokens

    def _dispatch_decode(self, fut: StageFuture) -> None:
        """A decode-only stage. Paged: the stage's rows, their tables grown.
        Dense: ALL slots (inactive rows' outputs are discarded and masked
        out of MoE routing, their cache rows overwritten on reuse, every
        row's whole cache streamed)."""
        decision, k_cold, chain = fut.plan.decision, fut.plan.k_cold, fut.plan.chain
        if self.paged:
            slots = [r.slot for r in decision.decoding]
            nb, live_pages = self._decode_inputs(
                slots, proj=chain.proj_lens if chain is not None else None)
            fut.kv_bytes = self._unique_page_bytes(zip(slots, live_pages))
            fut.moe_caps = caps = self._moe_caps(nb, k_cold)
            tokens = self._decode_tokens(chain)

            def step():
                lens_t = self._upload("d_lengths")
                logits, _, counts = decode_step(
                    self.params, self.cfg, tokens(), self.kv.cache,
                    {"lengths": lens_t, "block_tables": self._upload("d_bt"),
                     "valid": lens_t > 0},
                    plan=self._moe_plan(k_cold, caps[0], caps[1]))
                return sample(logits, self.sampling, self._gen), counts
        else:
            self._dense_decode_inputs(decision, chain)
            fut.kv_bytes = self._dense_kv_bytes_per_stage
            fut.moe_caps = caps = self._moe_caps(self.kv.max_slots, k_cold)
            tokens = self._decode_tokens(chain)

            def step():
                logits, _, counts = decode_step(
                    self.params, self.cfg, tokens(), self.kv.cache,
                    {"valid": self._upload("d_valid")},
                    plan=self._moe_plan(k_cold, caps[0], caps[1]))
                return sample(logits, self.sampling, self._gen), counts
        fut.nxt, fut.counts = self._invoke(step)

    def _dispatch_legacy_prefill(self, fut: StageFuture) -> None:
        """Monolithic whole-prompt prefill into a fresh local cache (stacks
        the unified stream cannot serve): prompts padded to a length bucket,
        rows to a row bucket, the grouped MoE plan. Slots are claimed and
        the local cache scattered at commit."""
        seqs = [c.req.token_stream(c.end) for c in fut.plan.decision.chunks]
        n_b = _bucket(len(seqs), self.seq_buckets)
        l_b = _bucket(max(len(sq) for sq in seqs), self.prefill_len_buckets)
        tokens = self._staging("lp_tokens", (n_b, l_b), np.int32)
        true_len = self._staging("lp_true_len", (n_b,), np.int32)
        for i, sq in enumerate(seqs):
            tokens[i, :len(sq)] = sq
            true_len[i] = len(sq)

        def step():
            plan = ExecutionPlan(moe_impl="grouped", use_kernels=self.use_kernels)
            cache = init_cache(self.cfg, n_b, self.kv.max_len, device=self.device,
                               kv_quant=self.kv.kv_quant)
            logits, cache = prefill(self.params, self.cfg, {"tokens": self._upload("lp_tokens")},
                                    cache, self._upload("lp_true_len"), plan=plan)
            return sample(logits, self.sampling, self._gen), cache
        fut.legacy_nxt, fut.legacy_cache = self._invoke(step)

    def _chunk_inputs(self, decision: StageDecision) -> Tuple[int, int]:
        """Claim the first chunks' slots (adopting a pinned shared prefix) and
        stage the bucketed chunk rows ("m_ctokens", "m_starts", "m_clens"); a
        verify span's row is its last sampled, not yet written token and then
        its draft, written at [start, end) as a chunk's would be. Returns the
        (rows, length) buckets."""
        chunks = decision.chunks
        for c in chunks:                       # the first chunk claims the slot
            if c.req.slot < 0:
                c.req.slot = self.kv.allocate()
                self._slot_req[c.req.slot] = c.req
                if c.req.shared_pages:
                    # the pin moves into the block table; the chunk starts at
                    # the first unshared position
                    self.kv.adopt_prefix(c.req.slot, c.req.shared_pages)
                    c.req.shared_pages = None
        nc_b = _bucket(len(chunks), self.seq_buckets)
        sc_b = _bucket(max(c.tokens for c in chunks), self.chunk_len_buckets)
        ctokens = self._staging("m_ctokens", (nc_b, sc_b), np.int32)
        starts = self._staging("m_starts", (nc_b,), np.int32)
        clens = self._staging("m_clens", (nc_b,), np.int32)
        for i, c in enumerate(chunks):
            if c.draft is not None:
                seq = c.req.token_stream(c.start + 1)[c.start:] + list(c.draft)
            else:
                seq = c.req.token_stream(c.end)[c.start:]
            ctokens[i, :len(seq)] = seq
            starts[i] = c.start
            clens[i] = c.tokens
        return nc_b, sc_b

    def _dispatch_mixed(self, fut: StageFuture) -> None:
        """A unified mixed stage: the first chunks claim their slots (undone
        by ``_abort_stage``), the tables grow, and one step runs the decode
        rows and the chunk rows (with verify spans, also the argmax at every
        chunk position). Dense: the decode half over every slot, the chunk
        rows at their slots, each chunk streaming its slot's whole row
        besides the decode's every row."""
        decision, k_cold, chain = fut.plan.decision, fut.plan.k_cold, fut.plan.chain
        chunks = decision.chunks
        nc_b, sc_b = self._chunk_inputs(decision)
        if self.paged:
            dslots = [r.slot for r in decision.decoding]
            nb, live_pages = self._decode_inputs(
                dslots, n_min=1, proj=chain.proj_lens if chain is not None else None)
            cpages = []
            for c in chunks:
                self.kv.ensure_len(c.req.slot, c.end)
                if self.prefix_share:
                    # copy a shared page the chunk writes into (the last page
                    # of a prompt shared whole)
                    self.kv.ensure_writable(c.req.slot, c.start, c.end)
                cpages.append(-(-c.end // self.kv.page_size))
            mpc = _bucket(max(cpages), self.pages_buckets)
            bt_c = self._staging("m_bt_c", (nc_b, mpc), np.int32)
            for i, c in enumerate(chunks):
                bt_c[i] = self.kv.block_tables[c.req.slot, :mpc]
            fut.kv_bytes = self._unique_page_bytes(
                list(zip(dslots, live_pages))
                + [(c.req.slot, n) for c, n in zip(chunks, cpages)])
            fut.moe_caps = caps = self._moe_caps(nb + nc_b * sc_b, k_cold)

            def ctx():
                lens_t = self._upload("d_lengths")
                return ({"lengths": lens_t, "block_tables": self._upload("d_bt"),
                         "valid": lens_t > 0},
                        {"starts": self._upload("m_starts"),
                         "chunk_lens": self._upload("m_clens"),
                         "block_tables": self._upload("m_bt_c")})
        else:
            cslots = self._staging("m_cslots", (nc_b,), np.int32)
            for i, c in enumerate(chunks):
                cslots[i] = c.req.slot
            self._dense_decode_inputs(decision, chain)
            fut.kv_bytes = (self._dense_kv_bytes_per_stage
                            + len(chunks) * self.kv.max_len * self._kv_bytes_per_token)
            fut.moe_caps = caps = self._moe_caps(self.kv.max_slots + nc_b * sc_b, k_cold)

            def ctx():
                return ({"valid": self._upload("d_valid")},
                        {"slots": self._upload("m_cslots"), "starts": self._upload("m_starts"),
                         "chunk_lens": self._upload("m_clens")})
        tokens = self._decode_tokens(chain)
        spec = any(c.draft is not None for c in chunks)

        def step():
            attn_ctx, chunk_ctx = ctx()
            out = mixed_step(
                self.params, self.cfg, tokens(), self._upload("m_ctokens"), self.kv.cache,
                attn_ctx=attn_ctx, chunk_ctx=chunk_ctx,
                plan=self._moe_plan(k_cold, caps[0], caps[1]), spec_tokens=spec)
            return (sample(out[0], self.sampling, self._gen),
                    sample(out[1], self.sampling, self._gen), out[3],
                    out[4] if spec else None)
        fut.nxt, fut.cn, fut.counts, fut.cn_all = self._invoke(step)

    def _row_live(self, r: Request) -> bool:
        """May an in-flight row's result be applied to ``r``? Not when it
        ended or was evicted between dispatch and commit (a cancel, an
        expiry, a preemption in the async loop; ``_stale``: evicted, even if
        since admitted again): its device work is discarded. A freed slot's
        stray KV write is harmless: the device runs it before any new
        owner's write, and a position not yet written is never read."""
        return (not r.done and r.slot >= 0 and self._slot_req.get(r.slot) is r
                and r.rid not in self._stale)

    def _stale_rows(self, plan: StagePlan) -> frozenset:
        """The rids of ``plan``'s rows whose requests were evicted after its
        dispatch (only the async loop evicts with a stage in flight)."""
        if self._evict_seq == plan.evict_seq:
            return frozenset()
        d = plan.decision
        return frozenset(r.rid for r in [c.req for c in d.chunks] + d.decoding
                         if self._evicted_at.get(r.rid, -1) >= plan.evict_seq)

    def _record(self, fut: StageFuture, r: Request, tok: int, tnow: float) -> None:
        """Commit one token to ``r`` (and to the stage's ``on_token`` list)."""
        r.record_token(tok, tnow)
        if self.on_token is not None:
            fut.emitted.append((r.rid, tok))

    def _commit_decode_rows(self, fut: StageFuture, nxt, tnow: float) -> None:
        """The decode rows' sampled tokens. Paged: row i is decoding[i] and
        the lengths advance; dense: the rows are the slots."""
        adv = []
        for i, r in enumerate(fut.plan.decision.decoding):
            if not self._row_live(r):
                continue
            tok = int(nxt[i if self.paged else r.slot])
            self._tokens[r.slot] = tok
            self._record(fut, r, tok, tnow)
            adv.append(r.slot)
        if adv and self.paged:
            self.kv.lens[np.asarray(adv)] += 1

    def _commit_mixed(self, fut: StageFuture, mat: Dict[str, Any], tnow: float) -> None:
        """Decode rows as a decode stage's; paged chunks set their lengths
        to their ends and (with sharing) index their full pages; each final
        chunk's sampled token is its request's first; then the verify
        spans."""
        decision = fut.plan.decision
        self._commit_decode_rows(fut, mat["nxt"], tnow)
        if self.paged:
            for c in decision.chunks:
                if c.draft is not None or not self._row_live(c.req):
                    continue
                self.kv.lens[c.req.slot] = c.end
                if self.prefix_share:
                    self.kv.register_prefix(c.req.slot, c.req.token_stream(c.end))
        cn = mat["cn"]
        for i, c in enumerate(decision.chunks):
            if c.is_last and self._row_live(c.req):
                tok = int(cn[i])
                self._tokens[c.req.slot] = tok
                self._record(fut, c.req, tok, tnow)
        if "cn_all" in mat:
            self._commit_spec(fut, mat["cn_all"], tnow)

    def _commit_spec(self, fut: StageFuture, cn_all, tnow: float) -> None:
        """The stage's verify spans. Position j of a span's argmax row is the
        greedy token after stream position start + j, what unspeculated
        decode would sample there; the span commits its longest agreeing
        draft prefix and the verifier's token at the first disagreement,
        stopping at EOS or the length cap (the trailing accepts are
        dropped). Its length is set to the span's end and rolled back to
        the committed tokens: paged by ``rewind`` (a finished request
        retires with its pages), dense by one ``rewind_dense`` a stage from
        staged indices, which no host sync waits for."""
        rw_slots: List[int] = []
        rw_lens: List[int] = []
        for i, c in enumerate(fut.plan.decision.chunks):
            r = c.req
            if c.draft is None or not self._row_live(r):
                continue
            row, draft = cn_all[i], c.draft
            a = 0
            while a < len(draft) and int(row[a]) == draft[a]:
                a += 1
            self.spec_proposed += len(draft)
            self.spec_accepted += a
            fut.spec_proposed += len(draft)
            fut.spec_accepted += a
            cand = list(draft[:a]) + [int(row[a])]
            m = 0
            for tok in cand:
                self._record(fut, r, tok, tnow)
                m += 1
                if r.done:
                    break
            # the last committed token stays unwritten, as after plain decode
            new_len = c.start + m
            if self.paged:
                self.kv.lens[r.slot] = c.end
                if r.done:
                    continue
                if new_len < c.end:
                    self.kv.rewind(r.slot, new_len)
                    self.spec_rewinds += 1
            else:
                if r.done:
                    continue
                if new_len < c.end:
                    rw_slots.append(r.slot)
                    rw_lens.append(new_len)
                    self.spec_rewinds += 1
            self._tokens[r.slot] = cand[m - 1]
        if rw_slots:
            # staged in the committed stage's set (no stage chains on a verify
            # span): the last upload from these buffers came before this
            # stage's dispatch, whose event has passed
            self._staging("rw_slots", (len(rw_slots),), np.int32)[:] = rw_slots
            self._staging("rw_lens", (len(rw_lens),), np.int32)[:] = rw_lens
            self.kv.rewind_dense(self._upload("rw_slots"), self._upload("rw_lens"))

    def _commit_legacy_prefill(self, fut: StageFuture, mat: Dict[str, Any],
                               tnow: float) -> None:
        """The legacy prefill's prompts claim slots, their local cache rows
        are scattered in and their first tokens recorded; a row whose
        request ended while the stage was in flight is dropped before any
        slot is claimed."""
        nxt = mat["legacy_nxt"]
        fresh = [c.req for c in fut.plan.decision.chunks]
        local, fut.legacy_cache = fut.legacy_cache, None
        live = [(i, r) for i, r in enumerate(fresh) if not r.done]
        if not live:
            return
        slots = [self.kv.allocate() for _ in live]
        take = torch.as_tensor([i for i, _ in live], device=self.device)
        self.kv.scatter(tree_map(local, lambda a: a[:, take]), slots)
        for (i, r), s in zip(live, slots):
            r.slot = s
            self._slot_req[s] = r
            tok = int(nxt[i])
            self._tokens[s] = tok
            self._record(fut, r, tok, tnow)

    def _abort_stage(self, decision: StageDecision) -> None:
        """Unwind a stage an injected fault interrupted. Lengths, tokens and
        scheduler positions move only at commit, so what is undone is the
        stage's admissions: a request whose first chunk claimed a slot gives
        it back (adopted prefix pages decref and survive under their other
        owners) and re-matches from scratch, and it and the restored
        migrations requeue at the head. Pages a continuing prefill's
        ``ensure_len`` already grew stay mapped (private; the retry reuses
        them), and a copy-on-write copy keeps its content, as in the
        reference. A legacy prefill claims slots only at commit, so its
        queued-time pins stay held."""
        self.stage_aborts += 1
        requeue: List[Request] = []
        for c in decision.chunks:
            if not c.first:
                continue                 # a continuing chunk keeps slot and position
            r = c.req
            if r.slot >= 0:
                self._slot_req.pop(r.slot, None)
                self.kv.free(r.slot)
                r.slot = -1
                r.shared_pages = None
                r.match_version = -1
                r.prefill_pos = 0
            r.state = RequestState.QUEUED
            r.prefill_target = None
            requeue.append(r)
        requeue.extend(decision.restored)
        for r in reversed(requeue):
            self.scheduler.queue.appendleft(r)
        for r in requeue:
            if r.saved_cache is None:
                self._match_prefix(r)

    def _run_audit(self) -> int:
        """Post-stage KV audit (with ``audit_stages``), with exact pin
        expectations: the queued requests' ``shared_pages`` are the only pin
        holders. Returns this stage's violation count."""
        if not self.audit_stages:
            return 0
        pins: Optional[Dict[int, int]] = None
        if self.paged:
            pins = {}
            for r in self.scheduler.queue:
                for pid in (r.shared_pages or ()):
                    pins[pid] = pins.get(pid, 0) + 1
        errs = self.kv.audit(pins=pins)
        if errs:
            self.audit_violations += len(errs)
            self.audit_log.extend(f"stage {self._stage_idx}: {e}" for e in errs)
        return len(errs)

    # ------------------------------------------------- plan / dispatch / commit
    def _finish_plan(self, decision: StageDecision, t0: float,
                     snap: Tuple[int, int, int, int], tnow: float,
                     speculative: bool = False) -> StagePlan:
        """Wrap a decision into a StagePlan with its k_cold (for a
        speculative plan the count EMA is one stage staler: the in-flight
        stage's counts fold in at its deferred commit, which moves the MoE's
        path choice, not the schedule) and its Op/B dispatch plan, host work
        on every stage with tokens, as in the reference."""
        mix = decision.mix()
        splan = (core_plan_stage(self.cfg, mix, kv_quant=self.kv.kv_quant)
                 if mix.num_tokens else None)
        return StagePlan(decision, self._k_cold(mix), t0, snap, tnow,
                         speculative=speculative, epoch=self._epoch, splan=splan)

    def _build_drafts(self) -> Optional[Dict[int, Tuple[int, List[int]]]]:
        """The drafter's proposals for the next stage: for each decoding
        row, up to ``spec_k`` tokens from its own stream, capped so that a
        verify span commits no more than ``max_new_tokens`` and fits
        ``max_len``; paged, also by the page slack left after the admitted
        work's next-stage growth (a draft never pushes ``ensure_len`` into
        a pool preemption thinks is fine), trimming a draft until its pages
        fit. Returns {rid: (start, draft)}, or None when nothing drafts."""
        drafts: Dict[int, Tuple[int, List[int]]] = {}
        slack = self.kv.free_pages - self._stage_page_need() if self.paged else 0
        for r in self.scheduler.running:
            if r.done or r.slot < 0 or r.state != RequestState.DECODE:
                continue
            start = int(self.kv.lens[r.slot]) if self.paged else r.l_in + len(r.output) - 1
            k = min(self.drafter.k, r.max_new_tokens - len(r.output) - 1,
                    self.kv.max_len - start - 1)
            if k < 1:
                continue
            toks = self.drafter.draft(r.token_stream())[:k]
            if not toks:
                continue
            if self.paged:
                base = self.kv.page_need(r.slot, start + 1)
                while toks:
                    extra = self.kv.page_need(r.slot, start + len(toks) + 1) - base
                    if extra <= slack:
                        slack -= extra
                        break
                    toks = toks[:-1]
                if not toks:
                    continue
            drafts[r.rid] = (start, toks)
        return drafts or None

    def plan_stage(self, now: Optional[float] = None, *, maintain: bool = True,
                   snap: Optional[Tuple[int, int, int, int]] = None) -> Optional[StagePlan]:
        """Stage maintenance (``maintain=False`` when the caller already ran
        it this turn: a plan formed again must not draw the fault schedule
        twice), the paged admission cap, the drafts and the scheduler's
        stage, from real state; host work only. None when no stage can be
        formed."""
        t0 = time.monotonic()
        if snap is None:
            snap = (self.shed, self.expired, self.cancelled, self.retries)
        tnow = self._stage_maintenance(now) if maintain else self._now(now)
        free = self.kv.free_slots
        if self.paged:
            free = min(free, self._page_admission_cap())
        drafts = self._build_drafts() if self.drafter is not None else None
        decision = self.scheduler.next_stage(free, drafts=drafts)
        if decision is None:
            return None
        return self._finish_plan(decision, t0, snap, tnow)

    @torch.no_grad()
    def dispatch_stage(self, plan: StagePlan) -> StageFuture:
        """Claim slots and pages, stage the inputs and enqueue the stage's
        device step and its outputs' copies to the host, without waiting
        for the device. A speculative plan activates its admissions first.
        An injected fault raises InjectedFault out of here; the caller
        unwinds with ``_abort_stage``."""
        if plan.speculative:
            self.scheduler.activate(plan.decision)
        plan.evict_seq = self._evict_seq
        self._staging_idx ^= 1
        fut = StageFuture(plan=plan)
        decision = plan.decision
        if decision.chunks and self._unified:
            self._dispatch_mixed(fut)
        else:
            # a dense stage: the decode over every slot first, then the
            # legacy prefill (the reference's dispatch order)
            if decision.decoding:
                self._dispatch_decode(fut)
            if decision.chunks:
                self._dispatch_legacy_prefill(fut)
        self._stage_outputs(fut)
        fut.t_dispatch = time.monotonic()
        if plan.chain is not None:
            # enqueued before the previous stage was read: no host gap
            self.gap_stages += 1
            self.chained_stages += 1
            self._t_sync_done = None
        elif self._t_sync_done is not None:
            # the host gap: from the previous stage's outputs reaching the
            # host to this enqueue, a window the device may sit idle
            self.host_gap_s += max(fut.t_dispatch - self._t_sync_done, 0.0)
            self.gap_stages += 1
            self._t_sync_done = None
        return fut

    def _materialize(self, fut: StageFuture) -> Dict[str, Any]:
        """The stage's one wait, for the event behind its outputs' copies
        (a stage enqueued after it runs on), then its tokens and router
        counts as arrays. The async loops call it outside the lock."""
        if fut.event is not None:
            fut.event.synchronize()
        mat = {k: v.numpy() for k, v in fut.host.items()}
        self._t_sync_done = time.monotonic()
        return mat

    def _commit_critical(self, fut: StageFuture, mat: Dict[str, Any]) -> None:
        """The durable commit: sampled tokens, lengths, the prefix index,
        migrated requests back (after the stage: its dense decode sweeps
        every slot and would advance a restored row), finished requests'
        slots freed, the scheduler advanced; then the stage's robustness
        deltas are frozen."""
        plan = fut.plan
        decision, tnow = plan.decision, plan.tnow
        self._stale = self._stale_rows(plan)
        if decision.chunks and self._unified:
            self._commit_mixed(fut, mat, tnow)
        else:
            if decision.decoding:
                self._commit_decode_rows(fut, mat["nxt"], tnow)
            if decision.chunks:
                self._commit_legacy_prefill(fut, mat, tnow)
        for r in decision.restored:
            if not r.done and r.saved_cache is not None:
                self._admit_restored(r)
        for r in [c.req for c in decision.chunks] + decision.decoding + decision.restored:
            # a request retired by an earlier commit no longer owns its slot
            if r.done and r.slot >= 0 and self._slot_req.get(r.slot) is r:
                self.kv.free(r.slot)
                del self._slot_req[r.slot]
        if self._stale:
            # an evicted row's request is queued for its replay: its span
            # must not move its prefill position or bring it back (the
            # reference does both, ROADMAP queue 3)
            decision = dataclasses.replace(
                decision, chunks=[c for c in decision.chunks if c.req.rid not in self._stale],
                decoding=[r for r in decision.decoding if r.rid not in self._stale])
            self._stale = frozenset()
        self.scheduler.commit_stage(decision)
        fut.deltas = (self.shed - plan.snap[0], self.expired - plan.snap[1],
                      self.cancelled - plan.snap[2], self.retries - plan.snap[3])

    def _commit_deferred(self, fut: StageFuture, counts) -> StageReport:
        """The ``on_token`` callbacks, then the accounting: the router-count
        EMA, the modelled MoE traffic, the StageReport and the post-stage
        audit."""
        plan = fut.plan
        decision, k_cold = plan.decision, plan.k_cold
        if self.on_token is not None and fut.emitted:
            for rid, tok in fut.emitted:
                self.on_token(rid, tok)
            fut.emitted = []
        counts_layer = self._update_counts(counts)
        chunk_tokens = sum(c.tokens for c in decision.chunks)
        live = len(decision.decoding) + chunk_tokens
        moe_bytes = moe_live = moe_padded = 0
        if (self.use_duplex and live and self._moe_layers and fut.moe_caps is not None
                and (k_cold > 0 or self.moe_ragged)):
            if counts_layer is not None and counts_layer.sum() > 0:
                dcounts = np.round(counts_layer).astype(np.int64)
            else:
                dcounts = np.round(self._expected_counts(live)).astype(np.int64)
            ch, cc, cb = fut.moe_caps
            st = moe_traffic_model(dcounts, k_cold=k_cold, c_hot=ch, c_cold=cc,
                                   d_model=self.cfg.d_model,
                                   d_ff=self.cfg.moe.d_ff_expert, c_block=cb,
                                   itemsize=self._param_itemsize)
            which = "ragged" if self.moe_ragged else "padded"
            moe_bytes = st[f"{which}_bytes"] * self._moe_layers
            moe_live = st["ragged_flops"] * self._moe_layers
            moe_padded = st["padded_flops"] * self._moe_layers
        shed, expired, cancelled, retries = fut.deltas
        report = StageReport(
            stage_index=self._stage_idx, is_mixed=decision.is_mixed,
            num_decode=len(decision.decoding), num_prefill=len(decision.chunks),
            k_cold=k_cold,
            bandwidth_flop_fraction=plan.splan.bandwidth_fraction() if plan.splan else 0.0,
            wall_time=time.monotonic() - plan.t0,
            kv_bytes_streamed=int(fut.kv_bytes), moe_bytes_streamed=int(moe_bytes),
            moe_flops_live=int(moe_live), moe_flops_padded=int(moe_padded),
            chunk_tokens=int(chunk_tokens), stage_tokens=int(live),
            shared_kv_pages=self.kv.shared_pages, shed=shed, expired=expired,
            cancelled=cancelled, retries=retries, spec_proposed=fut.spec_proposed,
            spec_accepted=fut.spec_accepted, audit_violations=self._run_audit())
        self.reports.append(report)
        self.peak_active = max(self.peak_active, len(decision.decoding)
                               + len(decision.chunks) + len(decision.restored))
        self._stage_idx += 1
        return report

    def _abort_report(self, plan: StagePlan) -> StageReport:
        """Report a stage ``_abort_stage`` unwound: nothing advanced."""
        decision = plan.decision
        report = StageReport(
            stage_index=self._stage_idx, is_mixed=decision.is_mixed,
            num_decode=len(decision.decoding), num_prefill=len(decision.chunks),
            k_cold=plan.k_cold, bandwidth_flop_fraction=0.0,
            wall_time=time.monotonic() - plan.t0, aborted=True,
            shed=self.shed - plan.snap[0], expired=self.expired - plan.snap[1],
            cancelled=self.cancelled - plan.snap[2],
            retries=self.retries - plan.snap[3], audit_violations=self._run_audit())
        self.reports.append(report)
        self._stage_idx += 1
        return report

    @torch.no_grad()
    def commit_stage(self, fut: StageFuture) -> StageReport:
        """Wait for a dispatched stage's outputs and commit it."""
        mat = self._materialize(fut)
        self._commit_critical(fut, mat)
        return self._commit_deferred(fut, mat.get("counts"))

    # ------------------------------------------------------------------ api
    def _now(self, now: Optional[float] = None) -> float:
        """The engine clock: the caller's virtual ``now`` or the host clock,
        plus the injected latency."""
        return (now if now is not None else time.monotonic()) + self.fault_delay

    def submit(self, req: Request, now: Optional[float] = None) -> None:
        """Queue ``req``. Raises AdmissionRejected when the bounded queue is
        full of live work; under the shedding policies the displaced
        requests end with reason "shed" and release what they hold. The
        prefix match runs after admission, so a rejected request holds no
        pin."""
        if req.l_in >= self.kv.max_len:
            raise ValueError(
                f"prompt of {req.l_in} tokens cannot fit max_len={self.kv.max_len} "
                f"KV (plus at least one generated token); prompts are never "
                f"silently truncated")
        with self._lock:
            tnow = self._now(now)
            try:
                shed = self.scheduler.submit(req, now=tnow)
            except AdmissionRejected:
                self.rejected += 1
                raise
            for victim in shed:
                self._finish_abnormal(victim, "shed", tnow)
            self._requests[req.rid] = req
            self._match_prefix(req)
            self._epoch += 1

    def cancel(self, rid: int, now: Optional[float] = None) -> bool:
        """Cancel a request wherever it is: dropped from the queue (its
        prefix pins released) or pulled out of prefill or decode with its
        slot and pages freed. False for an unknown or terminal request."""
        with self._lock:
            req = self._requests.get(rid)
            if req is None or req.done:
                return False
            self._finish_abnormal(req, "cancelled", self._now(now))
            return True

    def _finish_abnormal(self, req: Request, reason: str, tnow: float) -> None:
        """Cancel, shed or expire ``req``: detach it from the scheduler and
        release its slot (paged: its pages decref, a shared prefix survives
        under its other owners), its queued prefix pins and any saved
        cache."""
        self.scheduler.remove(req)
        if req.slot >= 0:
            self.kv.free(req.slot)
            self._slot_req.pop(req.slot, None)
            req.slot = -1
        if req.shared_pages:
            self.kv.unpin(req.shared_pages)
            req.shared_pages = None
        req.saved_cache = None
        req.finish(reason, tnow)
        self._epoch += 1
        if reason == "expired":
            self.expired += 1
        elif reason == "shed":
            self.shed += 1
        else:
            self.cancelled += 1

    def step(self, now: Optional[float] = None) -> Optional[StageReport]:
        """Plan, dispatch and commit one stage (None when nothing can run).
        ``now`` replaces the host clock (virtual time drives the deadlines
        deterministically). A stage an injected fault interrupts is unwound
        and reported with ``aborted=True``."""
        with self._lock:
            plan = self.plan_stage(now)
            if plan is None:
                return None
            try:
                fut = self.dispatch_stage(plan)
            except InjectedFault:
                self._abort_stage(plan.decision)
                return self._abort_report(plan)
            return self.commit_stage(fut)

    # ------------------------------------------------------ the async loop
    def _plan_speculative(self, cur: StagePlan) -> Optional[StagePlan]:
        """Plan stage N+1 from the projected post-commit state of the
        in-flight stage N, touching no scheduler or request state. Chunk
        positions advance to their span ends, length-limit finishes retire
        and free their slots, final chunks and restores join the decode
        set; an EOS finish cannot be foreseen and is taken as going on
        (``_validate_speculative`` or ``_build_chain`` catch it: a wrong
        guess costs a plan formed again, never a wrong token). Speculative
        decoding makes two cases misses: a stage in flight with verify spans
        (how much it accepts and rewinds is known only once read:
        "rewind"), and, with the drafter on, a projected stage with decode
        rows (their drafts must match committed tokens: "draft"); both are
        formed after the commit."""
        d = cur.decision
        if d.chunks and not self._unified:
            return None          # the legacy prefill claims its slots at commit
        if self._stale_rows(cur):
            # this turn's maintenance evicted a row of the stage in flight:
            # its commit drops the row, which no projection follows
            self.spec_misses += 1
            self._reject_spec("evicted")
            return None
        if any(c.draft is not None for c in d.chunks):
            self.spec_misses += 1
            self._reject_spec("rewind")
            return None
        t0 = time.monotonic()
        pos: Dict[int, int] = {}
        done_rids = set()
        finished_prefill = set()     # final chunks in flight: promoted at commit
        promoted: List[Request] = []
        extra_prefilling: List[Request] = []
        freed = 0
        for c in d.chunks:
            r = c.req
            if r.done:
                continue             # ended after dispatch; the commit drops the row
            if c.is_last:
                finished_prefill.add(r.rid)
                # the final chunk samples the first token: a length finish is
                # certain, an EOS finish is not
                if r.max_new_tokens <= 1:
                    done_rids.add(r.rid)
                    freed += 1
                else:
                    promoted.append(r)
            else:
                pos[r.rid] = c.end
                if r not in self.scheduler.prefilling:
                    extra_prefilling.append(r)     # admitted by the stage in flight
        for r in d.decoding:
            if not r.done and len(r.output) + 1 >= r.max_new_tokens:
                done_rids.add(r.rid)
                freed += 1
        restored_live = [r for r in d.restored if not r.done and r.saved_cache is not None]
        # the decode set in the order the commit builds it: surviving
        # decoders, then promoted final chunks, then restores
        running_proj = [r for r in self.scheduler.running
                        if r.state == RequestState.DECODE and r.rid not in done_rids]
        running_proj += promoted + restored_live
        if self.drafter is not None and running_proj:
            self.spec_misses += 1
            self._reject_spec("draft")
            return None
        prefilling_proj = ([r for r in self.scheduler.prefilling
                            if not r.done and r.rid not in finished_prefill]
                           + extra_prefilling)
        queue_proj = [r for r in self.scheduler.queue if not r.done]
        # predicted finishes free their slots at retire, restores claim
        # theirs at commit (the in-flight first chunks already hold theirs)
        free = max(self.kv.free_slots + freed - len(restored_live), 0)
        if self.paged:
            # the cap from current state; validation checks the real one
            free = min(free, self._page_admission_cap())
        decision = self.scheduler.plan_stage(free, prefilling=prefilling_proj,
                                             running=running_proj, queue=queue_proj, pos=pos)
        if decision is None:
            return None
        snap = (self.shed, self.expired, self.cancelled, self.retries)
        return self._finish_plan(decision, t0, snap, self._now(None), speculative=True)

    def _build_chain(self, spec: StagePlan, fut: StageFuture) -> Optional[ChainInfo]:
        """May speculative stage N+1 dispatch before stage N is read? Yes
        when each decode input token is known to the host or is a row of
        N's sampled tokens, and when what the dispatch claims (slots for
        admissions, pages for growth) fits the current pool: N's retires
        have not landed. Otherwise N+1 waits for N's commit and is
        validated then (one host gap, no plan formed again)."""
        d_prev, d = fut.plan.decision, spec.decision
        if d.restored or d_prev.restored:
            return None              # a restore writes its saved rows into the cache
        if any(c.draft is not None for c in d_prev.chunks + d.chunks):
            return None              # acceptance and rewinds are decided at commit
        if fut.nxt is None:
            return None
        n_first = sum(1 for c in d.chunks if c.first)
        if n_first:
            if n_first > self.kv.free_slots:
                return None
            if self.paged and n_first > self._page_admission_cap():
                return None
        # paged: N's nxt rows follow its decoding order; dense: its slots
        if self.paged:
            idx_nxt = {r.rid: i for i, r in enumerate(d_prev.decoding)}
        else:
            idx_nxt = {r.rid: r.slot for r in d_prev.decoding}
        idx_cn = {c.req.rid: i for i, c in enumerate(d_prev.chunks) if c.is_last}
        if self.paged:
            n = _bucket(max(len(d.decoding), 1) if d.chunks else len(d.decoding),
                        self.decode_bs_buckets)
        else:
            n = self.kv.max_slots
        src_n = np.full(n, -1, np.int32)
        src_c = np.full(n, -1, np.int32)
        fb = np.zeros(n, np.int32)
        proj: Dict[int, int] = {}
        page_need = 0
        for i, r in enumerate(d.decoding):
            if r.done or r.slot < 0 or self._slot_req.get(r.slot) is not r:
                # the row lost its slot since N was dispatched (an eviction
                # or expiry in this turn's maintenance): no chaining through
                # a dead or re-owned slot
                return None
            j = i if self.paged else r.slot
            if r.rid in idx_nxt:
                src_n[j] = idx_nxt[r.rid]
                plen = 1                 # N's commit advances the length by one
            elif r.rid in idx_cn:
                # a final chunk in N: its length jumps to the span's end and
                # its first token is N's cn row
                src_c[j] = idx_cn[r.rid]
                plen = None
            else:
                fb[j] = int(self._tokens[r.slot])
                plen = 0
            if self.paged:
                plen = (d_prev.chunks[idx_cn[r.rid]].end if plen is None
                        else int(self.kv.lens[r.slot]) + plen)
                proj[r.slot] = plen
                page_need += self.kv.page_need(r.slot, min(plen + 1, self.kv.max_len))
        if self.paged:
            for c in d.chunks:
                if c.req.slot >= 0:
                    page_need += self.kv.page_need(c.req.slot, c.end)
                else:
                    # a fresh admission, at most (adopting a prefix needs less)
                    page_need += -(-c.end // self.kv.page_size)
            if page_need > self.kv.free_pages:
                return None
        return ChainInfo(src_nxt=src_n, src_cn=src_c, fallback=fb, prev_nxt=fut.nxt,
                         prev_cn=fut.cn, proj_lens=proj)

    def _validate_speculative(self, spec: StagePlan, tnow: float) -> bool:
        """May a speculative plan that could not chain dispatch against the
        real post-commit state? Checks safety, not maximality: a plan that
        admits too little idles capacity for a stage, a stale span or slot
        would corrupt state. Any epoch bump since the plan rejects it."""
        if spec.epoch != self._epoch:
            return self._reject_spec("epoch")
        spec.tnow = tnow
        d = spec.decision
        for c in d.chunks:
            r = c.req
            if r.done:
                return self._reject_spec("chunk-done")
            if c.first:
                if r.saved_cache is not None or r not in self.scheduler.queue:
                    return self._reject_spec("admission-gone")
                total = len(r.prompt) + len(r.output)
                if self.scheduler.max_prefill_target is not None:
                    total = min(total, self.scheduler.max_prefill_target)
                start = min(r.prefill_pos, total - 1) if total > 0 else 0
                # a late prefix hit moves the start: form the plan again
                if start != c.start or c.target != total:
                    return self._reject_spec("admission-span")
            elif r not in self.scheduler.prefilling or r.prefill_pos != c.start:
                return self._reject_spec("chunk-position")
        for r in d.decoding:
            if (r.done or r.slot < 0 or r.state != RequestState.DECODE
                    or self._slot_req.get(r.slot) is not r):
                return self._reject_spec("decode-row")
        for r in d.restored:
            if r.done or r.saved_cache is None or r not in self.scheduler.queue:
                return self._reject_spec("restore-gone")
        admissions = sum(1 for c in d.chunks if c.first) + len(d.restored)
        if admissions:
            if admissions > self.kv.free_slots:
                return self._reject_spec("free-slots")
            if self.paged and admissions > self._page_admission_cap():
                return self._reject_spec("page-cap")
        return True

    def _reject_spec(self, reason: str) -> bool:
        """Count why a speculative plan was rejected
        (``stats()["spec_miss_reasons"]``) and reject it."""
        self.spec_miss_reasons[reason] = self.spec_miss_reasons.get(reason, 0) + 1
        return False

    def _pipeline_turn(self, fut: StageFuture, now: Optional[float] = None,
                       dispatch: bool = True
                       ) -> Tuple[Optional[StageFuture], Optional[StageReport], bool]:
        """One turn of the pipelined loop around the in-flight stage N: the
        turn's maintenance, N+1 planned from N's projection and, when it
        chains (``_build_chain``), dispatched before N is read; then N's
        one wait (outside the lock) and durable commit; a plan that could
        not chain is validated (or formed again) and dispatched behind the
        commit; N's accounting runs last. Returns (the stage now in flight,
        N's report, whether a stage was formed)."""
        new_fut = None
        aborted = None
        spec = None
        chained = False
        tnow = 0.0
        with self._lock:
            if dispatch:
                # the sync loop's per-stage draws (spikes, expiry,
                # preemption, prefix re-match), once a turn before planning
                tnow = self._stage_maintenance(now)
                spec = self._plan_speculative(fut.plan)
                if spec is not None:
                    spec.tnow = tnow
                    chain = self._build_chain(spec, fut)
                    if chain is not None:
                        spec.chain = chain
                        try:
                            new_fut = self.dispatch_stage(spec)
                            chained = True
                            self.spec_hits += 1
                        except InjectedFault:
                            self._abort_stage(spec.decision)
                            aborted = spec
                        spec = None
        mat = self._materialize(fut)
        with self._lock:
            self._commit_critical(fut, mat)
            formed = chained
            if dispatch and not chained and aborted is None:
                snapnow = (self.shed, self.expired, self.cancelled, self.retries)
                if spec is not None and self._validate_speculative(spec, tnow):
                    spec.snap = snapnow
                    self.spec_hits += 1
                    nxt_plan = spec
                else:
                    # the commit contradicted the projection, or nothing was
                    # projected: form the plan from real state (maintenance
                    # already ran this turn)
                    if spec is not None:
                        self.spec_misses += 1
                    nxt_plan = self.plan_stage(now, maintain=False, snap=snapnow)
                if nxt_plan is not None:
                    formed = True
                    try:
                        new_fut = self.dispatch_stage(nxt_plan)
                    except InjectedFault:
                        self._abort_stage(nxt_plan.decision)
                        aborted = nxt_plan
            report = self._commit_deferred(fut, mat.get("counts"))
            if aborted is not None:
                # N's report first, then the aborted N+1's
                self._abort_report(aborted)
        return new_fut, report, formed

    def _progress(self) -> int:
        """The watchdog's monotone progress: tokens generated plus requests
        terminal (outputs survive recompute preemption)."""
        return (sum(len(r.output) for r in self._requests.values())
                + sum(1 for r in self._requests.values() if r.done))

    def _stall_msg(self, why: str, inflight: bool = False) -> str:
        stuck = sorted(r.rid for r in (list(self.scheduler.queue)
                                       + self.scheduler.prefilling
                                       + self.scheduler.running) if not r.done)
        shown = ", ".join(map(str, stuck[:16])) + (", ..." if len(stuck) > 16 else "")
        msg = (f"engine stalled: {why}; stuck rids=[{shown}], "
               f"queue_depth={self.scheduler.pending}, "
               f"free_slots={self.kv.free_slots}/{self.kv.max_slots}, "
               f"preemption={self.preemption}")
        if self.paged:
            msg += f", free_pages={self.kv.free_pages}/{self.kv.num_pages - 1}"
        if inflight:
            msg += ", one stage in flight (dispatched, uncommitted)"
        return msg

    def run(self, requests: List[Request], *, max_stages: int = 10_000,
            stall_stages: int = 500, max_wall_s: Optional[float] = None) -> List[Request]:
        """Submit ``requests`` and step until every one is terminal. A
        request the bounded queue rejects ends with reason "rejected" and
        the rest go on; the watchdog raises EngineStalledError when no stage
        can be formed while work remains, when ``stall_stages`` stages pass
        without a token or a terminal request, or when the stage or wall
        budget runs out."""
        t_start = time.monotonic()
        for r in requests:
            try:
                self.submit(r)
            except AdmissionRejected:
                r.finish("rejected", self._now())
        stages = 0
        idle = 0
        last = self._progress()
        while self.scheduler.has_work:
            if stages >= max_stages:
                raise EngineStalledError(self._stall_msg(
                    f"max_stages={max_stages} exhausted with work pending"))
            if max_wall_s is not None and time.monotonic() - t_start > max_wall_s:
                raise EngineStalledError(self._stall_msg(
                    f"wall budget {max_wall_s}s exhausted"))
            if self.step() is None:
                if not self.scheduler.has_work:
                    break                   # drained by the expiry sweep
                raise EngineStalledError(self._stall_msg(
                    "no stage could be formed (capacity livelock — queued work "
                    "cannot be admitted and nothing is running)"))
            stages += 1
            prog = self._progress()
            if prog > last:
                last, idle = prog, 0
            else:
                idle += 1
                if idle >= stall_stages:
                    raise EngineStalledError(self._stall_msg(
                        f"no progress across {idle} consecutive stages"))
        return requests

    def run_async(self, requests: List[Request], *, max_stages: int = 10_000,
                  stall_stages: int = 500, max_wall_s: Optional[float] = None) -> List[Request]:
        """``run`` through the pipelined loop: while stage N runs on the
        device, the host plans and dispatches N+1 from N's projection and
        commits N's accounting behind it. Under greedy sampling a request's
        tokens are ``run``'s wherever the stage compositions agree; the
        planner's k_cold reads its count EMA one stage later, which with
        the duplex MoE may move which experts run a token. The watchdog is
        ``run``'s, its message noting a stage in flight."""
        t_start = time.monotonic()
        for r in requests:
            try:
                self.submit(r)
            except AdmissionRejected:
                r.finish("rejected", self._now())
        stages = 0
        idle = 0
        last = self._progress()
        fut: Optional[StageFuture] = None
        while True:
            if max_wall_s is not None and time.monotonic() - t_start > max_wall_s:
                raise EngineStalledError(self._stall_msg(
                    f"wall budget {max_wall_s}s exhausted", inflight=fut is not None))
            if fut is None:
                with self._lock:
                    if not self.scheduler.has_work:
                        break
                    if stages >= max_stages:
                        raise EngineStalledError(self._stall_msg(
                            f"max_stages={max_stages} exhausted with work pending"))
                    plan = self.plan_stage()
                    if plan is None:
                        if not self.scheduler.has_work:
                            break               # drained by the expiry sweep
                        raise EngineStalledError(self._stall_msg(
                            "no stage could be formed (capacity livelock — queued work "
                            "cannot be admitted and nothing is running)"))
                    try:
                        fut = self.dispatch_stage(plan)
                    except InjectedFault:
                        self._abort_stage(plan.decision)
                        self._abort_report(plan)
                    stages += 1
                continue
            fut, _, formed = self._pipeline_turn(fut, dispatch=stages < max_stages)
            stages += int(formed)
            prog = self._progress()
            if prog > last:
                last, idle = prog, 0
            else:
                idle += 1
                if idle >= stall_stages:
                    raise EngineStalledError(self._stall_msg(
                        f"no progress across {idle} consecutive stages",
                        inflight=fut is not None))
        return requests

    def step_async(self, now: Optional[float] = None) -> Optional[StageReport]:
        """One pipelined tick for an outside driver: commit the stage the
        previous tick left in flight, if any, and dispatch the next, leaving
        it in flight. Returns the committed stage's report (a tick behind
        ``step``), or None while priming or idle. Dropping ``_inflight``
        abandons device work without having moved anything durable. A stage
        in flight that admitted the last queued requests holds them outside
        the scheduler's lists until its commit, so an outside driver asks
        ``scheduler.has_work`` and ``_inflight`` both whether work is left."""
        fut, self._inflight = self._inflight, None
        if fut is not None:
            self._inflight, report, _ = self._pipeline_turn(fut, now)
            return report
        with self._lock:
            plan = self.plan_stage(now)
            if plan is None:
                return None
            try:
                self._inflight = self.dispatch_stage(plan)
            except InjectedFault:
                self._abort_stage(plan.decision)
                return self._abort_report(plan)
        return None

    #: cumulative counters stats() also reports as a window's deltas
    STATS_DELTA_KEYS = ("stages", "preemptions", "forced_evictions", "stage_aborts",
                        "retries", "shed", "expired", "cancelled", "rejected",
                        "audit_violations", "shared_tokens_skipped", "spec_proposed",
                        "spec_accepted")

    def stats(self, reset: bool = False) -> dict:
        """The engine's robustness and capacity totals, plus ``delta``: each
        STATS_DELTA_KEYS counter's change since the last
        ``stats(reset=True)``, which starts a new window (totals are never
        cleared); ``fault_counts`` with an injector; the async loop's
        ``spec_hits``, ``spec_misses``, ``spec_miss_reasons``,
        ``chained_stages``, ``host_gap_s`` and ``gap_stages`` (speculative
        planning); speculative decoding's ``spec_proposed``,
        ``spec_accepted``, ``spec_rewinds`` and ``spec_acceptance``."""
        with self._lock:
            out = {"stages": self._stage_idx,
                   "preemptions": self.preemptions,
                   "forced_evictions": self.forced_evictions,
                   "stage_aborts": self.stage_aborts,
                   "retries": self.retries,
                   "shed": self.shed,
                   "expired": self.expired,
                   "cancelled": self.cancelled,
                   "rejected": self.rejected,
                   "audit_violations": self.audit_violations,
                   "peak_active": self.peak_active,
                   "shared_tokens_skipped": self.shared_tokens_skipped,
                   "spec_hits": self.spec_hits,
                   "spec_misses": self.spec_misses,
                   "spec_miss_reasons": dict(self.spec_miss_reasons),
                   "spec_proposed": self.spec_proposed,
                   "spec_accepted": self.spec_accepted,
                   "spec_rewinds": self.spec_rewinds,
                   "spec_acceptance": self.spec_accepted / max(self.spec_proposed, 1),
                   "chained_stages": self.chained_stages,
                   "host_gap_s": self.host_gap_s,
                   "gap_stages": self.gap_stages,
                   "aging_promotions": self.scheduler.aging_promotions,
                   "kv": self.kv.stats()}
            out["delta"] = {k: out[k] - self._stats_base.get(k, 0)
                            for k in self.STATS_DELTA_KEYS}
            if reset:
                self._stats_base = {k: out[k] for k in self.STATS_DELTA_KEYS}
            if self.injector is not None:
                out["fault_counts"] = dict(self.injector.counts)
            return out
