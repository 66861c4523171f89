"""Continuous-batching serving engine with the duplex MoE (port of the
synchronous core of ``repro/serving/engine.py``), on the paged or the dense
KV layout, with prefix sharing and preemption.

Each stage is one token stream: the scheduler picks decode rows and prefill
spans; the engine stages the inputs into bucketed shapes (powers of two,
exactly the reference's buckets — they decide the MoE capacities and so
which tokens overflow), runs the model, samples greedily, and commits. The
Duplex planner picks the stage's ``k_cold`` from an EMA of the previous
stages' actual router counts; on the device the experts are re-ranked by
the live counts and the cold / hot paths run the GEMV / ragged GEMM kernels
(or, with ``moe_ragged=False``, the capacity-padded GEMV / GEMM kernels).

Full self-attention stacks run chunked (or, with
``prefill_chunk_tokens=None``, whole-prompt) spans and decode rows through
``mixed_step`` together, or ``decode_step`` when there is no span, on
either layout (``kv_layout`` None takes "paged"):

* paged: block tables grow on the host; the decode rows are the stage's
  rows. With ``kv_quant`` the page pools hold int8 K/V with float32 scales
  and the int8 attention kernels run. With ``prefix_share`` a queued
  prompt pins the resident pages of its full-page prefix, adopts them at
  admission and starts its prefill after them; a write into a shared page
  copies it first, and each chunk's full pages are indexed at commit.
* dense: every slot owns a ``max_len`` row; the decode half runs over all
  ``max_slots`` rows (dead rows masked out of MoE routing), and a chunk row
  names its slot.

Every other stack (Mamba or hybrid) takes the dense layout with
``prefill_chunk_tokens=None``: the dense decode over all rows first, then
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

Where the reference keys one jitted function per bucketed shape, the port
simply calls the model with the same bucketed shapes. The engine runs on
``device`` ("cuda" unless the caller asks for the CPU, as the tests do);
asking for CUDA without a card raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN, MAMBA, MOE, ModelConfig
from repro_torch.core.costmodel import DUPLEX
from repro_torch.core.duplex_moe import default_capacities, moe_traffic_model
from repro_torch.core.execution import ExecutionPlan
from repro_torch.core.partition import DuplexPlanner, build_luts
from repro_torch.models.model import decode_step, init_cache, mixed_step, prefill
from repro_torch.models.params import DTYPES, tree_map
from repro_torch.serving import preemption as pre
from repro_torch.serving.kvmanager import KVManager, kv_token_bytes
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.sampling import sample
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
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


@dataclass
class StageReport:
    stage_index: int
    is_mixed: bool
    num_decode: int
    num_prefill: int             # prefill-chunk rows this stage
    k_cold: int
    wall_time: float             # host clock, plan to commit
    kv_bytes_streamed: int = 0   # K+V bytes of the stage's live pages
    moe_bytes_streamed: int = 0  # modelled MoE bytes from the actual counts
    moe_flops_live: int = 0
    moe_flops_padded: int = 0
    chunk_tokens: int = 0        # prefill positions the stage's spans cover
    stage_tokens: int = 0        # live tokens through the MoE stream
    shared_kv_pages: int = 0     # pages mapped by more than one owner after it


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int, max_len: int,
                 kv_layout: Optional[str] = None, kv_page_size: int = 64,
                 kv_num_pages: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 use_duplex: bool = True, use_kernels: bool = True,
                 kv_quant: bool = False, moe_ragged: bool = True,
                 moe_c_block: int = 256, preemption: str = "none",
                 prefix_share: bool = False, device="cuda"):
        """Greedy sampling only. ``kv_layout`` None takes "paged" for a full
        self-attention stack and "dense" for the others. Paged: the page
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
        the reference."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine(device='cuda') but no CUDA device "
                               "is available; pass device='cpu' explicitly")
        if preemption not in ("none", "migrate", "recompute"):
            raise ValueError(f"preemption must be 'none', 'migrate' or 'recompute', "
                             f"got {preemption!r}")
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
        # needs a state carried across chunks, so those stacks keep the
        # legacy monolithic prefill (the reference's rule)
        self._unified = all(kind.mixer == ATTN
                            for seg in cfg.segments for kind in seg.pattern)
        if prefill_chunk_tokens is not None and not self._unified:
            raise NotImplementedError(
                "chunked prefill needs a full self-attention decoder stack "
                "(mamba/windowed/cross mixers still prefill monolithically)")
        if kv_layout is None:
            kv_layout = "paged" if self._unified else "dense"
        if not self._unified and kv_layout == "paged":
            raise ValueError("a Mamba or hybrid stack has no paged KV cache; use "
                             "kv_layout='dense' (the default for such a stack)")
        self.kv = KVManager(cfg, max_slots, max_len, layout=kv_layout,
                            page_size=kv_page_size, num_pages=kv_num_pages,
                            kv_quant=kv_quant, device=self.device)
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
            max_prefill_tokens=MAX_PREFILL_TOKENS)
        self.use_duplex = use_duplex and cfg.moe is not None
        self.use_kernels = use_kernels
        self.moe_ragged = bool(moe_ragged and use_kernels and self.use_duplex)
        self.moe_c_block = moe_c_block
        self.seq_buckets = tuple(sorted({1, 2, MAX_PREFILL_SEQS}
                                        | set(_pow2_buckets(MAX_PREFILL_SEQS))))
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
        # dense decode streams every slot's whole max_len row.
        n_attn = sum(seg.repeats for seg in cfg.segments
                     for kind in seg.pattern if kind.mixer != MAMBA)
        per_tok = kv_token_bytes(cfg, kv_quant=kv_quant)
        self._kv_bytes_per_token = per_tok * n_attn
        self._dense_kv_bytes_per_stage = max_slots * per_tok * n_attn * max_len
        self._moe_layers = sum(seg.repeats for seg in cfg.segments
                               for kind in seg.pattern if kind.ffn == MOE)
        self._param_itemsize = DTYPES[cfg.param_dtype].itemsize
        self._tokens = np.zeros((max_slots,), np.int32)   # last token per slot
        self._stage_idx = 0
        self.reports: List[StageReport] = []

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

    def _evict(self, victim: Request) -> None:
        if self.preemption == "migrate":
            pre.migrate_out(self.kv, victim)
        else:
            pre.recompute_out(self.kv, victim)
        self.scheduler.resubmit_preempted(victim)
        # the replay may re-match prefix pages that survived under other owners
        victim.match_version = -1
        self._match_prefix(victim)
        self.preemptions += 1

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
        self._tokens[slot] = req.output[-1]
        req.state = RequestState.DECODE

    def _stage_maintenance(self) -> None:
        """Before a stage, in the reference's order: preemption reshapes
        residency, then the admissible queue heads re-match the prefix
        index (requests submitted together find their donor's pages only
        once it has prefilled)."""
        self._maybe_preempt(time.monotonic())
        if self.paged and self.prefix_share:
            for r in list(self.scheduler.queue)[:self.scheduler.max_prefill_seqs]:
                if r.saved_cache is None:
                    self._match_prefix(r)

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

    def _k_cold(self, decision: StageDecision) -> int:
        """The planner's k_cold from the count EMA, rescaled to this stage's
        live tokens (one-stage-stale statistics)."""
        n = decision.mix().num_tokens
        if not self.use_duplex or n == 0:
            return 0
        return self.planner.k_cold_static(self._expected_counts(n))

    # --------------------------------------------------------------- stages
    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _unique_page_bytes(self, slot_pages) -> int:
        seen = set()
        for s, n in slot_pages:
            seen.update(self.kv.block_tables[s, :n].tolist())
        seen.discard(0)
        return len(seen) * self.kv.page_size * self._kv_bytes_per_token

    def _decode_inputs(self, slots, n_min: int = 0):
        """Grow the decode slots' tables by one position (copying a shared
        page the write lands in) and stage their bucketed (tokens, lengths,
        block tables). Returns the staged arrays and each slot's live page
        count."""
        page = self.kv.page_size
        live_pages = []
        for s in slots:
            cur = int(self.kv.lens[s])
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
        tokens = np.zeros((nb, 1), np.int32)
        lengths = np.zeros((nb,), np.int32)      # pad: length 0 -> null page
        bt = np.zeros((nb, mp), np.int32)
        for i, s in enumerate(slots):
            tokens[i, 0] = self._tokens[s]
            lengths[i] = self.kv.lens[s]
            bt[i] = self.kv.block_tables[s, :mp]
        return tokens, lengths, bt, live_pages

    def _run_decode(self, decision: StageDecision, k_cold: int):
        slots = [r.slot for r in decision.decoding]
        tokens, lengths, bt, live_pages = self._decode_inputs(slots)
        kv_bytes = self._unique_page_bytes(zip(slots, live_pages))
        caps = self._moe_caps(tokens.shape[0], k_cold)
        lens_t = self._t(lengths)
        logits, _, counts = decode_step(
            self.params, self.cfg, self._t(tokens), self.kv.cache,
            {"lengths": lens_t, "block_tables": self._t(bt), "valid": lens_t > 0},
            plan=self._moe_plan(k_cold, caps[0], caps[1]))
        return sample(logits), None, counts, kv_bytes, caps

    def _run_dense_decode(self, decision: StageDecision, k_cold: int):
        """Dense decode over ALL slots: inactive rows' outputs are discarded
        (and masked out of MoE routing), their cache rows are overwritten on
        reuse, and every row's whole cache is streamed."""
        valid = np.zeros((self.kv.max_slots,), bool)
        for r in decision.decoding:
            valid[r.slot] = True
        caps = self._moe_caps(self.kv.max_slots, k_cold)
        logits, _, counts = decode_step(
            self.params, self.cfg, self._t(self._tokens[:, None].copy()), self.kv.cache,
            {"valid": self._t(valid)}, plan=self._moe_plan(k_cold, caps[0], caps[1]))
        return sample(logits), counts, self._dense_kv_bytes_per_stage, caps

    def _run_legacy_prefill(self, decision: StageDecision):
        """Monolithic whole-prompt prefill into a fresh local cache (stacks
        the unified stream cannot serve): prompts padded to a length bucket,
        rows to a row bucket, the grouped MoE plan. Returns (first tokens,
        local cache); slots are claimed at commit."""
        seqs = [c.req.token_stream(c.end) for c in decision.chunks]
        n_b = _bucket(len(seqs), self.seq_buckets)
        l_b = _bucket(max(len(sq) for sq in seqs), self.prefill_len_buckets)
        tokens = np.zeros((n_b, l_b), np.int32)
        true_len = np.zeros((n_b,), np.int32)
        for i, sq in enumerate(seqs):
            tokens[i, :len(sq)] = sq
            true_len[i] = len(sq)
        plan = ExecutionPlan(moe_impl="grouped", use_kernels=self.use_kernels)
        cache = init_cache(self.cfg, n_b, self.kv.max_len, device=self.device)
        logits, cache = prefill(self.params, self.cfg, {"tokens": self._t(tokens)},
                                cache, self._t(true_len), plan=plan)
        return sample(logits), cache

    def _chunk_inputs(self, decision: StageDecision):
        """Claim the first chunks' slots (adopting a pinned shared prefix) and
        stage the bucketed chunk rows: (tokens, starts, chunk lens)."""
        chunks = decision.chunks
        for c in chunks:                       # the first chunk claims the slot
            if c.req.slot < 0:
                c.req.slot = self.kv.allocate()
                if c.req.shared_pages:
                    # the pin moves into the block table; the chunk starts at
                    # the first unshared position
                    self.kv.adopt_prefix(c.req.slot, c.req.shared_pages)
                    c.req.shared_pages = None
        nc_b = _bucket(len(chunks), self.seq_buckets)
        sc_b = _bucket(max(c.tokens for c in chunks), self.chunk_len_buckets)
        ctokens = np.zeros((nc_b, sc_b), np.int32)
        starts = np.zeros((nc_b,), np.int32)
        clens = np.zeros((nc_b,), np.int32)
        for i, c in enumerate(chunks):
            seq = c.req.token_stream(c.end)[c.start:]
            ctokens[i, :len(seq)] = seq
            starts[i] = c.start
            clens[i] = c.tokens
        return ctokens, starts, clens

    def _run_mixed(self, decision: StageDecision, k_cold: int):
        chunks = decision.chunks
        ctokens, starts, clens = self._chunk_inputs(decision)
        nc_b, sc_b = ctokens.shape
        dslots = [r.slot for r in decision.decoding]
        dtokens, lengths, bt, live_pages = self._decode_inputs(dslots, n_min=1)
        cpages = []
        for c in chunks:
            self.kv.ensure_len(c.req.slot, c.end)
            if self.prefix_share:
                # copy a shared page the chunk writes into (the last page
                # of a prompt shared whole)
                self.kv.ensure_writable(c.req.slot, c.start, c.end)
            cpages.append(-(-c.end // self.kv.page_size))
        mpc = _bucket(max(cpages), self.pages_buckets)
        bt_c = np.zeros((nc_b, mpc), np.int32)
        for i, c in enumerate(chunks):
            bt_c[i] = self.kv.block_tables[c.req.slot, :mpc]
        kv_bytes = self._unique_page_bytes(
            list(zip(dslots, live_pages)) + [(c.req.slot, n) for c, n in zip(chunks, cpages)])
        caps = self._moe_caps(dtokens.shape[0] + nc_b * sc_b, k_cold)
        lens_t = self._t(lengths)
        dl, cl, _, counts = mixed_step(
            self.params, self.cfg, self._t(dtokens), self._t(ctokens), self.kv.cache,
            attn_ctx={"lengths": lens_t, "block_tables": self._t(bt),
                      "valid": lens_t > 0},
            chunk_ctx={"starts": self._t(starts), "chunk_lens": self._t(clens),
                       "block_tables": self._t(bt_c)},
            plan=self._moe_plan(k_cold, caps[0], caps[1]))
        return sample(dl), sample(cl), counts, kv_bytes, caps

    def _run_dense_mixed(self, decision: StageDecision, k_cold: int):
        """Dense mixed stage: the decode half over every slot, the chunk rows
        at their slots; each chunk streams its slot's whole row besides the
        decode's every row."""
        chunks = decision.chunks
        ctokens, starts, clens = self._chunk_inputs(decision)
        nc_b, sc_b = ctokens.shape
        cslots = np.zeros((nc_b,), np.int32)
        for i, c in enumerate(chunks):
            cslots[i] = c.req.slot
        valid = np.zeros((self.kv.max_slots,), bool)
        for r in decision.decoding:
            valid[r.slot] = True
        kv_bytes = (self._dense_kv_bytes_per_stage
                    + len(chunks) * self.kv.max_len * self._kv_bytes_per_token)
        caps = self._moe_caps(self.kv.max_slots + nc_b * sc_b, k_cold)
        dl, cl, _, counts = mixed_step(
            self.params, self.cfg, self._t(self._tokens[:, None].copy()),
            self._t(ctokens), self.kv.cache, attn_ctx={"valid": self._t(valid)},
            chunk_ctx={"slots": self._t(cslots), "starts": self._t(starts),
                       "chunk_lens": self._t(clens)},
            plan=self._moe_plan(k_cold, caps[0], caps[1]))
        return sample(dl), sample(cl), counts, kv_bytes, caps

    def _commit(self, decision: StageDecision, nxt, cn, tnow: float,
                legacy=None) -> None:
        """Apply a stage's sampled tokens. Paged: decode rows are the stage's
        rows, lengths advance, chunks set theirs and (with sharing) index
        their full pages. Dense: decode rows are the slots; ``legacy`` =
        (first tokens, local cache) of a legacy prefill, whose prompts
        claim slots here and get their rows. Then migrated requests come
        back (after the stage: its dense decode sweeps every slot and would
        advance a restored row), finished requests free their slots, and
        the scheduler advances."""
        adv = []
        for i, r in enumerate(decision.decoding):
            tok = int(nxt[r.slot if not self.paged else i])
            self._tokens[r.slot] = tok
            r.record_token(tok, tnow)
            adv.append(r.slot)
        if adv and self.paged:
            self.kv.lens[np.asarray(adv)] += 1
        if legacy is not None:
            first, local = legacy
            n = len(decision.chunks)
            slots = [self.kv.allocate() for _ in range(n)]
            self.kv.scatter(tree_map(local, lambda a: a[:, :n]), slots)
            for i, (c, s) in enumerate(zip(decision.chunks, slots)):
                c.req.slot = s
                tok = int(first[i])
                self._tokens[s] = tok
                c.req.record_token(tok, tnow)
        else:
            if self.paged:
                for c in decision.chunks:
                    self.kv.lens[c.req.slot] = c.end
                    if self.prefix_share:
                        self.kv.register_prefix(c.req.slot, c.req.token_stream(c.end))
            for i, c in enumerate(decision.chunks):
                if c.is_last:                  # final chunk -> first token
                    tok = int(cn[i])
                    self._tokens[c.req.slot] = tok
                    c.req.record_token(tok, tnow)
        for r in decision.restored:
            self._admit_restored(r)
        for r in [c.req for c in decision.chunks] + decision.decoding + decision.restored:
            if r.done and r.slot >= 0:
                self.kv.free(r.slot)
        self.scheduler.commit_stage(decision)

    def _report(self, decision: StageDecision, k_cold: int, counts, kv_bytes,
                caps, t0: float) -> StageReport:
        counts_layer = self._update_counts(counts)
        chunk_tokens = sum(c.tokens for c in decision.chunks)
        live = len(decision.decoding) + chunk_tokens
        moe_bytes = moe_live = moe_padded = 0
        if (self.use_duplex and live and self._moe_layers and caps is not None
                and (k_cold > 0 or self.moe_ragged)):
            if counts_layer is not None and counts_layer.sum() > 0:
                dcounts = np.round(counts_layer).astype(np.int64)
            else:
                dcounts = np.round(self._expected_counts(live)).astype(np.int64)
            ch, cc, cb = caps
            st = moe_traffic_model(dcounts, k_cold=k_cold, c_hot=ch, c_cold=cc,
                                   d_model=self.cfg.d_model,
                                   d_ff=self.cfg.moe.d_ff_expert, c_block=cb,
                                   itemsize=self._param_itemsize)
            which = "ragged" if self.moe_ragged else "padded"
            moe_bytes = st[f"{which}_bytes"] * self._moe_layers
            moe_live = st["ragged_flops"] * self._moe_layers
            moe_padded = st["padded_flops"] * self._moe_layers
        report = StageReport(
            stage_index=self._stage_idx, is_mixed=decision.is_mixed,
            num_decode=len(decision.decoding), num_prefill=len(decision.chunks),
            k_cold=k_cold, wall_time=time.monotonic() - t0,
            kv_bytes_streamed=int(kv_bytes), moe_bytes_streamed=int(moe_bytes),
            moe_flops_live=int(moe_live), moe_flops_padded=int(moe_padded),
            chunk_tokens=int(chunk_tokens), stage_tokens=int(live),
            shared_kv_pages=self.kv.shared_pages)
        self.reports.append(report)
        self.peak_active = max(self.peak_active, len(decision.decoding)
                               + len(decision.chunks) + len(decision.restored))
        self._stage_idx += 1
        return report

    # ------------------------------------------------------------------ api
    def submit(self, req: Request) -> None:
        if req.l_in >= self.kv.max_len:
            raise ValueError(
                f"prompt of {req.l_in} tokens cannot fit max_len={self.kv.max_len} "
                f"KV (plus at least one generated token); prompts are never "
                f"silently truncated")
        self.scheduler.submit(req)
        self._match_prefix(req)

    def step(self) -> Optional[StageReport]:
        """Plan, run and commit one stage; None when nothing can run."""
        t0 = time.monotonic()
        self._stage_maintenance()
        free = self.kv.free_slots
        if self.paged:
            free = min(free, self._page_admission_cap())
        decision = self.scheduler.next_stage(free)
        if decision is None:
            return None
        k_cold = self._k_cold(decision)
        nxt = cn = counts = caps = legacy = None
        kv_bytes = 0
        with torch.no_grad():
            if decision.chunks and self._unified:
                run = self._run_mixed if self.paged else self._run_dense_mixed
                nxt, cn, counts, kv_bytes, caps = run(decision, k_cold)
            elif self.paged:
                if decision.decoding:
                    nxt, cn, counts, kv_bytes, caps = self._run_decode(decision, k_cold)
            else:
                # a dense stage: the decode over every slot first, then the
                # legacy prefill (the reference's dispatch order)
                if decision.decoding:
                    nxt, counts, kv_bytes, caps = self._run_dense_decode(decision, k_cold)
                if decision.chunks:
                    legacy = self._run_legacy_prefill(decision)
            # the stage's only device sync: tokens and router counts
            nxt = nxt.cpu().numpy() if nxt is not None else None
            cn = cn.cpu().numpy() if cn is not None else None
            counts = counts.cpu().numpy() if counts is not None else None
            if legacy is not None:
                legacy = (legacy[0].cpu().numpy(), legacy[1])
            self._commit(decision, nxt, cn, time.monotonic(), legacy)
        return self._report(decision, k_cold, counts, kv_bytes, caps, t0)

    def run(self, requests: List[Request], *, max_stages: int = 100_000) -> List[Request]:
        """Submit ``requests`` and step until every one is done."""
        for r in requests:
            self.submit(r)
        stages = 0
        while self.scheduler.has_work:
            if stages >= max_stages or self.step() is None:
                raise RuntimeError(
                    f"engine stalled after {stages} stages with "
                    f"{len(self.scheduler.queue)} queued, "
                    f"{len(self.scheduler.running)} running, "
                    f"{self.kv.free_pages} free pages")
            stages += 1
        return requests
