"""Continuous-batching serving engine on the paged KV layout with the duplex
MoE (port of the synchronous, paged core of ``repro/serving/engine.py``).

Each stage is one unified token stream: the scheduler picks decode rows and
prefill chunk spans; the engine grows block tables on the host, stages the
inputs into bucketed shapes (powers of two, exactly the reference's
buckets — they decide the MoE capacities and so which tokens overflow),
runs ``mixed_step`` (any chunk this stage) or ``decode_step`` once, samples
greedily, and commits. The Duplex planner picks the stage's ``k_cold`` from
an EMA of the previous stages' actual router counts; on the device the
experts are re-ranked by the live counts and the cold / hot paths run the
GEMV / ragged GEMM kernels (or, with ``moe_ragged=False``, the
capacity-padded GEMV / GEMM kernels). With ``kv_quant`` the page pools hold
int8 K/V with float32 scales and the int8 attention kernels run.

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

from repro_torch.configs.base import MOE, ModelConfig
from repro_torch.core.costmodel import DUPLEX
from repro_torch.core.duplex_moe import default_capacities, moe_traffic_model
from repro_torch.core.execution import ExecutionPlan
from repro_torch.core.partition import DuplexPlanner, build_luts
from repro_torch.models.model import decode_step, mixed_step
from repro_torch.models.params import DTYPES
from repro_torch.serving.kvmanager import KVManager, kv_token_bytes
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import sample
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           StageDecision)

MAX_PREFILL_SEQS = 4     # chunk spans per stage (the reference's default)


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
    stage_tokens: int = 0        # live tokens through the MoE stream


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int, max_len: int,
                 kv_page_size: int, prefill_chunk_tokens: int,
                 use_duplex: bool = True, use_kernels: bool = True,
                 kv_quant: bool = False, moe_ragged: bool = True,
                 moe_c_block: int = 256, device="cuda"):
        """Greedy sampling only; the page pool holds every slot at max_len
        (plus the null page). ``kv_quant`` keeps the pages in int8 with
        float32 per-(token, KV head) scales. With ``use_kernels`` the
        attention kernels run, and the MoE runs the duplex ragged kernels,
        or with ``moe_ragged=False`` the capacity-padded ones; without
        ``use_duplex`` the MoE is the plain grouped path, as the reference
        runs XLA there."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine(device='cuda') but no CUDA device "
                               "is available; pass device='cpu' explicitly")
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, engine device is "
                             f"{self.device}")
        self.cfg = cfg
        # one float32 copy of the LM head table, made here instead of on
        # every stage (models/model.py::_lm_head)
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        self.params = dict(params, lm_head_f32=head["table"].float())
        self.kv = KVManager(cfg, max_slots, max_len, page_size=kv_page_size,
                            kv_quant=kv_quant, device=self.device)
        self.scheduler = ContinuousBatchingScheduler(
            max_prefill_seqs=MAX_PREFILL_SEQS,
            prefill_chunk_tokens=prefill_chunk_tokens, max_prefill_target=max_len)
        self.use_duplex = use_duplex and cfg.moe is not None
        self.use_kernels = use_kernels
        self.moe_ragged = bool(moe_ragged and use_kernels and self.use_duplex)
        self.moe_c_block = moe_c_block
        self.seq_buckets = tuple(sorted({1, 2, MAX_PREFILL_SEQS}
                                        | set(_pow2_buckets(MAX_PREFILL_SEQS))))
        self.chunk_len_buckets = _pow2_buckets(min(prefill_chunk_tokens, max_len))
        self.decode_bs_buckets = _pow2_buckets(max_slots)
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
        # streamed K+V bytes per live token over all layers, in the pools'
        # actual storage (int8 values plus their float32 scales when quantized)
        self._kv_bytes_per_token = kv_token_bytes(cfg, kv_quant=kv_quant) * cfg.num_layers
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

    def _lifetime_pages(self, req: Request) -> int:
        total = min(req.l_in + req.max_new_tokens, self.kv.max_len)
        return -(-total // self.kv.page_size)

    def _page_admission_cap(self) -> int:
        """Admit only what the pool can hold for its whole lifetime, after
        the already-admitted work's remaining demand (the reference's
        conservative, preemption-free branch), so ensure_len never fails."""
        need = 0
        for r in self.scheduler.running + self.scheduler.prefilling:
            if r.slot >= 0:
                need += max(self._lifetime_pages(r) - self.kv.slot_page_count(r.slot), 0)
        admit = 0
        for r in list(self.scheduler.queue)[:self.scheduler.max_prefill_seqs]:
            need += self._lifetime_pages(r)
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
        """Grow the decode slots' tables by one position and stage their
        bucketed (tokens, lengths, block tables). Returns the staged arrays
        and each slot's live page count."""
        page = self.kv.page_size
        live_pages = []
        for s in slots:
            target = min(int(self.kv.lens[s]) + 1, self.kv.max_len)
            self.kv.ensure_len(s, target)
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

    def _run_mixed(self, decision: StageDecision, k_cold: int):
        chunks = decision.chunks
        for c in chunks:                       # the first chunk claims the slot
            if c.req.slot < 0:
                c.req.slot = self.kv.allocate()
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
        dslots = [r.slot for r in decision.decoding]
        dtokens, lengths, bt, live_pages = self._decode_inputs(dslots, n_min=1)
        cpages = []
        for c in chunks:
            self.kv.ensure_len(c.req.slot, c.end)
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

    def _commit(self, decision: StageDecision, nxt, cn, tnow: float) -> None:
        adv = []
        for i, r in enumerate(decision.decoding):
            tok = int(nxt[i])
            self._tokens[r.slot] = tok
            r.record_token(tok, tnow)
            adv.append(r.slot)
        if adv:
            self.kv.lens[np.asarray(adv)] += 1
        for i, c in enumerate(decision.chunks):
            self.kv.lens[c.req.slot] = c.end
            if c.is_last:                      # final chunk -> first token
                tok = int(cn[i])
                self._tokens[c.req.slot] = tok
                c.req.record_token(tok, tnow)
        for r in [c.req for c in decision.chunks] + decision.decoding:
            if r.done and r.slot >= 0:
                self.kv.free(r.slot)
        self.scheduler.commit_stage(decision)

    def _report(self, decision: StageDecision, k_cold: int, counts, kv_bytes,
                caps, t0: float) -> StageReport:
        counts_layer = self._update_counts(counts)
        live = len(decision.decoding) + sum(c.tokens for c in decision.chunks)
        moe_bytes = moe_live = moe_padded = 0
        if self.use_duplex and live and (k_cold > 0 or self.moe_ragged):
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
            stage_tokens=int(live))
        self.reports.append(report)
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

    def step(self) -> Optional[StageReport]:
        """Plan, run and commit one stage; None when nothing can run."""
        t0 = time.monotonic()
        free = min(self.kv.free_slots, self._page_admission_cap())
        decision = self.scheduler.next_stage(free)
        if decision is None:
            return None
        k_cold = self._k_cold(decision)
        with torch.no_grad():
            if decision.chunks:
                nxt, cn, counts, kv_bytes, caps = self._run_mixed(decision, k_cold)
            else:
                nxt, cn, counts, kv_bytes, caps = self._run_decode(decision, k_cold)
            # the stage's only device sync: tokens and router counts
            nxt = nxt.cpu().numpy()
            cn = cn.cpu().numpy() if cn is not None else None
            counts = counts.cpu().numpy() if counts is not None else None
        self._commit(decision, nxt, cn, time.monotonic())
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
