"""KV-cache manager: slot bookkeeping plus the paged or the dense cache (port
of the paged and dense cores of ``repro/serving/kvmanager.py``).

Dense (``layout="dense"``): one cache sized ``max_slots x max_len`` for every
slot (Mamba layers: one state per slot); the manager tracks slot occupancy
and ``scatter``s freshly prefilled per-request caches into slot rows.

Paged (``layout="paged"``): K/V live in a shared pool of fixed-size pages on
the device; each sequence slot owns a block table (the page ids holding its
context), grown on demand by ``ensure_len`` and returned on ``free``. Page
0 is the reserved null page: tables are zero-filled and padded rows write
there, so a dummy row never touches a live sequence. Slot and page ids are handed out lowest
first from heaps. Every page has one owner in this slice (no prefix
sharing, no copy-on-write). With ``kv_quant`` the pools hold int8 values
plus float32 per-(token, KV head) scales (``kv_token_bytes`` is the byte
factor either way).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import MAMBA, ModelConfig
from repro_torch.models.model import init_cache
from repro_torch.models.params import DTYPES, tree_leaves


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def kv_token_bytes(cfg: ModelConfig, *, kv_quant: bool = False) -> int:
    """K+V bytes one cached token occupies in one attention layer, the fp32
    per-(token, KV head) scales included when quantized: ``2*KV*hd*itemsize``
    in the model's dtype, ``2*KV*(hd + 4)`` in int8."""
    item = 1 if kv_quant else DTYPES[cfg.dtype].itemsize
    scale_bytes = 4 if kv_quant else 0
    return 2 * cfg.num_kv_heads * (cfg.resolved_head_dim * item + scale_bytes)


def pages_for_budget(cfg: ModelConfig, page_size: int, budget_bytes: int, *,
                     kv_quant: bool = False) -> int:
    """How many pool pages (the null page not counted) fit ``budget_bytes``
    across all attention layers; int8 pools admit about twice the pages of
    bf16 ones at one budget."""
    n_attn = sum(seg.repeats for seg in cfg.segments
                 for kind in seg.pattern if kind.mixer != MAMBA)
    per_page = n_attn * page_size * kv_token_bytes(cfg, kv_quant=kv_quant)
    return max(budget_bytes // per_page, 0)


class KVManager:
    """Slots + the cache. Paged: ``block_tables`` (max_slots,
    max_pages_per_slot) int32 and ``lens`` (max_slots,) int32 are host arrays
    the engine stages into each stage's inputs; ``cache`` is the device pool.
    Dense: ``cache`` holds every slot's row; there are no pages."""

    def __init__(self, cfg: ModelConfig, max_slots: int, max_len: int, *,
                 layout: str = "paged", page_size: int = 64,
                 num_pages: Optional[int] = None, kv_quant: bool = False,
                 device="cuda"):
        if layout not in ("dense", "paged"):
            raise ValueError(f"layout must be 'dense' or 'paged', got {layout!r}")
        self.cfg = cfg
        self.kv_quant = kv_quant
        self.max_slots = max_slots
        self.max_len = max_len
        self.layout = layout
        self.paged = layout == "paged"
        self._free: List[int] = list(range(max_slots))
        self._active: set = set()
        if not self.paged:
            self.cache = init_cache(cfg, max_slots, max_len, device=device,
                                    kv_quant=kv_quant)
            return
        self.page_size = page_size
        self.max_pages_per_slot = _cdiv(max_len, page_size)
        if num_pages is None:
            # full dense capacity plus the null page
            num_pages = 1 + max_slots * self.max_pages_per_slot
        assert num_pages >= 2, "need at least the null page + one page"
        self.num_pages = num_pages
        self.cache = init_cache(cfg, page_size=page_size, num_pages=num_pages,
                                device=device, kv_quant=kv_quant)
        self._page_free: List[int] = list(range(1, num_pages))
        self._slot_pages: Dict[int, List[int]] = {}
        self.block_tables = np.zeros((max_slots, self.max_pages_per_slot), np.int32)
        self.lens = np.zeros((max_slots,), np.int32)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._page_free) if self.paged else 0

    @property
    def live_pages(self) -> int:
        return self.num_pages - 1 - len(self._page_free) if self.paged else 0

    def slot_page_count(self, slot: int) -> int:
        return len(self._slot_pages.get(slot, ()))

    def allocate(self) -> int:
        """Claim the lowest free slot, with an empty block table."""
        slot = heapq.heappop(self._free)
        self._active.add(slot)
        if self.paged:
            self._slot_pages[slot] = []
        return slot

    def free(self, slot: int) -> None:
        """Release a slot and its pages. Idempotent."""
        if slot not in self._active:
            return
        self._active.discard(slot)
        heapq.heappush(self._free, slot)
        if not self.paged:
            return
        for pid in self._slot_pages.pop(slot, []):
            heapq.heappush(self._page_free, pid)
        self.block_tables[slot] = 0
        self.lens[slot] = 0

    def ensure_len(self, slot: int, target_len: int) -> None:
        """Grow ``slot``'s block table to cover ``target_len`` positions
        (monotonic). Raises RuntimeError when the pool is exhausted."""
        assert self.paged and slot in self._active, slot
        pages = self._slot_pages[slot]
        need = _cdiv(max(target_len, 1), self.page_size)
        assert need <= self.max_pages_per_slot, (target_len, self.max_len)
        while len(pages) < need:
            if not self._page_free:
                raise RuntimeError(f"KV page pool exhausted ({self.num_pages} pages)")
            pid = heapq.heappop(self._page_free)
            self.block_tables[slot, len(pages)] = pid
            pages.append(pid)

    def scatter(self, local_cache, slots: Sequence[int]) -> None:
        """Dense layout: copy per-request caches (batch = len(slots)) into the
        slot rows ``slots``. Every cache leaf is laid out (layers, batch,
        ...)."""
        assert not self.paged, "paged prefill writes its pages in-stage"
        leaves = tree_leaves(self.cache)
        local = tree_leaves(local_cache)
        assert len(leaves) == len(local), (len(leaves), len(local))
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=leaves[0].device)
        for g, l in zip(leaves, local):
            g[:, idx] = l.to(g.dtype)

    def _total_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(self.cache))

    def bytes_per_slot(self) -> int:
        """Dense: the configured per-slot footprint. Paged: the live
        per-sequence footprint (live pages over active slots; one full-length
        slot's worth when idle)."""
        total = self._total_bytes()
        if not self.paged:
            return total // self.max_slots
        per_page = total // self.num_pages
        if self._active:
            return per_page * max(self.live_pages, 1) // len(self._active)
        return per_page * self.max_pages_per_slot
