"""KV-cache manager: slot bookkeeping plus the paged or the dense cache (port
of ``repro/serving/kvmanager.py``).

Dense (``layout="dense"``): one cache sized ``max_slots x max_len`` for every
slot (Mamba layers: one state per slot); the manager tracks slot occupancy
and ``scatter``s freshly prefilled per-request caches into slot rows.

Paged (``layout="paged"``): K/V live in a shared pool of fixed-size pages on
the device; each sequence slot owns a block table (the page ids holding its
context), grown on demand by ``ensure_len``. Page 0 is the reserved null
page: tables are zero-filled and padded rows write there, so a dummy row
never touches a live sequence. Slot and page ids are handed out lowest
first from heaps. With ``kv_quant`` the pools hold int8 values plus float32
per-(token, KV head) scales (``kv_token_bytes`` is the byte factor either
way).

Pages are refcounted and copy-on-write. A page with refcount 1 is private
and written in place; one with refcount > 1 is mapped into several block
tables (or pinned by a queued request) and is immutable: a write goes
through ``ensure_writable``, which copies it into a private page first.
``free`` decrefs, so a shared prefix survives under its other owners. Full
pages are indexed by their token ids, each key the hash of the page's
tokens chained on its predecessor's key (``_chain_keys``), so a new prompt
can ``match_prefix`` / ``pin_prefix`` the resident pages of its prefix and
``adopt_prefix`` them into its block table; ``register_prefix`` indexes a
slot's full pages at commit and merges a duplicate of an indexed page onto
it. The keys are ``hash`` of tuples of Python ints, the same in every
process, so both packages walk the same chain. ``audit`` lists every broken
invariant. With a ``FaultInjector``, ``_alloc_page`` may raise
``InjectedPageFault`` (drawn first, so a faulted allocation changes
nothing). Speculative decoding rolls a slot back after a verify span's
rejected tail: ``rewind`` on the paged layout, ``rewind_dense`` on the
dense one.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MAMBA, ModelConfig
from repro_torch.models.model import init_cache
from repro_torch.models.params import DTYPES, tree_leaves
from repro_torch.serving.faults import InjectedPageFault


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
                 device="cuda", injector=None):
        if layout not in ("dense", "paged"):
            raise ValueError(f"layout must be 'dense' or 'paged', got {layout!r}")
        self.cfg = cfg
        # fault injection: with an injector, ``_alloc_page`` may raise
        # InjectedPageFault instead of allocating (None: never)
        self.injector = injector
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
        # page id -> refcount (>= 1 for every allocated page; absent = free);
        # a pinned, not yet adopted prefix match holds a reference too
        self._page_refs: Dict[int, int] = {}
        # the prefix index: chain key -> page id, its reverse, and the exact
        # (previous key, tokens) each key stands for, so that a hash
        # collision never aliases two prefixes
        self._hash_page: Dict[int, int] = {}
        self._page_hash: Dict[int, int] = {}
        self._page_key: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        # bumped whenever the index gains or loses an entry, so queued
        # requests are re-matched only against a changed index
        self.index_version = 0
        self.cow_copies = 0
        self.dedup_merges = 0
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
        """Unique allocated pages: a page in five block tables counts once."""
        return len(self._page_refs) if self.paged else 0

    @property
    def shared_pages(self) -> int:
        """Pages mapped (or pinned) by more than one owner."""
        if not self.paged:
            return 0
        return sum(1 for c in self._page_refs.values() if c > 1)

    def page_ref(self, pid: int) -> int:
        """Refcount of page ``pid`` (0 when free)."""
        return self._page_refs.get(pid, 0)

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
        """Release a slot. Paged: decref each of its pages; pages shared with
        other slots (or pinned) stay resident and indexed. Idempotent."""
        if slot not in self._active:
            return
        self._active.discard(slot)
        heapq.heappush(self._free, slot)
        if not self.paged:
            return
        for pid in self._slot_pages.pop(slot, []):
            self._decref(pid)
        self.block_tables[slot] = 0
        self.lens[slot] = 0

    # ---- page refcounts ------------------------------------------------------
    def _alloc_page(self) -> int:
        # drawn before the pool check and before any state or device change,
        # so a faulted allocation leaves the manager as it was
        if self.injector is not None and self.injector.page_alloc_fails():
            raise InjectedPageFault(f"injected page-allocation failure "
                                    f"({self.free_pages} pages actually free)")
        if not self._page_free:
            raise RuntimeError(
                f"KV page pool exhausted ({self.num_pages} pages, {self.live_pages} "
                f"live): raise num_pages, enable preemption, or free sequences first")
        pid = heapq.heappop(self._page_free)
        self._page_refs[pid] = 1
        return pid

    def _decref(self, pid: int) -> None:
        refs = self._page_refs.get(pid, 0)
        assert refs > 0, f"double free of page {pid}"
        if refs > 1:
            self._page_refs[pid] = refs - 1
            return
        del self._page_refs[pid]
        self._deindex(pid)
        heapq.heappush(self._page_free, pid)

    def _deindex(self, pid: int) -> None:
        h = self._page_hash.pop(pid, None)
        if h is not None:
            self._hash_page.pop(h, None)
            self._page_key.pop(pid, None)
            self.index_version += 1

    # ---- paged capacity ------------------------------------------------------
    def page_need(self, slot: int, target_len: int) -> int:
        """Fresh pages ``ensure_len(slot, target_len)`` would allocate now."""
        assert self.paged and slot in self._active, slot
        need = _cdiv(max(target_len, 1), self.page_size)
        return max(need - len(self._slot_pages[slot]), 0)

    def ensure_len(self, slot: int, target_len: int) -> None:
        """Grow ``slot``'s block table to cover ``target_len`` positions
        (monotonic) with private pages. Raises RuntimeError when the pool is
        exhausted."""
        assert self.paged and slot in self._active, slot
        pages = self._slot_pages[slot]
        need = _cdiv(max(target_len, 1), self.page_size)
        assert need <= self.max_pages_per_slot, (target_len, self.max_len)
        while len(pages) < need:
            pid = self._alloc_page()
            self.block_tables[slot, len(pages)] = pid
            pages.append(pid)

    def ensure_writable(self, slot: int, start: int, end: int) -> int:
        """Make write positions [start, end) of ``slot`` private: a page
        there with refcount > 1 is copied into a fresh page (its block-table
        entry swapped, the original decref'd); a private page still in the
        index leaves it (an indexed page must keep matching its tokens).
        Returns the pages copied. ``ensure_len`` must already cover ``end``."""
        if end <= start:
            return 0
        assert self.paged and slot in self._active, slot
        pages = self._slot_pages[slot]
        first, last = start // self.page_size, _cdiv(end, self.page_size)
        assert last <= len(pages), (slot, start, end, len(pages))
        copied = 0
        for idx in range(first, last):
            pid = pages[idx]
            if self._page_refs.get(pid, 0) > 1:
                new = self._alloc_page()
                self._copy_page(pid, new)
                pages[idx] = new
                self.block_tables[slot, idx] = new
                self._decref(pid)
                self.cow_copies += 1
                copied += 1
            else:
                self._deindex(pid)
        return copied

    def rewind(self, slot: int, new_len: int) -> int:
        """Roll ``slot``'s length back to ``new_len`` after a verify span's
        rejected tail (speculative decoding), by page-table surgery: pages
        wholly past the new length leave the block table and are decref'd
        (a shared page survives under its other owners and stays indexed).
        The kept boundary page, when partial and private, leaves the index,
        since decode will overwrite its tail; a shared one is copied on the
        next write by ``ensure_writable``. Returns the entries released."""
        assert self.paged and slot in self._active, slot
        cur = int(self.lens[slot])
        assert 0 <= new_len <= cur, (slot, new_len, cur)
        pages = self._slot_pages[slot]
        keep = _cdiv(new_len, self.page_size) if new_len else 0
        released = 0
        while len(pages) > keep:
            pid = pages.pop()
            self.block_tables[slot, len(pages)] = 0
            self._decref(pid)
            released += 1
        if keep and new_len < keep * self.page_size:
            pid = pages[keep - 1]
            if self._page_refs.get(pid, 0) == 1:
                self._deindex(pid)
        self.lens[slot] = new_len
        return released

    def rewind_dense(self, slots, new_lens) -> None:
        """The dense layout's rewind: set the slots' device-side lengths
        (every attention block's "len" leaf) to ``new_lens``, in place.
        ``slots`` and ``new_lens`` are sequences, or index tensors already
        on the cache's device (the engine stages them, so nothing waits for
        the card). K/V past the new length is masked by position and
        overwritten as decode goes on."""
        assert not self.paged
        lens = [b["len"] for seg in self.cache for b in seg["blocks"] if "len" in b]
        if not lens:
            return
        dev = lens[0].device
        sl = torch.as_tensor(slots, dtype=torch.long, device=dev)
        nl = torch.as_tensor(new_lens, device=dev)
        for leaf in lens:
            leaf.index_copy_(1, sl, nl.to(leaf.dtype)[None].expand(leaf.shape[0], -1))

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one pool page on the device, in place, in every leaf (K/V and
        scale pools alike are laid out (layers, num_pages, ...))."""
        for leaf in tree_leaves(self.cache):
            leaf[:, dst].copy_(leaf[:, src])

    # ---- prefix sharing ------------------------------------------------------
    def _chain_keys(self, tokens: Sequence[int]):
        """(page index, chain key, (previous key, token tuple)) for each full
        page of ``tokens``; equal keys mean equal full-page prefixes
        (verified exactly on lookup)."""
        page = self.page_size
        prev = 0
        for i in range(len(tokens) // page):
            tup = tuple(tokens[i * page:(i + 1) * page])
            key = hash((prev, tup))
            yield i, key, (prev, tup)
            prev = key

    def match_prefix(self, tokens: Sequence[int]) -> List[int]:
        """The longest resident full-page prefix of ``tokens``, as page ids in
        position order (possibly empty)."""
        if not self.paged:
            return []
        out: List[int] = []
        for _, key, exact in self._chain_keys(tokens):
            pid = self._hash_page.get(key)
            if pid is None or self._page_key.get(pid) != exact:
                break
            out.append(pid)
        return out

    def pin_prefix(self, tokens: Sequence[int]) -> List[int]:
        """``match_prefix`` plus one reference on each matched page, so the
        pages stay resident while the request waits. ``adopt_prefix`` hands
        the pin to a slot; ``unpin`` releases it."""
        pids = self.match_prefix(tokens)
        for pid in pids:
            self._page_refs[pid] += 1
        return pids

    def unpin(self, pids: Sequence[int]) -> None:
        """Release a ``pin_prefix`` hold that will not be adopted."""
        for pid in pids:
            self._decref(pid)

    def adopt_prefix(self, slot: int, pids: Sequence[int]) -> int:
        """Map pinned pages into a fresh slot's empty block table, taking
        over the pin's references. Returns the positions covered."""
        assert self.paged and slot in self._active, slot
        pages = self._slot_pages[slot]
        assert not pages, "adopt_prefix needs an empty block table"
        for i, pid in enumerate(pids):
            self.block_tables[slot, i] = pid
            pages.append(pid)
        return len(pages) * self.page_size

    def register_prefix(self, slot: int, tokens: Sequence[int]) -> int:
        """Index ``slot``'s full pages under the tokens they hold (``tokens``
        the slot's processed stream). A page already indexed is skipped; a
        private page whose key another page holds with the same tokens is
        merged onto that page (its reference moves there and it is freed).
        Returns the pages newly indexed."""
        assert self.paged and slot in self._active, slot
        pages = self._slot_pages[slot]
        added = 0
        for i, key, exact in self._chain_keys(tokens):
            if i >= len(pages):
                break
            pid = pages[i]
            if self._page_hash.get(pid) is not None:
                continue
            qid = self._hash_page.get(key)
            if qid is not None:
                if (qid != pid and self._page_key.get(qid) == exact
                        and self._page_refs.get(pid, 0) == 1):
                    self._page_refs[qid] += 1
                    self.block_tables[slot, i] = qid
                    pages[i] = qid
                    self._decref(pid)
                    self.dedup_merges += 1
                continue
            self._hash_page[key] = pid
            self._page_hash[pid] = key
            self._page_key[pid] = exact
            added += 1
        if added:
            self.index_version += 1
        return added

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
        """The pool's bytes; 0 once a retired replica released it (``cache``
        None, which the reference's tree walk reads as an empty tree)."""
        if self.cache is None:
            return 0
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

    def stats(self) -> dict:
        out = {"max_slots": self.max_slots, "free": self.free_slots,
               "active": len(self._active), "bytes_per_slot": self.bytes_per_slot(),
               "layout": self.layout}
        if self.paged:
            out.update({"num_pages": self.num_pages, "page_size": self.page_size,
                        "live_pages": self.live_pages, "free_pages": self.free_pages,
                        "shared_pages": self.shared_pages,
                        "indexed_pages": len(self._hash_page),
                        "cow_copies": self.cow_copies,
                        "dedup_merges": self.dedup_merges})
        return out

    def audit(self, *, pins: Optional[Dict[int, int]] = None) -> List[str]:
        """Every structural invariant of the manager, as a list of violations
        (empty when healthy): free and active slots partition the slots;
        free and allocated pages partition pages 1..num_pages-1; every
        allocated page has refcount >= its block-table mappings (== mappings
        plus ``pins`` when given: page id -> expected pin count); block
        tables match their page lists and are zero past them and on
        inactive slots; lengths fit the mapped pages; the index is a
        bijection over allocated pages."""
        errors: List[str] = []
        free_slots = set(self._free)
        if free_slots & self._active:
            errors.append(f"slots both free and active: {sorted(free_slots & self._active)}")
        if free_slots | self._active != set(range(self.max_slots)):
            errors.append("free+active slots != range(max_slots)")
        if not self.paged:
            return errors
        free = list(self._page_free)
        free_set = set(free)
        if len(free) != len(free_set):
            errors.append("duplicate page ids in the free heap")
        if 0 in free_set or 0 in self._page_refs:
            errors.append("null page 0 entered circulation")
        if free_set & self._page_refs.keys():
            errors.append(f"pages both free and allocated: "
                          f"{sorted(free_set & self._page_refs.keys())}")
        if free_set | self._page_refs.keys() != set(range(1, self.num_pages)):
            errors.append("free+allocated pages != range(1, num_pages)")
        mapped: Dict[int, int] = {}
        for slot in range(self.max_slots):
            pages = self._slot_pages.get(slot)
            if slot not in self._active:
                if pages is not None:
                    errors.append(f"inactive slot {slot} has a block table")
                if self.block_tables[slot].any() or self.lens[slot] != 0:
                    errors.append(f"inactive slot {slot} row not zeroed")
                continue
            pages = pages if pages is not None else []
            row = self.block_tables[slot]
            if list(row[:len(pages)]) != pages:
                errors.append(f"slot {slot} block table desynced from _slot_pages")
            if row[len(pages):].any():
                errors.append(f"slot {slot} block table has stale entries past its "
                              f"{len(pages)} pages")
            if self.lens[slot] > len(pages) * self.page_size:
                errors.append(f"slot {slot} len {int(self.lens[slot])} exceeds its "
                              f"{len(pages)} mapped pages")
            for pid in pages:
                mapped[pid] = mapped.get(pid, 0) + 1
                if pid not in self._page_refs:
                    errors.append(f"slot {slot} maps unallocated page {pid}")
        for pid, refs in self._page_refs.items():
            if refs < 1:
                errors.append(f"page {pid} has refcount {refs} < 1")
            n_mapped = mapped.get(pid, 0)
            if refs < n_mapped:
                errors.append(f"page {pid} refcount {refs} < {n_mapped} block-table "
                              f"mappings")
            elif pins is not None and refs != n_mapped + pins.get(pid, 0):
                errors.append(f"page {pid} refcount {refs} != {n_mapped} mappings + "
                              f"{pins.get(pid, 0)} pins (leaked pin or lost ref)")
        for key, pid in self._hash_page.items():
            if self._page_hash.get(pid) != key:
                errors.append(f"index asymmetry: key {key} -> page {pid} but page maps "
                              f"{self._page_hash.get(pid)}")
            if pid not in self._page_refs:
                errors.append(f"index points at free page {pid}")
        for pid, key in self._page_hash.items():
            if self._hash_page.get(key) != pid:
                errors.append(f"index asymmetry: page {pid} -> key {key} but key maps "
                              f"{self._hash_page.get(key)}")
            if pid not in self._page_key:
                errors.append(f"indexed page {pid} lost its exact key")
        return errors
