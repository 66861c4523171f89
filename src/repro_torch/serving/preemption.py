"""KV-cache preemption by migration or recomputation (port of
``repro/serving/preemption.py``).

When KV capacity runs out while new requests starve, the engine evicts a
running request and reclaims its slot:

* ``migrate`` (dense layout only): the slot's row of every cache leaf (K, V,
  positions and length, and a Mamba layer's state) is copied to host memory;
  when a slot frees up it is copied back, bit for bit, and decoding resumes.
* ``recompute``: the cache is dropped; the request re-enters the queue and
  prefills its prompt plus what it generated so far again. On the paged
  layout eviction is page-granular: ``KVManager.free`` decrefs the victim's
  pages, so a shared prefix survives under its other owners.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serving.kvmanager import KVManager
from repro_torch.serving.request import Request, RequestState


def gather_slot(kv: KVManager, slot: int):
    """One dense slot's row of every cache leaf, copied to host memory (the
    cache's own tree; leaves are (layers, batch, ...))."""
    return tree_map(kv.cache, lambda a: a[:, slot].to("cpu", copy=True))


def restore_slot(kv: KVManager, slot: int, saved) -> None:
    """Copy a host-saved row back into the dense slot ``slot``, in place."""
    for g, s in zip(tree_leaves(kv.cache), tree_leaves(saved)):
        g[:, slot].copy_(s)


def migrate_out(kv: KVManager, req: Request) -> None:
    """Evict ``req``: save its cache to the host and free the slot."""
    assert req.slot >= 0
    req.saved_cache = gather_slot(kv, req.slot)
    kv.free(req.slot)
    req.slot = -1
    req.state = RequestState.QUEUED


def recompute_out(kv: KVManager, req: Request) -> None:
    """Evict ``req`` and drop its cache; it will prefill prompt + output."""
    assert req.slot >= 0
    req.saved_cache = None
    kv.free(req.slot)
    req.slot = -1
    req.state = RequestState.QUEUED


def pick_victim(running: List[Request],
                now: Optional[float] = None) -> Optional[Request]:
    """The decoding request with the lowest priority, ties broken by the
    fewest generated tokens; with ``now``, one past its deadline first."""
    decoding = [r for r in running if r.state == RequestState.DECODE and r.slot >= 0]
    if not decoding:
        return None
    if now is not None:
        return min(decoding, key=lambda r: (not r.past_deadline(now), r.priority,
                                            len(r.output)))
    return min(decoding, key=lambda r: (r.priority, len(r.output)))


def pick_victim_paged(candidates: List[Request],
                      now: Optional[float] = None) -> Optional[Request]:
    """Page-pressure victim among decoding and mid-prefill requests that
    hold a slot: lowest priority, then fewest generated tokens, then the
    latest arrival; with ``now``, one past its deadline first."""
    pool = [r for r in candidates
            if r.slot >= 0 and r.state in (RequestState.DECODE, RequestState.PREFILL)]
    if not pool:
        return None
    if now is not None:
        return min(pool, key=lambda r: (not r.past_deadline(now), r.priority,
                                        len(r.output), -r.arrival_time, -r.rid))
    return min(pool, key=lambda r: (r.priority, len(r.output), -r.arrival_time, -r.rid))
