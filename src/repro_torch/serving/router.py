"""Fleet request routing: load balancing and resident-prefix affinity (port
of ``repro/serving/router.py``).

``round-robin``
    Cycle through the admittable replicas in id order: fair under uniform
    traffic, blind to where KV already lives, so a burst sharing a long
    system prompt re-prefills it on every replica.

``affinity``
    Score each admittable replica by resident-prefix affinity minus load:

        score = shared_tokens(replica, req) - load_weight x effective_load

    ``shared_tokens`` is exact: the longest resident full-page prefix that
    ``KVManager.match_prefix`` finds, the lookup admission uses (0 for a
    replica without paged sharing). ``effective_load`` is the replica's
    queued, prefilling and running requests, plus a penalty while it is
    DEGRADED. Ties break toward the lighter, lower-id replica. The load
    term keeps a popular prefix from hotspotting one replica.

Routers return a best-first ordering, so the fleet falls through to the
next replica when the best one's bounded queue rejects.
"""
from __future__ import annotations

from typing import List

from repro_torch.serving.request import Request

ROUTER_POLICIES = ("affinity", "round-robin")


class Router:
    """Routing policy interface: order admittable replicas best-first."""

    name = "base"

    def order(self, replicas: List, req: Request) -> List:
        raise NotImplementedError


class RoundRobinRouter(Router):
    """Cycle through replicas in id order, one submission at a time."""

    name = "round-robin"

    def __init__(self):
        self._next = 0

    def order(self, replicas: List, req: Request) -> List:
        if not replicas:
            return []
        replicas = sorted(replicas, key=lambda rep: rep.id)
        k = self._next % len(replicas)
        self._next += 1
        return replicas[k:] + replicas[:k]


class AffinityRouter(Router):
    """Prefix-affinity scoring over the token-keyed page index.

    ``load_weight`` is the resident prefix tokens one unit of queue depth
    is worth (default: the replica's page size, so one queued request
    outweighs one resident page); ``degraded_penalty`` is the extra load of
    a DEGRADED replica.
    """

    name = "affinity"

    def __init__(self, load_weight: float = None, degraded_penalty: int = 4):
        self.load_weight = load_weight
        self.degraded_penalty = degraded_penalty

    def shared_tokens(self, replica, req: Request) -> int:
        """Exact resident-prefix match length (tokens) of ``req`` on this
        replica: the full pages admission's pin would hit, times the page
        size."""
        eng = replica.engine
        if not (eng.paged and eng.prefix_share):
            return 0
        return len(eng.kv.match_prefix(req.token_stream())) * eng.kv.page_size

    def score(self, replica, req: Request) -> float:
        eng = replica.engine
        w = self.load_weight
        if w is None:
            w = eng.kv.page_size if eng.paged else 8
        load = replica.load + (self.degraded_penalty if replica.degraded else 0)
        return self.shared_tokens(replica, req) - w * load

    def order(self, replicas: List, req: Request) -> List:
        return sorted(replicas, key=lambda rep: (-self.score(rep, req), rep.load, rep.id))


def make_router(policy: str) -> Router:
    """A router by its CLI name (``ROUTER_POLICIES``)."""
    if policy == "affinity":
        return AffinityRouter()
    if policy == "round-robin":
        return RoundRobinRouter()
    raise ValueError(f"unknown router policy {policy!r}; choose from {ROUTER_POLICIES}")
