"""Per-op cost walker: the dry run's profiler.

The port's counterpart of ``repro/launch/hlo_cost.py``. There is no HLO
text: a ``TorchDispatchMode`` sees every aten op a step issues as it runs
(on DTensors, the local ops with each device's shapes, and the functional
collectives DTensor issues), and sums:

  * flops            — 2·M·N·K for the matmul family (mm, addmm, bmm,
                       baddbmm: ``FlopCounterMode``'s count), the result's
                       elements for pointwise ops, the input's for
                       reductions (sum, amax, softmax, cumsum, ...);
  * bytes            — operands plus result of each op. Eager ops are
                       unfused kernels, so nothing is discounted; views and
                       metadata ops are free; slice-like writes
                       (``index_put_``, ``index_copy_``, ``copy_`` into a
                       view) count only the slice, as the reference counts
                       ``dynamic-update-slice`` at slice size;
  * collective bytes — the operand bytes of each collective, per kind (on
                       a CPU group DTensor runs an all-to-all as an
                       all-gather and a chunk: counted as the all-to-all);
  * memory           — the bytes of storages made during the step that
                       are still alive, and their peak (a cache updated in
                       place makes none);
  * top sites        — the heaviest (op, Python call site) pairs.

All quantities are per device. The reference multiplies each computation
by its ``while`` trip counts; here the layer and microbatch loops are
Python loops, so every iteration is seen as it runs.
"""
from __future__ import annotations

import os
import sys
import weakref
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}

_MATMUL = {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default}

_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp", "_softmax",
               "_log_softmax", "cumsum", "var", "std", "prod", "argmax", "argmin",
               "norm", "linalg_vector_norm", "any", "all", "topk", "sort",
               "_softmax_backward_data", "_log_softmax_backward_data"}

# ops that move no data: metadata, factories that write nothing, bookkeeping
_FREE = {"detach", "alias", "empty", "empty_like", "empty_strided", "lift_fresh",
         "lift_fresh_copy", "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
         "wait_tensor", "set_", "resize_", "is_same_size", "_has_compatible_shallow_copy_type",
         "device", "dim", "size", "stride", "storage_offset", "is_contiguous",
         "record_stream", "_to_copy_view"}

_SLICE_WRITES = {"index_put_", "index_put", "_index_put_impl_", "index_copy_",
                 "index_copy", "slice_scatter", "select_scatter", "masked_scatter_"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def matmul_flops(func, args) -> int:
    """2·M·N·K of a matmul-family op (the added term of addmm/baddbmm is not
    counted, as ``FlopCounterMode`` does not)."""
    if func in (aten.mm.default, aten.bmm.default):
        a, b = args[0], args[1]
    else:
        a, b = args[1], args[2]
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


@dataclass
class Site:
    op: str
    site: str
    flops: float = 0.0
    bytes: float = 0.0
    count: int = 0


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    live_bytes: int = 0
    peak_bytes: int = 0
    ops: int = 0

    @property
    def collective_bytes(self) -> float:
        return sum(self.collective.values())


_SRC = os.sep + "repro_torch" + os.sep
_SKIP = (os.sep + "torch" + os.sep, os.sep + "launch" + os.sep + "op_cost.py",
         os.sep + "sharding" + os.sep, os.sep + "models" + os.sep + "layers.py")


def call_site() -> str:
    """file:line (function) of the innermost frame in the port's package
    outside this walker (the steps' and models' lines), else the caller."""
    f = sys._getframe(2)
    first = None
    while f is not None:
        fn = f.f_code.co_filename
        if _SRC in fn and not any(fn.endswith(s) or s in fn for s in _SKIP[1:]):
            return f"{fn[fn.index(_SRC) + 1:]}:{f.f_lineno} ({f.f_code.co_name})"
        if first is None and not any(s in fn for s in _SKIP):
            first = f"{os.path.basename(fn)}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return first or "?"


def _in_alltoall_fallback() -> bool:
    """Whether the running collective is DTensor's stand-in for an
    all-to-all on a CPU group (an all-gather and a chunk), which the walker
    counts as the all-to-all it replaces."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


class OpCostMode(TorchDispatchMode):
    """Counts each op's cost (see the module docstring). Ops on tensor
    subclasses (DTensor) are deferred to the subclass, whose local ops then
    come back here with each shard's shapes; the global-shape fake runs by
    which DTensor's sharding propagation derives output shapes are not
    counted."""

    def __init__(self, sites: bool = True):
        super().__init__()
        self.cost = Cost()
        self._sites: Dict[tuple, Site] = {}
        self._want_sites = sites
        self._live: Dict[int, tuple] = {}
        self.peak_sites: List[tuple] = []
        self._peak_snap = 0
        self._suspended = 0

    def _track(self, out, args=(), name=""):
        """Count the new storages among ``out``; an output that is one of the
        inputs' storages (an in-place op) is not new. Storages of 1 MiB or
        more keep their call site, and a new peak records the live bytes by
        site (``peak_sites``)."""
        inputs = None
        for t in _tensors(out):
            s = t.untyped_storage()
            key = s._cdata
            if key in self._live:
                continue
            if inputs is None:
                inputs = {a.untyped_storage()._cdata for a in _tensors(args)}
            if key in inputs:
                continue
            n = s.nbytes()
            site = f"{name} {call_site()}" if n >= 1 << 20 and self._want_sites else "small"
            self._live[key] = (n, site)
            self.cost.live_bytes += n
            weakref.finalize(s, self._free, key)
        if self.cost.live_bytes > self.cost.peak_bytes:
            self.cost.peak_bytes = self.cost.live_bytes
            if self._want_sites and self.cost.live_bytes - self._peak_snap >= 1 << 26:
                self._snapshot()

    def _snapshot(self):
        by: Dict[str, int] = {}
        for n, site in self._live.values():
            by[site] = by.get(site, 0) + n
        self.peak_sites = sorted(by.items(), key=lambda kv: -kv[1])[:12]
        self._peak_snap = self.cost.live_bytes

    def _free(self, key):
        n, _ = self._live.pop(key, (0, ""))
        self.cost.live_bytes -= n

    def __enter__(self):
        # DTensor derives an op's output shape by running the op once on fake
        # tensors of the *global* shapes; those runs are not the step's work
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self._orig_meta = ShardingPropagator._propagate_tensor_meta_non_cached
        orig = self._orig_meta

        def meta_only(prop, op_schema):
            self._suspended += 1
            try:
                return orig(prop, op_schema)
            finally:
                self._suspended -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = meta_only
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._orig_meta
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and not issubclass(t, torch._subclasses.FakeTensor)
               for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._suspended:
            return out
        name = func.__name__.split(".")[0]
        if func.is_view or name in _FREE or func.namespace == "prim":
            return out
        ns = func.namespace
        c = self.cost
        c.ops += 1
        flops = 0.0
        if ns in ("_c10d_functional", "c10d", "c10d_functional"):
            kind = _COLLECTIVES.get(name)
            if kind == "all-gather" and _in_alltoall_fallback():
                kind = "all-to-all"
            if kind is not None:
                nb = sum(_nbytes(t) for t in _tensors(args[0] if args else ()))
                c.collective[kind] += nb
                self._site(name, 0.0, nb)
            self._track(out, args, name)
            return out
        if func in _MATMUL:
            flops = matmul_flops(func, args)
        elif torch.Tag.pointwise in func.tags:
            flops = sum(t.numel() for t in _tensors(out))
        elif name in _REDUCTIONS:
            flops = _nbytes(args[0]) / max(args[0].element_size(), 1) \
                if isinstance(args[0], torch.Tensor) else 0
        if name == "copy_":
            nb = _nbytes(args[0]) + _nbytes(args[1])
        elif name in _SLICE_WRITES:
            vals = list(_tensors(args[1:])) + list(_tensors(kwargs))
            nb = 2 * sum(_nbytes(t) for t in vals)
        elif name in ("zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
                      "fill_", "zero_", "new_zeros", "new_full", "new_ones", "arange",
                      "scalar_tensor", "randn", "rand"):
            nb = sum(_nbytes(t) for t in _tensors(out))
        else:
            nb = sum(_nbytes(t) for t in _tensors(args)) + \
                sum(_nbytes(t) for t in _tensors(kwargs))
            if name.endswith("_") or func._schema.is_mutable:
                nb += sum(_nbytes(t) for t in _tensors(args[:1]))
            else:
                nb += sum(_nbytes(t) for t in _tensors(out))
        c.flops += flops
        c.bytes += nb
        self._site(name, flops, nb)
        self._track(out, args, name)
        return out

    def _site(self, name, flops, nb):
        if not self._want_sites or (flops == 0 and nb < 1 << 16):
            return
        key = (name, call_site())
        s = self._sites.get(key)
        if s is None:
            s = self._sites[key] = Site(name, key[1])
        s.flops += flops
        s.bytes += nb
        s.count += 1

    def top_sites(self, n: int = 12, collective: bool = False) -> List[Site]:
        """The heaviest sites by FLOPs then bytes, or the collectives' by
        bytes."""
        if collective:
            sites = [s for s in self._sites.values() if s.op in _COLLECTIVES]
            return sorted(sites, key=lambda s: -s.bytes)[:n]
        return sorted(self._sites.values(), key=lambda s: (-s.flops, -s.bytes))[:n]


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages under a tree of tensors (DTensors
    count their local shards)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        if hasattr(t, "to_local"):
            t = t.to_local()
        s = t.untyped_storage()
        if s._cdata not in seen:
            seen.add(s._cdata)
            total += s.nbytes()
    return total

