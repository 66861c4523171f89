"""Logical-axis sharding rules, resolved per mesh and shape kind.

Port of ``repro/sharding/rules.py``. Every parameter and activation names
its dimensions with *logical* axes; the rules map a logical axis to mesh
dimension names. Duplicate mesh dimensions within one spec resolve
first-wins (the later dimension falls back to replicated), and a mesh
dimension that does not divide its tensor dimension is dropped
(``fit_pspec_to_shape``), so every local shard has the reference's
per-device shape: DTensor's uneven shards are never relied on.

A spec here is a tuple with one entry per tensor dimension: None, a mesh
dimension name, or a tuple of names (outermost first), where the
reference has a ``PartitionSpec``. ``placements`` turns it into DTensor
placements on a ``DeviceMesh``.

``sharding_context`` installs the active (mesh, rules), so model code can
write ``logical_constraint(x, ("act_batch", "act_seq", "act_embed"))``
where the reference does: on a DTensor inside a context it is a
``redistribute`` to the resolved placements (GSPMD's sharding
constraint); outside a context, or on a plain tensor, it returns ``x`` as
it is, at the cost of one ``ContextVar.get``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]

# Weight logical axes:
#   embed      : d_model dim of weights           -> FSDP over data
#   heads      : q-heads*head_dim dim             -> TP over model
#   kv_heads   : kv-heads*head_dim dim            -> TP over model
#   mlp        : FFN hidden dim                   -> TP over model
#   vocab      : embedding/vocab dim              -> TP over model
#   experts    : expert dim of MoE weights        -> EP over model (or None for TP)
#   expert_mlp : per-expert FFN hidden            -> TP over model in TP/C4 mode
#   layers     : stacked dim                      -> never sharded
#   conv/state : ssm small dims                   -> never sharded
# Activation logical axes:
#   act_batch, act_seq, act_embed, act_heads, act_kv_seq, act_vocab, act_exp


def base_rules(*, multi_pod: bool, shape_kind: str,
               moe_sharding: str = "tp") -> Dict[str, MeshAxes]:
    """The paper's layout: TP within a pod (experts included, C4), DP/FSDP
    over data, EP across pods when multi-pod with moe_sharding="auto"."""
    data: MeshAxes = "data"
    batch: MeshAxes = ("pod", "data") if multi_pod else "data"
    rules: Dict[str, MeshAxes] = {
        "embed": data,           # FSDP
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "layers": None,
        "conv": None,
        "state": None,
        "act_batch": batch,
        "act_seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_kv_seq": None,
        "act_vocab": "model",
        "act_mlp": "model",
        # the MoE slot buffers' tile dim: they scale with the global token
        # count and must not replicate across the data axis
        "act_cap": "data",
    }
    if moe_sharding == "ep":
        rules.update(experts="model", expert_mlp=None, act_exp="model")
    elif moe_sharding == "tp":  # paper C4: every device sees all experts
        rules.update(experts=None, expert_mlp="model", act_exp=None)
    else:  # auto: EP across pods, TP within (the paper's multi-node layout)
        if multi_pod:
            rules.update(experts="pod", expert_mlp="model", act_exp="pod")
            rules["act_batch"] = "data"  # the pod axis is taken by experts
        else:
            rules.update(experts=None, expert_mlp="model", act_exp=None)
    if shape_kind == "decode":
        # long-context decode: shard the KV sequence (context parallelism)
        rules["act_kv_seq"] = batch
        rules["act_batch"] = None
    return rules


def decode_rules_batched(*, multi_pod: bool,
                         moe_sharding: str = "tp") -> Dict[str, MeshAxes]:
    """decode_32k: the batch is large (128), so it shards over data and the
    KV sequence replicates."""
    rules = base_rules(multi_pod=multi_pod, shape_kind="train", moe_sharding=moe_sharding)
    rules["act_kv_seq"] = None
    return rules


def rules_for(shape_kind: str, global_batch: int, *, multi_pod: bool,
              moe_sharding: str = "tp") -> Dict[str, MeshAxes]:
    if shape_kind == "decode" and global_batch > 1:
        return decode_rules_batched(multi_pod=multi_pod, moe_sharding=moe_sharding)
    return base_rules(multi_pod=multi_pod, shape_kind=shape_kind, moe_sharding=moe_sharding)


def resolve_pspec(axes: Sequence[Optional[str]], rules: Dict[str, MeshAxes]) -> tuple:
    """Logical axes -> spec, dropping duplicate mesh dimensions (the first
    occurrence wins)."""
    used: set = set()
    parts = []
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        if m is None:
            parts.append(None)
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        keep = tuple(a for a in ms if a not in used)
        used.update(keep)
        if not keep:
            parts.append(None)
        elif len(keep) == 1:
            parts.append(keep[0])
        else:
            parts.append(keep)
    return tuple(parts)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{mesh dimension name: size} of a ``DeviceMesh`` (by its
    ``mesh_dim_names``), or of any object whose ``shape`` is such a dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, tuple(mesh.shape)))


def fit_pspec_to_shape(spec: Sequence, shape: Sequence[int], mesh) -> tuple:
    """Drop mesh dimensions that do not evenly divide their tensor dimension
    (12 KV heads on a 16-way model axis, vocab 50280 on 16): keep the
    largest dividing prefix of each dimension's names; a dropped name falls
    back to replication for that dimension."""
    sizes = mesh_sizes(mesh)
    spec = tuple(spec)
    parts = []
    for dim, part in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if part is None:
            parts.append(None)
            continue
        ms = (part,) if isinstance(part, str) else tuple(part)
        keep = []
        prod = 1
        for a in ms:
            n = sizes[a]
            if dim % (prod * n) == 0:
                keep.append(a)
                prod *= n
            else:
                break
        if not keep:
            parts.append(None)
        elif len(keep) == 1:
            parts.append(keep[0])
        else:
            parts.append(tuple(keep))
    return tuple(parts)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements on ``mesh`` for a spec: ``Shard(d)`` on each mesh
    dimension (of more than one device) named by tensor dimension d,
    ``Replicate()`` on the rest. A
    tensor dimension over several mesh dimensions takes them outermost
    first, which is DTensor's mesh-dimension order; a spec that names them
    in another order raises ValueError."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        ms = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in ms]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} names mesh dimensions {ms} against "
                             f"the mesh's order {names}")
        for i in idx:
            # a one-way dimension replicates: the same layout, and views that
            # squeeze a size-1 dim stay legal
            out[i] = Shard(d) if mesh.size(i) > 1 else Replicate()
    return tuple(out)


def is_axes(x) -> bool:
    """A logical-axes leaf: a tuple of names or None."""
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)


class ShardingContext:
    def __init__(self, mesh, rules: Dict[str, MeshAxes]):
        self.mesh = mesh
        self.rules = dict(rules)

    def spec(self, axes: Sequence[Optional[str]], shape: Optional[Sequence[int]] = None):
        spec = resolve_pspec(axes, self.rules)
        if shape is not None:
            spec = fit_pspec_to_shape(spec, shape, self.mesh)
        return spec

    def sharding(self, axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> tuple:
        """The placements of a tensor of ``shape`` with logical ``axes``."""
        assert self.mesh is not None
        return placements(self.spec(axes, shape), self.mesh)


_CTX: contextvars.ContextVar = contextvars.ContextVar("sharding_ctx", default=None)


@contextlib.contextmanager
def sharding_context(mesh, rules: Dict[str, MeshAxes]):
    ctx = ShardingContext(mesh, rules)
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def current_context() -> Optional[ShardingContext]:
    return _CTX.get()


def local_call(fn, mesh, out_placements, in_placements, *args):
    """``local_map(fn)`` on ``mesh`` with inputs redistributed to
    ``in_placements`` (a placement list per argument, None for a
    non-tensor); plain tensors among the args (positions, masks the models
    make) are first taken as replicated DTensors, as DTensor's
    ``implicit_replication`` takes them. ``out_placements``: one placement
    list, or a tuple of them for several outputs."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    rep = [Replicate()] * mesh.ndim
    args = [DTensor.from_local(a, mesh, rep, run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) and pl is not None
            else a for a, pl in zip(args, in_placements)]
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(list(p) if p is not None else None
                                         for p in in_placements),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def split_last(x, sizes: Sequence[int], axes: Sequence[Optional[str]]):
    """``x.reshape(x.shape[:-1] + sizes)``, the result having logical
    ``axes``. On a DTensor in a context, ``x`` is first redistributed so the
    view lands on the placements those axes resolve to: a view cannot
    unflatten a dimension sharded more ways than its outer factor (2 KV
    heads of a 4-way model axis), where GSPMD reshards by itself."""
    shape = tuple(x.shape[:-1]) + tuple(sizes)
    ctx = _CTX.get()
    if ctx is None or ctx.mesh is None or not hasattr(x, "redistribute"):
        return x.reshape(shape)
    # the split dims' trailing one (head_dim) is never sharded, so each
    # target placement is also the source's
    target = ctx.sharding(axes, shape)
    if tuple(x.placements) != target:
        x = x.redistribute(ctx.mesh, target)
    return x.reshape(shape)


def heads_local(fn, q, k, v):
    """``fn(q, k, v)`` -> (B, S, H, hd) for attention q (B, S, H, hd) and k,
    v (B, Skv, KV, hd), on DTensors one shard of heads at a time: the
    sequence is gathered and the heads sharded instead over the mesh
    dimensions that shard q's sequence or heads (where H divides), the
    batch kept (sequence-parallel attention by an all-to-all, as the
    reference's blockwise attention is partitioned by GSPMD). K/V shard
    their heads alike where KV divides, else stay whole and each shard
    takes the KV heads its q heads read. The output returns to q's
    placements. Plain tensors: ``fn(q, k, v)``."""
    if not hasattr(q, "device_mesh"):
        return fn(q, k, v)
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    qpk = H // KV
    q_pl, kv_pl, head_dims = [], [], []
    h_ways = 1
    for i, p in enumerate(q.placements):
        if p == Shard(0):
            q_pl.append(p), kv_pl.append(p)
        elif p.is_shard() and p.dim in (1, 2) and H % (h_ways * mesh.size(i)) == 0:
            h_ways *= mesh.size(i)
            head_dims.append(i)
            q_pl.append(Shard(2))
            kv_pl.append(Shard(2) if KV % h_ways == 0 else Replicate())
        else:
            q_pl.append(Replicate()), kv_pl.append(Replicate())
    if any(p.is_shard() and p.dim == 2 for p in kv_pl) and \
            any(not p.is_shard() for i, p in enumerate(kv_pl) if i in head_dims):
        kv_pl = [Replicate() if i in head_dims else p for i, p in enumerate(kv_pl)]
    kv_split = not any(p.is_shard() and p.dim == 2 for p in kv_pl) and h_ways > 1
    Hl = H // h_ways
    if kv_split and not (Hl % qpk == 0 or qpk % Hl == 0):
        raise NotImplementedError(f"{H} q heads over {KV} KV heads on {h_ways} shards")

    def local(ql, kl, vl):
        if kv_split:
            coord = mesh.get_coordinate()
            start, stride = 0, Hl
            for i in reversed(head_dims):
                start += coord[i] * stride
                stride *= mesh.size(i)
            k0, k1 = start // qpk, (start + Hl - 1) // qpk + 1
            kl, vl = kl[:, :, k0:k1], vl[:, :, k0:k1]
        return fn(ql, kl, vl)

    out = local_call(local, mesh, list(q_pl), (q_pl, kv_pl, kv_pl), q, k, v)
    return out.redistribute(mesh, q.placements)


def gather_last(logits, labels):
    """``torch.gather(logits, -1, labels[..., None])[..., 0]``. On a DTensor
    each shard gathers from its own block, the labels placed as the logits'
    leading dims (a DTensor gather would replicate both); where the last
    (vocab) dim is sharded, each shard picks the labels in its own vocab
    range and the result is a partial sum over those mesh dimensions
    (vocab-parallel cross-entropy: no shard gathers the logits)."""
    if not hasattr(logits, "device_mesh"):
        return torch_gather_last(logits, labels)
    from torch.distributed.tensor import Partial, Replicate
    mesh, last = logits.device_mesh, logits.dim() - 1
    lg_pl = [Replicate() if p.is_partial() else p for p in logits.placements]
    vocab_dims = [i for i, p in enumerate(lg_pl) if p.is_shard(last)]
    lab_pl = [Replicate() if i in vocab_dims else p for i, p in enumerate(lg_pl)]
    out_pl = [Partial() if i in vocab_dims else p for i, p in enumerate(lab_pl)]

    def local(lg, lb):
        if not vocab_dims:
            return torch_gather_last(lg, lb)
        coord = mesh.get_coordinate()
        Vl = lg.shape[-1]
        start, stride = 0, Vl
        for i in reversed(vocab_dims):
            start += coord[i] * stride
            stride *= mesh.size(i)
        rel = lb.long() - start
        inside = (rel >= 0) & (rel < Vl)
        picked = torch_gather_last(lg, rel.clamp(0, Vl - 1))
        return picked * inside.to(picked.dtype)

    return local_call(local, mesh, out_pl, (lg_pl, lab_pl), logits, labels)


def torch_gather_last(logits, labels):
    import torch
    return torch.gather(logits, -1, labels[..., None].long())[..., 0]


def seq_whole(x):
    """A DTensor with its dimension 1 (the sequence) gathered, other
    placements kept, so the cross-entropy's sequence chunks slice whole
    positions; anything else as it is."""
    if not hasattr(x, "device_mesh") or not any(p.is_shard(1) for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard(1) else p
                                          for p in x.placements])


def sharded_linear(x, w):
    """``x @ w`` for a >= 3-D DTensor activation x (..., K) and a 2-D
    DTensor weight w (K, N), each shard multiplying its local blocks
    (``local_map``). Per mesh dimension: a sharded leading dim of x keeps
    its shard and w is gathered there (FSDP); a weight sharded over N
    gathers x (sequence parallelism's all-gather) and shards the output's
    N; a weight sharded over K shards x's K and leaves a partial sum. It
    replaces ``torch.matmul``'s flatten of the leading dims, which on a
    batch- and sequence-sharded x gives a strided shard that DTensor's
    propagation cannot place on fake tensors. The weight's gradient is a
    partial sum over the mesh dimensions that shard x's leading dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    last = x.dim() - 1
    xs, ws, outs, x_grad, w_grad = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        xp = Replicate() if xp.is_partial() else xp
        if xp.is_shard() and xp.dim < last:
            if wp.is_shard(1):
                xs.append(Replicate()), ws.append(wp), outs.append(Shard(last))
                x_grad.append(Partial()), w_grad.append(wp)
            else:
                xs.append(xp), ws.append(Replicate()), outs.append(xp)
                x_grad.append(xp), w_grad.append(Partial())
        elif wp.is_shard(1):
            xs.append(Replicate()), ws.append(wp), outs.append(Shard(last))
            x_grad.append(Partial()), w_grad.append(wp)
        elif wp.is_shard(0) or xp.is_shard(last):
            xs.append(Shard(last)), ws.append(Shard(0)), outs.append(Partial())
            x_grad.append(Shard(last)), w_grad.append(Shard(0))
        else:
            xs.append(Replicate()), ws.append(Replicate()), outs.append(Replicate())
            x_grad.append(Replicate()), w_grad.append(Replicate())
    import torch
    return local_map(torch.matmul, out_placements=outs, in_placements=(xs, ws),
                     in_grad_placements=(x_grad, w_grad), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, w)


def _rows(idx):
    import torch
    B = idx.shape[0]
    return torch.arange(B, device=idx.device).reshape((B,) + (1,) * (idx.dim() - 1))


def write_rows(leaf, idx, values) -> None:
    """``leaf[b, idx[b, ...]] = values[b, ...]`` for every row b, in place:
    leaf (B, Smax, *T); idx (B,) or (B, I) positions; values (B, [I,] *T).
    On a DTensor each shard writes its own rows, and where the positions
    are sharded (context parallelism) only the positions in its block: a
    slice-sized write, never a whole-cache rewrite."""
    if not hasattr(leaf, "device_mesh"):
        leaf[_rows(idx), idx] = values
        return
    import torch
    from torch.distributed.tensor import Replicate, Shard
    mesh, lead = leaf.device_mesh, idx.dim()
    idx_pl, val_pl, seq_dims = [], [], []
    for i, p in enumerate(leaf.placements):
        if p.is_shard(0):
            idx_pl.append(p), val_pl.append(p)
        elif p.is_shard(1):
            idx_pl.append(Replicate()), val_pl.append(Replicate()), seq_dims.append(i)
        elif p.is_shard():
            idx_pl.append(Replicate()), val_pl.append(Shard(p.dim - 2 + lead))
        else:
            idx_pl.append(Replicate()), val_pl.append(Replicate())

    def local(lf, ix, vl):
        ix = ix.long()
        if seq_dims:
            coord = mesh.get_coordinate()
            Sl = lf.shape[1]
            start, stride = 0, Sl
            for i in reversed(seq_dims):
                start += coord[i] * stride
                stride *= mesh.size(i)
            rel = ix - start
            inside = (rel >= 0) & (rel < Sl)
            ix = rel.clamp(0, Sl - 1)
            keep = inside.reshape(inside.shape + (1,) * (vl.dim() - lead))
            vl = torch.where(keep, vl.to(lf.dtype), lf[_rows(ix), ix])
        lf[_rows(ix), ix] = vl.to(lf.dtype)
        return lf

    local_call(local, mesh, list(leaf.placements), (list(leaf.placements), idx_pl, val_pl),
               leaf, idx, values)


def take_rows(x, idx):
    """``x[b, idx[b, ...]]`` for every row b: x (B, S, *T), idx (B, I) ->
    (B, I, *T). On a DTensor the positions are gathered whole and each
    shard takes its own rows."""
    if not hasattr(x, "device_mesh"):
        return x[_rows(idx), idx]
    from torch.distributed.tensor import Replicate
    x_pl = [Replicate() if p.is_shard(1) or p.is_partial() else p for p in x.placements]
    idx_pl = [p if p.is_shard(0) else Replicate() for p in x_pl]
    return local_call(lambda xl, il: xl[_rows(il), il.long()], x.device_mesh, x_pl,
                      (x_pl, idx_pl), x, idx)


def logical_constraint(x, axes: Sequence[Optional[str]]):
    """Redistribute a DTensor to the placements its logical axes resolve to
    in the active context; anything else passes through unchanged."""
    ctx = _CTX.get()
    if ctx is None or ctx.mesh is None or not hasattr(x, "redistribute"):
        return x
    target = ctx.sharding(axes, x.shape)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(ctx.mesh, target)
