"""Multi-pod dry run: trace every (architecture x input shape x mesh) cell
against stand-ins, prove the sharding holds, and record each device's
memory, cost and collectives for the roofline.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/dryrun

Port of ``repro/launch/dryrun.py`` with its flags. Where the reference
lowers and compiles against 512 forced host devices, each cell here runs
its step once in a fake process group of 256 or 512 ranks
(``FakeStore``, backend "fake": collectives return at once) under
``FakeTensorMode``: every tensor is a DTensor whose local shard has no
storage, so nothing is allocated and no device is needed. The walker
(``launch/op_cost.py``) sees the local ops of rank 0 and the collectives
DTensor issues. On the CPU's fake group an all-to-all runs as an
all-gather (DTensor's fallback), and is counted as one. A record has the
reference's keys where they have a meaning: "trace_s" where it has
"lower_s"/"compile_s", and "flop_counter" (``FlopCounterMode``'s total)
where it has "xla_cost_analysis".
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Optional

from repro_torch.configs.base import SHAPES, RunConfig, shape_applicable
from repro_torch.configs.registry import all_archs, get_config, get_shape


@contextlib.contextmanager
def fake_group(world_size: int):
    """A default process group of ``world_size`` fake ranks (this process is
    rank 0), destroyed on exit."""
    import torch
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # never fall back to a smaller mesh
        raise RuntimeError(f"the dry run needs torch.testing._internal.distributed.fake_pg."
                           f"FakeStore, which torch {torch.__version__} lacks") from e
    if dist.is_initialized():
        raise RuntimeError("a default process group is already set up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_step(fn, args, *, sites: bool = True, flop_counter: bool = True):
    """Run ``fn(*args)`` under the walker and, with ``flop_counter``,
    ``FlopCounterMode`` (a third more tracing time). Returns (outputs,
    walker, FlopCounterMode's total or None, seconds)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.op_cost import OpCostMode
    mode = OpCostMode(sites=sites)
    fc = FlopCounterMode(display=False) if flop_counter else contextlib.nullcontext()
    t0 = time.monotonic()
    with mode, fc:
        out = fn(*args)
    return out, mode, fc.get_total_flops() if flop_counter else None, time.monotonic() - t0


def memory_dict(args, out, mode) -> dict:
    """Per-device bytes: the arguments' storages, the outputs' storages that
    are not arguments', and the peak of storages alive during the step
    (temp; a cache or state updated in place adds nothing)."""
    from repro_torch.launch.op_cost import storage_bytes
    arg = storage_bytes(args)
    both = storage_bytes((args, out))
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": both - arg,
            "temp_size_in_bytes": mode.cost.peak_bytes,
            "peak_size_in_bytes": arg + mode.cost.peak_bytes}


def stand_ins(meta: dict, in_specs, in_pl, mesh):
    """DTensor stand-ins of the step's inputs (the train state's parameters
    marked as taking gradients); host scalars pass as they are."""
    from repro_torch.launch.steps import empty_like_specs
    from repro_torch.models.params import trainable
    args = [empty_like_specs(s, p, mesh) for s, p in zip(in_specs, in_pl)]
    if meta["kind"] == "train":
        trainable(args[0]["params"])
    return args


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, run: RunConfig,
             moe_impl: str = "duplex", verbose: bool = True) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_production_mesh, mesh_info
    from repro_torch.launch.roofline import model_bytes, model_flops, terms_from_cost
    from repro_torch.launch.steps import make_cell_step
    from repro_torch.training.optimizer import OptConfig
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    rec: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi_pod" if multi_pod else "single_pod", "moe_impl": moe_impl,
        "run_config": {"remat": run.remat_policy, "seq_shard": run.seq_shard_activations,
                       "microbatch": run.microbatch_size,
                       "compression": run.grad_compression,
                       "moe_sharding": run.moe_sharding, "kv_quant": run.kv_quant,
                       "attn_q_block": run.attn_q_block, "attn_kv_block": run.attn_kv_block},
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    t0 = time.monotonic()
    try:
        with fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            chips = mesh.size()
            rec["mesh_info"] = mesh_info(mesh)
            fn, in_specs, in_pl, _, meta = make_cell_step(cfg, shape, mesh, run, OptConfig(),
                                                         moe_impl=moe_impl)
            rec["meta"] = meta
            with FakeTensorMode():
                args = stand_ins(meta, in_specs, in_pl, mesh)
                out, mode, fc_flops, secs = trace_step(fn, args)
                rec["trace_s"] = secs
                rec["memory_analysis"] = memory_dict(args, out, mode)
            terms = terms_from_cost(mode.cost, chips, model_fl=model_flops(cfg, shape),
                                    model_by=model_bytes(cfg, shape))
            rec["roofline"] = terms.to_dict()
            rec["ops"] = mode.cost.ops
            rec["profile_top"] = [{"op": s.op, "flops": s.flops, "bytes": s.bytes,
                                   "count": s.count, "site": s.site[:160]}
                                  for s in mode.top_sites(12)]
            rec["collective_top"] = [{"op": s.op, "bytes": s.bytes, "count": s.count,
                                      "site": s.site[:160]}
                                     for s in mode.top_sites(8, collective=True)]
            rec["memory_top"] = [{"site": site[:160], "bytes": n}
                                 for site, n in mode.peak_sites]
            rec["flop_counter"] = {"flops": float(fc_flops)}
            rec["status"] = "ok"
            if verbose:
                print(rec["memory_analysis"])
                print(rec["flop_counter"])
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = repr(e)
        rec["traceback"] = traceback.format_exc()
    rec["total_s"] = time.monotonic() - t0
    return rec


def cell_list(archs, shapes, meshes):
    cells = []
    for a in archs:
        for s in shapes:
            if not shape_applicable(a, s):
                cells.append((a, s, None, "skipped"))
                continue
            for m in meshes:
                cells.append((a, s, m, "run"))
    return cells


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default=None, help="arch id (default: all)")
    p.add_argument("--shape", default=None, help="shape id (default: all)")
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="artifacts/dryrun")
    p.add_argument("--moe-impl", default="duplex", choices=["duplex", "grouped"])
    p.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    p.add_argument("--no-seq-shard", action="store_true")
    p.add_argument("--microbatch", type=int, default=0)
    p.add_argument("--compression", default="none", choices=["none", "int8_ef"])
    p.add_argument("--moe-sharding", default="auto", choices=["auto", "ep", "tp"])
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache for decode cells")
    p.add_argument("--attn-q-block", type=int, default=512)
    p.add_argument("--attn-kv-block", type=int, default=512)
    p.add_argument("--attn-score-bf16", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--list", action="store_true")
    p.add_argument("--slice", default=None,
                   help="i:j slice of the cell list (parallel workers)")
    p.add_argument("--tag", default="", help="suffix for output filenames")
    args = p.parse_args(argv)

    archs = [args.arch] if args.arch else list(all_archs())
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    run = RunConfig(microbatch_size=args.microbatch, remat_policy=args.remat,
                    moe_sharding=args.moe_sharding, grad_compression=args.compression,
                    seq_shard_activations=not args.no_seq_shard, kv_quant=args.kv_quant,
                    attn_q_block=args.attn_q_block, attn_kv_block=args.attn_kv_block,
                    attn_score_bf16=args.attn_score_bf16)

    cells = cell_list(archs, shapes, meshes)
    if args.slice:
        i, j = (int(x) if x else None for x in args.slice.split(":"))
        cells = cells[i:j]
    if args.list:
        for c in cells:
            print(c)
        return 0

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape, multi_pod, kind in cells:
        if kind == "skipped":
            path = os.path.join(args.out, f"{arch}__{shape}__skipped.json")
            with open(path, "w") as f:
                json.dump({"arch": arch, "shape": shape, "status": "skipped",
                           "reason": "full-attention arch; long_500k requires "
                                     "sub-quadratic attention"}, f, indent=2)
            print(f"[skip] {arch} x {shape} (full-attention)")
            continue
        name = f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"
        if args.tag:
            name += f"__{args.tag}"
        path = os.path.join(args.out, name + ".json")
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                if json.load(f).get("status") == "ok":
                    print(f"[cached] {name}")
                    continue
        print(f"[run] {name} ...", flush=True)
        rec = run_cell(arch, shape, multi_pod=multi_pod, run=run, moe_impl=args.moe_impl)
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
        if rec["status"] == "ok":
            r = rec["roofline"]
            print(f"  ok trace={rec['trace_s']:.1f}s dominant={r['dominant']} "
                  f"t_bound={r['t_bound']:.4f}s mfu_frac={r['roofline_fraction']:.3f}",
                  flush=True)
        else:
            failures += 1
            print(f"  ERROR: {rec['error']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
