"""Host milliseconds a stage of path h's runs (``chip_smoke.py``'s
``async_run``: path a's engine, OLMoE-1B-7B at full width and depth, 16
requests, kernels 1-4) in the tree given, split as path h splits them
(plan, enqueue, wait, commit, deferred), beside the run's wall and the
process's CPU time a stage: one warm-up run, then ``--runs`` timed ones,
one JSON line each. To compare two trees on one card, run it for each in
turn within one call (parent, change, change, parent), each tree unpacked
in full (``git archive``), since each builds its own kernels.

    python3 scripts/enqueue_ab.py --tree DIR [--runs 3] [--loop sync|async]

Needs the card; prints the card's name and power limit first."""
import argparse
import importlib.util
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to time")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--loop", choices=("sync", "async"), default="sync")
    ap.add_argument("--label", default=None, help="name on each line (default: the tree's)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("enqueue_ab: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location("tree_smoke", os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    print(cs.gpu_name_and_power(), flush=True)
    from repro_torch.configs import resolve_config
    from repro_torch.kernels import build
    from repro_torch.models.params import init_model
    build.build_all()
    cfg = resolve_config("olmoe-1b-7b")
    params = init_model(cfg, seed=0, device="cuda")
    label = args.label or os.path.basename(tree)
    for run in range(args.runs + 1):
        c0 = time.process_time()
        _, eng, wall, split = cs.async_run(torch, cfg, params, args.loop)
        cpu = time.process_time() - c0
        n = len(eng.reports)
        if run:
            print(json.dumps({"tree": label, "loop": args.loop, "run": run, "wall_s": wall,
                              "stages": n, "cpu_ms_stage": cpu / n * 1e3,
                              **{f"{k}_ms_stage": v / n * 1e3 for k, v in split.items()}}),
                  flush=True)
        del eng
    return 0


if __name__ == "__main__":
    sys.exit(main())
