"""Path a of ``chip_smoke.py`` (OLMoE-1B-7B at full width, 16 requests) on
one H100 through ``ServingEngine.run`` (S) and ``run_async`` (A): a warm-up
run, five alternating pairs (S A, A S, ...) timed on the host clock, then
two ``cProfile``'d runs of each loop, their host functions compared by
total time (the largest increases from S to A, and A's top items).

    python3 tools/serve_loops_profile.py      # from the repository's root

Needs the card; prints JSON walls, the A/S ratios and two tables."""
import cProfile, importlib.util, json, pstats, sys, time
sys.path.insert(0, "src")
import torch
from repro_torch.kernels import build
build.build_all()
from repro_torch.configs import resolve_config
from repro_torch.models.params import init_model
from repro_torch.serving.engine import ServingEngine
spec = importlib.util.spec_from_file_location("cs", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
torch.backends.cuda.matmul.allow_tf32 = False
cfg = resolve_config("olmoe-1b-7b")
params = init_model(cfg, seed=0, device="cuda")

def run(loop, prof=None):
    reqs = cs.path_a_requests(cfg)
    eng = ServingEngine(cfg, params, device="cuda", **cs.ENGINE_KW)
    for r in reqs:
        r.arrival_time = time.monotonic()
    t = time.perf_counter()
    if prof: prof.enable()
    getattr(eng, loop)(reqs)
    torch.cuda.synchronize()
    if prof: prof.disable()
    return time.perf_counter() - t

run("run")   # warm-up
walls = {"run": [], "run_async": []}
for i in range(5):
    for loop in (("run", "run_async") if i % 2 == 0 else ("run_async", "run")):
        walls[loop].append(round(run(loop), 3))
print(json.dumps(walls), flush=True)
print("ratios A/S", [round(a / s, 3) for a, s in zip(walls["run_async"], walls["run"])], flush=True)
stats = {}
for loop in ("run", "run_async", "run_async", "run"):
    p = cProfile.Profile()
    w = run(loop, p)
    st = pstats.Stats(p)
    stats.setdefault(loop, []).append((w, st))
    print(loop, "profiled wall", round(w, 3), flush=True)
def table(st):
    out = {}
    for (f, l, name), (cc, nc, tt, ct, callers) in st.stats.items():
        out[f"{f.split('/')[-1]}:{l}:{name}"] = (nc, tt, ct)
    return out
for k in stats:
    stats[k] = [table(st) for _, st in stats[k]]
S, A = stats["run"], stats["run_async"]
keys = set().union(*[t.keys() for t in S + A])
def mean(ts, key, i):
    return sum(t.get(key, (0, 0, 0))[i] for t in ts) / len(ts)
rows = sorted(keys, key=lambda k: -(mean(A, k, 1) - mean(S, k, 1)))
print("largest tottime increases A - S (s): name, calls S/A, tottime S/A, cumtime S/A")
for k in rows[:30]:
    print(f"{k[:90]:90s} {mean(S,k,0):8.0f} {mean(A,k,0):8.0f} {mean(S,k,1):8.3f} {mean(A,k,1):8.3f} {mean(S,k,2):8.3f} {mean(A,k,2):8.3f}")
print("top tottime in A:")
for k in sorted(keys, key=lambda k: -mean(A, k, 1))[:25]:
    print(f"{k[:90]:90s} {mean(S,k,0):8.0f} {mean(A,k,0):8.0f} {mean(S,k,1):8.3f} {mean(A,k,1):8.3f}")
