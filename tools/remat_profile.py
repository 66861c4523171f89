"""Path d3 of ``chip_smoke.py`` (OLMoE-1B-7B at full width, 8 layers, 4 x
2048 tokens, seed 0) under ``remat`` "none", "dots" and "full" on one H100:
for each, one warm-up step, three steps timed on the host clock to a device
sync, one step under torch.profiler (device activity only: the device's
busy time) and one under cProfile (host time by function, with the time
and calls spent in the selective checkpoint's dispatch modes), and the
peak memory. Each policy's state is freed before the next.

    python3 tools/remat_profile.py      # from the repository's root

Needs the card; prints one JSON line a policy, then cProfile's top host
functions of each."""
import cProfile, gc, importlib.util, json, pstats, sys, time
sys.path.insert(0, "src")
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.configs import RunConfig
from repro_torch.launch.train import make_step
from repro_torch.models.params import init_model
from repro_torch.training.data import DataConfig, SyntheticLMData
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_state import make_train_state
spec = importlib.util.spec_from_file_location("cs", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
print(cs.gpu_name_and_power(), flush=True)
_, cfg = cs.olmoe_cut(cs.TRAIN_LAYERS)
opt = OptConfig(learning_rate=1e-3, total_steps=cs.TRAIN_STEPS,
                warmup_steps=max(cs.TRAIN_STEPS // 10, 1))
data = SyntheticLMData(DataConfig(cfg.vocab_size, cs.TRAIN_SEQ, cs.TRAIN_BATCH, seed=0))
batch = lambda s: {"tokens": torch.from_numpy(data.batch_at(s)["tokens"]).cuda()}
dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
tables = {}
for remat in ("none", "dots", "full"):
    gc.collect(); torch.cuda.empty_cache(); torch.cuda.reset_peak_memory_stats()
    state = make_train_state(init_model(cfg, seed=0, device="cuda"), opt)
    step_fn = make_step(cfg, opt, RunConfig(remat_policy=remat))

    def step(s):
        global state
        t = time.perf_counter()
        state, m = step_fn(state, batch(s))
        float(m["loss"]); torch.cuda.synchronize()
        return time.perf_counter() - t

    step(0)
    walls = [step(s) for s in (1, 2, 3)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_wall = step(4)
    busy = sum(dev(e) for e in prof.key_averages()
               if str(getattr(e, "device_type", "CUDA")).endswith("CUDA")) / 1e6
    cp = cProfile.Profile(); cp.enable(); cp_wall = step(5); cp.disable()
    st = pstats.Stats(cp)
    disp = [(nc, tt, ct) for (f, l, name), (cc, nc, tt, ct, _) in st.stats.items()
            if name == "__torch_dispatch__" and "checkpoint" in f]
    tables[remat] = sorted(((tt, nc, f"{f.split('/')[-1]}:{l}:{name}")
                            for (f, l, name), (cc, nc, tt, ct, _) in st.stats.items()),
                           reverse=True)[:15]
    print(json.dumps({
        "remat": remat, "walls_s": walls, "median_s": sorted(walls)[1],
        "profiled_wall_s": prof_wall, "device_busy_s": busy,
        "device_idle_share": 1 - busy / prof_wall, "cprofile_wall_s": cp_wall,
        "sac_dispatch_calls": sum(d[0] for d in disp),
        "sac_dispatch_tottime_s": sum(d[1] for d in disp),
        "sac_dispatch_cumtime_s": max((d[2] for d in disp), default=0.0),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    del state, step_fn
for remat, rows in tables.items():
    print(f"cProfile top host functions by own time, remat={remat}: tottime s, calls, name")
    for tt, nc, name in rows:
        print(f"  {tt:8.3f} {nc:8d} {name[:100]}")
