"""PyTorch port, isolation: ``repro_torch`` and ``chip_smoke.py`` import no
JAX and nothing of ``repro``; entry points default to the card and refuse
to run without one instead of falling back to the CPU."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None                     # any jax import now fails
sys.modules["ml_dtypes"] = None               # and any ml_dtypes import
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
for n in ("repro_torch.kernels.quant", "repro_torch.kernels.decode_attn",
          "repro_torch.kernels.moe_gemm", "repro_torch.kernels.moe_gemv",
          "repro_torch.kernels.ssd_decode", "repro_torch.models.ssm",
          "repro_torch.models.attention", "repro_torch.serving.kvmanager",
          "repro_torch.serving.preemption", "repro_torch.serving.faults",
          "repro_torch.serving.scheduler", "repro_torch.serving.request",
          "repro_torch.serving.drafter", "repro_torch.serving.router",
          "repro_torch.serving.fleet", "repro_torch.core.opb", "repro_torch.core.dispatch",
          "repro_torch.launch.serve",
          "repro_torch.configs.jamba_v0_1_52b", "repro_torch.configs.gemma3_4b",
          "repro_torch.configs.qwen3_8b", "repro_torch.configs.command_r_35b",
          "repro_torch.configs.mistral_large_123b", "repro_torch.configs.mamba2_2p7b",
          "repro_torch.configs.deepseek_moe_16b", "repro_torch.configs.whisper_small",
          "repro_torch.configs.internvl2_1b",
          "repro_torch.kernels.flash_attn",
          "repro_torch.training.optimizer", "repro_torch.training.data",
          "repro_torch.training.train_state", "repro_torch.training.loop",
          "repro_torch.training.checkpoint", "repro_torch.training.compression",
          "repro_torch.training.pipeline", "repro_torch.launch.mesh",
          "repro_torch.launch.train", "repro_torch.configs.registry",
          "repro_torch.sharding.rules", "repro_torch.launch.specs",
          "repro_torch.launch.steps", "repro_torch.launch.roofline",
          "repro_torch.launch.op_cost", "repro_torch.launch.dryrun",
          "repro_torch.sim", "repro_torch.sim.workload", "repro_torch.sim.metrics",
          "repro_torch.sim.paper_models", "repro_torch.sim.cluster", "repro_torch.sim.specs",
          "repro_torch.sim.layermodel", "repro_torch.sim.engine_sim"):
    assert n in names, n
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert not [m for m in ("jax", "ml_dtypes") if sys.modules[m] is not None]
import torch
assert not torch.cuda.is_available()
from repro_torch.configs import resolve_config
from repro_torch.models.params import init_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import FaultInjector
from repro_torch.launch.train import main as train_main
from repro_torch.launch.serve import main as serve_main
from repro_torch.serving.fleet import Fleet
cfg = resolve_config("tiny-moe")
for main, argv in ((train_main, ["--arch", "tiny-moe", "--steps", "1"]),
                   (serve_main, ["--arch", "tiny-moe", "--requests", "1"]),
                   (serve_main, ["--requests", "1", "--replicas", "2"])):
    try:
        main(argv)
    except RuntimeError:
        pass
    else:
        raise AssertionError(f"{argv} ran without a card")
try:
    init_model(cfg)
except RuntimeError:
    pass
else:
    raise AssertionError("init_model ran without a card")
params = init_model(cfg, device="cpu")
hybrid = resolve_config("jamba-v0.1-52b")
windowed = resolve_config("gemma3-4b", reduced=True)
for name in ("qwen3-8b", "command-r-35b", "mistral-large-123b", "mamba2-2.7b"):
    resolve_config(name, reduced=True)
for stack, flags in ((cfg, {"kv_page_size": 8, "prefill_chunk_tokens": 16}),
                     (cfg, {"kv_page_size": 8, "prefill_chunk_tokens": 16,
                            "kv_quant": True, "moe_ragged": False}),
                     (cfg, {"kv_page_size": 8, "prefix_share": True,
                            "preemption": "recompute", "kv_num_pages": 9}),
                     (cfg, {"kv_layout": "dense", "prefill_chunk_tokens": 16,
                            "preemption": "migrate"}),
                     (hybrid, {"kv_layout": "dense"}),
                     (windowed, {"kv_layout": "dense", "kv_quant": True}),
                     (cfg, {"kv_page_size": 8, "queue_cap": 2,
                            "overload_policy": "shed-oldest", "aging_rounds": 2,
                            "injector": FaultInjector(0), "audit_stages": True}),
                     (cfg, {"kv_page_size": 8, "spec_k": 4, "on_token": print}),
                     (cfg, {"kv_page_size": 8, "seed": 3})):
    try:
        ServingEngine(stack, params, max_slots=2, max_len=32, **flags)
    except RuntimeError as e:
        assert "cuda" in str(e).lower()
    else:
        raise AssertionError("ServingEngine ran without a card")
try:
    Fleet(lambda i, inj: ServingEngine(cfg, params, max_slots=2, max_len=32), 2)
except RuntimeError as e:
    assert "cuda" in str(e).lower()
else:
    raise AssertionError("a Fleet of card engines was built without a card")
print("OK", len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""           # no card, whatever the host has
    return env


def test_port_imports_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_sources_name_no_jax_or_repro_import():
    bad = re.compile(r"^\s*(import (jax|ml_dtypes)|from (jax|ml_dtypes)|import repro\b|"
                     r"from repro[. ])", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in bad.finditer(f.read_text())]
    assert not hits, hits


def test_chip_smoke_fails_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone, without the rest of the repository, it fails too
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
