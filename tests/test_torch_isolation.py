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
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
for n in ("repro_torch.kernels.quant", "repro_torch.kernels.decode_attn",
          "repro_torch.kernels.moe_gemm", "repro_torch.kernels.moe_gemv",
          "repro_torch.kernels.ssd_decode", "repro_torch.models.ssm",
          "repro_torch.models.attention", "repro_torch.serving.kvmanager",
          "repro_torch.configs.jamba_v0_1_52b"):
    assert n in names, n
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
import torch
assert not torch.cuda.is_available()
from repro_torch.configs import resolve_config
from repro_torch.models.params import init_model
from repro_torch.serving.engine import ServingEngine
cfg = resolve_config("tiny-moe")
try:
    init_model(cfg)
except RuntimeError:
    pass
else:
    raise AssertionError("init_model ran without a card")
params = init_model(cfg, device="cpu")
hybrid = resolve_config("jamba-v0.1-52b")
for flags in ({"kv_page_size": 8, "prefill_chunk_tokens": 16},
              {"kv_page_size": 8, "prefill_chunk_tokens": 16, "kv_quant": True,
               "moe_ragged": False},
              {"kv_layout": "dense"}):
    try:
        ServingEngine(hybrid if "kv_layout" in flags else cfg, params, max_slots=2,
                      max_len=32, **flags)
    except RuntimeError as e:
        assert "cuda" in str(e).lower()
    else:
        raise AssertionError("ServingEngine ran without a card")
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
    bad = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro[. ])", re.M)
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
