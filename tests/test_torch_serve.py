"""PyTorch port, the serve CLI (``repro_torch/launch/serve.py``):

* its flags are the reference CLI's (``src/repro/launch/serve.py``) plus
  ``--device``;
* ``main`` on the CPU for three rows of the README flag matrix (the
  quickstart, a two-replica fleet under chaos, the async loop with
  speculative decoding) and gemma3-4b's reduced stack on int8 dense rows
  with rings, at a few requests of ~24 tokens and 8 new ones,
  the port's ``init_model`` returning the reference's weights: every
  report line equals the reference CLI's, TBT and wall times aside (both
  CLIs draw their prompts from the same numpy seed);
* ``--profile DIR`` writes a trace; without ``--device`` and without a
  card the CLI raises.
"""
import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as ref_serve
from repro.models.model import init_model as ref_init_model
from repro_torch.launch import serve
from repro_torch.models.params import from_numpy_tree

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers
ROOT = Path(__file__).resolve().parents[1]
FLAG = re.compile(r'add_argument\(\s*"(--[a-z0-9-]+)"')
BASE = "--arch tiny-moe --requests 4 --l-in 24 --l-out 8 --kv-page-size 16 --max-len 64"
ROWS = {
    "quickstart": "--kv-layout paged --kv-quant --prefill-chunk 64 --prefix-share "
                  "--oversubscribe 0.5",
    "fleet_chaos": "--replicas 2 --chaos 0 --kv-layout paged --prefix-share",
    "async_spec": "--async --spec-k 4 --kv-layout paged --prefill-chunk 16",
    # gemma3-4b's reduced stack (5 sliding-window layers and a global one)
    # on int8 dense rows, its local layers' rings of window + 1 slots
    "windowed_int8": "--arch gemma3-4b --reduced --kv-layout dense --kv-quant --kernels "
                     "--max-len 1100",
}


def test_flags_are_the_reference_flags_plus_the_device():
    ref = FLAG.findall((ROOT / "src/repro/launch/serve.py").read_text())
    port = FLAG.findall((ROOT / "src/repro_torch/launch/serve.py").read_text())
    assert len(ref) == len(set(ref)) and len(port) == len(set(port))
    assert port == ref + ["--device"]


def _lines(text):
    """The report's lines, host-clock numbers masked."""
    text = re.sub(r"median TBT=[0-9.a-z]+ms", "median TBT=*", text)
    text = re.sub(r"stage-gap mean=[0-9.]+ms", "stage-gap mean=*", text)
    return text.splitlines()


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, _lines(out.getvalue())


@pytest.mark.parametrize("row", list(ROWS), ids=list(ROWS))
def test_report_lines_match_the_reference(row, monkeypatch):
    argv = (BASE + " " + ROWS[row]).split()
    want = _run(ref_serve.main, argv)

    def reference_weights(cfg, seed=0, device="cuda"):
        pj = ref_init_model(jax.random.PRNGKey(seed), cfg)
        return from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), device)

    monkeypatch.setattr(serve, "init_model", reference_weights)
    got = _run(serve.main, argv + ["--device", "cpu"])
    assert got == want
    assert got[0] == 0 and any("4/4 completed" in line for line in got[1])


def test_profile_writes_a_trace(tmp_path):
    rc, lines = _run(serve.main, (BASE + " --requests 2 --device cpu --profile "
                                  + str(tmp_path)).split())
    assert rc == 0 and any("profiler trace written" in line for line in lines)
    traces = list(tmp_path.glob("*.json"))
    assert traces and traces[0].stat().st_size > 0


def test_without_a_device_flag_it_needs_a_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    code = ("import sys; sys.modules['jax'] = None\n"
            "from repro_torch.launch.serve import main\n"
            "try:\n    main(['--requests', '1'])\n"
            "except RuntimeError as e:\n    print('raised', 'cuda' in str(e).lower())\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised True"
