"""PyTorch port, the launch layer: the cell grid, parameter counts, the
logical-axes tree, the cells' input stand-ins and cache axes, the analytic
roofline floors, the microbatch and cold-expert choices, all against the
reference with no tolerance where both compute the same numbers;
``RooflineTerms`` at the H100's constants; and the dry run's CLI in a
subprocess (``--list`` against the reference's, one cell traced on a
256-rank fake group)."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models.model import model_specs as jmodel_specs
from repro.models.param import logical_axes as jlogical_axes
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import roofline as troof
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as tsteps
from repro_torch.models.params import logical_axes, model_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(treg.all_archs())
CELLS = [(a, s) for a, s, _ in treg.all_cells()]


def _keyed(tree, is_leaf=None):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _port_paths(tree, leaf, pre=""):
    """{jax keystr path: leaf} of a port tree of dicts / tuples / lists."""
    if leaf(tree):
        return {pre: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_paths(v, leaf, pre + (f"['{k}']" if isinstance(k, str) else f"[{k}]")))
    return out


def _is_axes(x):
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)


def test_cell_grid_matches_reference():
    assert treg.all_archs() == jreg.all_archs()
    for skipped in (False, True):
        assert list(treg.all_cells(skipped)) == list(jreg.all_cells(skipped))
    assert {k: tuple(vars(v).values()) for k, v in tbase.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in jbase.SHAPES.items()}
    assert tbase.LONG_CONTEXT_ARCHS == jbase.LONG_CONTEXT_ARCHS


def test_run_config_fields_and_defaults_match_reference():
    import dataclasses
    t = {f.name: f.default for f in dataclasses.fields(tbase.RunConfig)}
    j = {f.name: f.default for f in dataclasses.fields(jbase.RunConfig)}
    assert t == j


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    t, j = treg.get_config(arch), jreg.get_config(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_tree_matches_reference(arch):
    got = _port_paths(logical_axes(model_specs(treg.get_config(arch))), _is_axes)
    want = _keyed(jlogical_axes(jmodel_specs(jreg.get_config(arch))), _is_axes)
    assert got == want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_inputs_match_reference(arch, shape):
    """Batch stand-ins (shape, dtype), the decode cache's leaves, and the
    axes trees of both, leaf for leaf."""
    t_cfg, j_cfg = treg.get_config(arch), jreg.get_config(arch)
    t_sh, j_sh = treg.get_shape(shape), jreg.get_shape(shape)
    got = tspecs.cell_input_specs(t_cfg, t_sh)
    want = jspecs.cell_input_specs(j_cfg, j_sh)
    is_t = lambda x: hasattr(x, "device") and not isinstance(x, dict)
    g = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in _port_paths(got, is_t).items()}
    w = {k: (tuple(v.shape), str(v.dtype)) for k, v in _keyed(want).items()}
    assert g == w
    assert all(v.device.type == "meta" for v in _port_paths(got, is_t).values())
    ax_t = _port_paths(tspecs.cell_input_axes(t_cfg, t_sh), _is_axes)
    assert ax_t == _keyed(jspecs.cell_input_axes(j_cfg, j_sh), _is_axes)
    for path, axes in ax_t.items():           # axes parallel to the stand-ins
        assert len(axes) == len(g[path][0]), path


@pytest.mark.parametrize("kv_quant", [False, True])
def test_cache_axes_match_cache_structure(kv_quant):
    from repro_torch.configs import resolve_config
    from repro_torch.models.model import init_cache
    for cfg in (resolve_config("tiny-moe"), treg.get_config("whisper-small"),
                treg.get_config("jamba-v0.1-52b")):
        cache = _port_paths(init_cache(cfg, 2, 16, device="meta", kv_quant=kv_quant),
                            lambda x: hasattr(x, "device") and not isinstance(x, dict))
        axes = _port_paths(tspecs.cache_axes(cfg, kv_quant), _is_axes)
        assert set(cache) == set(axes)
        assert all(len(axes[k]) == cache[k].dim() for k in cache)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_bytes_match_reference(arch, shape):
    t = (troof.model_flops(treg.get_config(arch), treg.get_shape(shape)),
         troof.model_bytes(treg.get_config(arch), treg.get_shape(shape)))
    j = (jroof.model_flops(jreg.get_config(arch), jreg.get_shape(shape)),
         jroof.model_bytes(jreg.get_config(arch), jreg.get_shape(shape)))
    np.testing.assert_allclose(t, j, rtol=1e-9, atol=0)


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_auto_num_micro_matches_reference(arch):
    for mesh in (FakeMesh(data=16, model=16), FakeMesh(pod=2, data=16, model=16)):
        for seq_shard in (False, True):
            for shape in ("train_4k", "prefill_32k"):
                t = tsteps.auto_num_micro(treg.get_config(arch), treg.get_shape(shape), mesh,
                                          tbase.RunConfig(seq_shard_activations=seq_shard))
                j = jsteps.auto_num_micro(jreg.get_config(arch), jreg.get_shape(shape), mesh,
                                          jbase.RunConfig(seq_shard_activations=seq_shard))
                assert t == j
                assert treg.get_shape(shape).global_batch % t == 0


@pytest.mark.parametrize("arch", [a for a in ARCHS if treg.get_config(a).moe is not None])
def test_duplex_k_cold_matches_reference(arch):
    for tokens in (1, 8, 128, 1024):
        assert tsteps.duplex_k_cold(treg.get_config(arch), tokens) == \
            jsteps.duplex_k_cold(jreg.get_config(arch), tokens)


def test_duplex_k_cold_is_zero_without_moe():
    assert tsteps.duplex_k_cold(treg.get_config("qwen3-8b"), 128) == 0


def test_roofline_terms_at_h100_constants():
    t = troof.RooflineTerms(chips=256, flops_per_device=989e12, bytes_per_device=3.35e12,
                            collective_bytes_per_device=50e9,
                            model_flops_global=989e12 * 128, model_bytes_global=0.0)
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert t.t_compute == pytest.approx(1.0)
    assert t.t_memory == pytest.approx(1.0)
    assert t.t_collective == pytest.approx(1.0)
    assert t.roofline_fraction == pytest.approx(0.5)
    assert t.flop_mfu_at_bound == pytest.approx(0.5)
    assert t.dominant in ("compute", "memory", "collective")
    d = t.to_dict()
    assert d["t_bound"] == pytest.approx(1.0) and d["flops_global"] == 989e12 * 256


def test_model_flops_scales():
    cfg = treg.get_config("qwen3-8b")
    ratio = troof.model_flops(cfg, treg.get_shape("train_4k")) / \
        troof.model_flops(cfg, treg.get_shape("prefill_32k"))
    assert 1.5 < ratio < 3.0
    assert troof.model_bytes(cfg, treg.get_shape("decode_32k")) > 0


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable] + args, capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)


def test_dryrun_list_matches_reference():
    for extra in ([], ["--mesh", "single", "--arch", "gemma3-4b"], ["--slice", "5:17"]):
        t = _run(["-m", "repro_torch.launch.dryrun", "--all", "--list"] + extra, 120)
        j = _run(["-m", "repro.launch.dryrun", "--all", "--list"] + extra, 120)
        assert t.returncode == 0 and j.returncode == 0, t.stderr + j.stderr
        assert t.stdout == j.stdout and t.stdout.count("\n") > 0


def test_dryrun_subprocess_one_cell(tmp_path):
    """The reference's cell, traced on a 256-rank fake group: ok, 256
    devices, a positive bound, per-device memory, and this process still
    has no process group."""
    import torch.distributed as dist
    out = str(tmp_path / "dr")
    r = _run(["-m", "repro_torch.launch.dryrun", "--arch", "mamba2-2.7b", "--shape",
              "long_500k", "--mesh", "single", "--out", out], 300)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.load(open(os.path.join(out, "mamba2-2.7b__long_500k__single.json")))
    assert rec["status"] == "ok"
    assert rec["mesh_info"]["num_devices"] == 256
    assert rec["roofline"]["t_bound"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["params"] == jreg.get_config("mamba2-2.7b").param_count()
    assert not dist.is_initialized()
