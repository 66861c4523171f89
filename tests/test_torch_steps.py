"""PyTorch port, the sharded step builders (``launch/steps.py``) against the
reference's ``launch/steps.py`` with the same weights (``from_numpy_tree``)
and the same batch:

* one rank of gloo, a (1, 1) mesh, against a one-device mesh: the train
  step on tiny-moe and tiny-dense with one and two microbatches (params,
  mu and nu within 1e-5, the loss within 1e-5 relative, the bands of
  ``tests/test_torch_train.py``), the prefill and serve steps (equal next
  tokens, caches within 1e-5); and the sharded train step against the
  port's own unsharded ``make_step`` at step 1 (within 1e-6);
* four gloo ranks as a (2, 2) mesh (``tests/torch_steps_worker.py``)
  against the reference on a (2, 2) host mesh in a subprocess
  (``XLA_FLAGS`` in that subprocess's environment only): the dispatch
  grids agree, and so do the numbers;
* the int8 error-feedback cross-pod mean on a (2, 1, 1) ("pod", "data",
  "model") mesh, by the same two routes.

The train steps run at step 0, whose learning rate is 0 (warmup), as
the reference's fresh state does (parameters stay, mu and nu carry the
gradients), and at step 1, learning rate 1e-3 (``_close_params``: the
parameters within 1e-5 wherever the reference's gradient is 0 or above
``GRAD_FLOOR``; below it Adam's first update ``g / (|g| + eps)``, eps 1e-8,
turns the gradient's float32 rounding into up to 1.7e-5 of departure, so
those few elements are held to the bound of the two updates instead)."""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRun
from repro.configs.base import ShapeConfig as JShape
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.train import resolve_config as jresolve
from repro.models import model as jmodel
from repro.training import optimizer as jopt
from repro_torch.configs import resolve_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.execution import ExecutionPlan
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import make_step
from repro_torch.models.params import from_numpy_tree, tree_leaves, tree_map
from repro_torch.training import optimizer as topt
from repro_torch.training.train_state import make_train_state

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
B, S, BLK = 4, 32, 16
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
# a reference gradient at or below this (and not 0) is within a few of its own
# float32 rounding errors (mu departs by up to 2.6e-10 on tiny-moe at step 1,
# a gradient error of 2.6e-9) scaled by Adam's 1 / (|g| + eps)
GRAD_FLOOR = 1e-7
LEFT_OUT_MAX = 0.01     # of a leaf's elements; 134 of 131072 (0.1%) measured


def _weights(arch, seed=0):
    pj = jmodel.init_model(jax.random.PRNGKey(seed), jresolve(arch, False))
    return pj, jax.tree_util.tree_map(np.asarray, pj)


def _tokens(vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().float().numpy()


def _close(want, got, atol):
    """Trees leaf by leaf, ``got`` in the port's nesting of numpy arrays."""
    w, g = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)
    assert len(w) == len(g)
    for a, b in zip(w, g):
        np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(a, np.float32),
                                   atol=atol, rtol=0)


def _close_params(want, mu, got, lr=OPT["learning_rate"], beta1=0.9):
    """Updated parameters leaf by leaf, ``got`` in the port's nesting: within
    1e-5 wherever the reference's clipped gradient (``mu / (1 - beta1)``,
    mu from 0) is 0 or above ``GRAD_FLOOR``. Below it, where Adam's update
    is set by the gradient's rounding, each side moved by at most the
    learning rate (``|g| / (|g| + eps) < 1`` before the bias corrections'
    ratio, under 1 at step 1), so the two are held within 2 lr, and such
    elements must be under ``LEFT_OUT_MAX`` of their leaf. Returns the
    count left out."""
    w, m, g = (jax.tree_util.tree_leaves(t) for t in (want, mu, got))
    assert len(w) == len(m) == len(g)
    left = 0
    for a, mu_a, b in zip(w, m, g):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        grad = np.abs(np.asarray(mu_a, np.float32)) / (1 - beta1)
        low = (grad > 0) & (grad <= GRAD_FLOOR)
        np.testing.assert_allclose(b[~low], a[~low], atol=1e-5, rtol=0)
        np.testing.assert_allclose(b[low], a[low], atol=2 * lr, rtol=0)
        assert low.sum() <= LEFT_OUT_MAX * low.size
        left += int(low.sum())
    return left


def _ref_train(arch, mesh_j, pj, toks, n_micro, step=0, comp="none"):
    cfg = jresolve(arch, False)
    run = JRun(attn_q_block=BLK, attn_kv_block=BLK, microbatch_size=B // n_micro,
               grad_compression=comp)
    opt = jopt.OptConfig(**OPT)
    fn, _, in_sh, out_sh, nm, rules = jsteps.make_train_step(
        cfg, JShape("t", "train", S, B), mesh_j, run, opt)
    state = {"params": pj, "opt": jopt.init_opt_state(pj, opt), "step": jnp.int32(step)}
    with mesh_j:
        new, met = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
            state, {"tokens": jnp.asarray(toks)})
    return new, met, nm, jsteps.dispatch_grid(mesh_j, rules)


@pytest.fixture(scope="module")
def one_rank():
    with tmesh.process_group("cpu"):
        yield tmesh.make_mesh((1, 1), ("data", "model"), "cpu")


def _port_train(arch, mesh, pnp, toks, n_micro, step=0):
    cfg = resolve_config(arch)
    run = RunConfig(attn_q_block=BLK, attn_kv_block=BLK, microbatch_size=B // n_micro)
    opt = topt.OptConfig(**OPT)
    fn, _, in_pl, _, nm, _ = tsteps.make_train_step(cfg, ShapeConfig("t", "train", S, B),
                                                    mesh, run, opt)
    state = make_train_state(from_numpy_tree(pnp, "cpu"), opt)
    state["step"] = step
    state = tsteps.distribute_tree(state, in_pl[0], mesh)
    for leaf in tree_leaves(state["params"]):
        leaf.requires_grad_(True)
    batch = tsteps.distribute_tree({"tokens": torch.from_numpy(toks)}, in_pl[1], mesh)
    new, met = fn(state, batch)
    return new, met, nm


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["tiny-moe", "tiny-dense"])
def test_train_step_matches_reference_on_one_rank(one_rank, arch, n_micro, step):
    """Step 0 (learning rate 0) and step 1 (1e-3, where the parameters
    move): the loss within 1e-5 relative, mu and nu within 1e-5, the
    parameters within 1e-5 (at step 1 by ``_close_params``)."""
    pj, pnp = _weights(arch)
    toks = _tokens(256)
    new_j, met_j, nm_j, _ = _ref_train(arch, jmake_mesh((1, 1), ("data", "model")), pj,
                                       toks, n_micro, step=step)
    new_t, met_t, nm_t = _port_train(arch, one_rank, pnp, toks, n_micro, step=step)
    assert nm_t == nm_j == n_micro
    loss_j = float(met_j["loss"])
    assert abs(float(_full(met_t["loss"])) - loss_j) <= 1e-5 * abs(loss_j)
    assert new_t["step"] == step + 1
    _close(new_j["opt"]["mu"], tree_map(new_t["opt"]["mu"], _full), 1e-5)
    _close(new_j["opt"]["nu"], tree_map(new_t["opt"]["nu"], _full), 1e-5)
    got = tree_map(new_t["params"], _full)
    if step == 0:
        _close(new_j["params"], got, 1e-5)
        return
    moved = max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(new_j["params"]), jax.tree_util.tree_leaves(pnp)))
    assert moved > 1e-4
    _close_params(new_j["params"], new_j["opt"]["mu"], got)


@pytest.mark.parametrize("arch", ["tiny-moe", "tiny-dense"])
def test_train_step_matches_the_unsharded_step(one_rank, arch):
    """At step 1 (learning rate 1e-3) the sharded step on one rank against
    the port's ``make_step`` with the same plan: parameters within 1e-6."""
    _, pnp = _weights(arch)
    toks = _tokens(256)
    new_t, met_t, _ = _port_train(arch, one_rank, pnp, toks, 1, step=1)
    cfg = resolve_config(arch)
    opt = topt.OptConfig(**OPT)
    state = make_train_state(from_numpy_tree(pnp, "cpu"), opt)
    state["step"] = 1
    plan = ExecutionPlan(moe_impl="grouped", attn_q_block=BLK, attn_kv_block=BLK)
    new_u, met_u = make_step(cfg, opt, RunConfig(attn_q_block=BLK, attn_kv_block=BLK),
                             plan=plan)(state, {"tokens": torch.from_numpy(toks)})
    assert float(_full(met_t["loss"])) == float(met_u["loss"])
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(tree_map(new_u["params"], _full)),
        jax.tree_util.tree_leaves(pnp)))
    assert moved > 1e-4
    _close(tree_map(new_u["params"], _full), tree_map(new_t["params"], _full), 1e-6)


@pytest.mark.parametrize("arch", ["tiny-moe", "tiny-dense"])
def test_prefill_and_serve_steps_match_reference_on_one_rank(one_rank, arch):
    """A prefill of two prompts (20 and 13 live tokens of 32) into a fresh
    cache, then one decode step on it (the duplex MoE's plain route on
    tiny-moe): equal next tokens, caches within 1e-5."""
    pj, pnp = _weights(arch)
    cfg_j, cfg_t = jresolve(arch, False), resolve_config(arch)
    toks = _tokens(256)[:2]
    true_len = np.array([20, 13], np.int32)
    mesh_j = jmake_mesh((1, 1), ("data", "model"))
    pre_sh, dec_sh = ("p", "prefill", S, 2), ("d", "decode", S, 2)
    fn, _, in_sh, out_sh, _ = jsteps.make_prefill_step(cfg_j, JShape(*pre_sh), mesh_j, JRun())
    with mesh_j:
        tok_j, cache_j = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
            pj, {"tokens": jnp.asarray(toks), "true_len": jnp.asarray(true_len)})
    fn_s, _, in_sh, out_sh, plan_j, _ = jsteps.make_serve_step(cfg_j, JShape(*dec_sh), mesh_j,
                                                               JRun())
    with mesh_j:
        tok2_j, cache2_j = jax.jit(fn_s, in_shardings=in_sh, out_shardings=out_sh)(
            pj, {"tokens": tok_j[:, None]}, cache_j)

    mesh = one_rank
    fn, _, in_pl, _, _ = tsteps.make_prefill_step(cfg_t, ShapeConfig(*pre_sh), mesh, RunConfig())
    params = tsteps.distribute_tree(from_numpy_tree(pnp, "cpu"), in_pl[0], mesh)
    batch = tsteps.distribute_tree({"tokens": torch.from_numpy(toks),
                                    "true_len": torch.from_numpy(true_len)}, in_pl[1], mesh)
    tok_t, cache_t = fn(params, batch)
    np.testing.assert_array_equal(_full(tok_t), np.asarray(tok_j))
    _close(cache_j, tree_map(cache_t, _full), 1e-5)
    fn_s, _, in_pl, _, plan_t, _ = tsteps.make_serve_step(cfg_t, ShapeConfig(*dec_sh), mesh,
                                                          RunConfig())
    assert (plan_t.moe_impl, plan_t.k_cold) == (plan_j.moe_impl, plan_j.k_cold)
    tok2_t, cache2_t = fn_s(params, tsteps.distribute_tree(
        {"tokens": tok_t[:, None]}, in_pl[1], mesh), cache_t)
    np.testing.assert_array_equal(_full(tok2_t), np.asarray(tok2_j))
    _close(cache2_j, tree_map(cache2_t, _full), 1e-5)


REF = r'''
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import RunConfig, ShapeConfig
from repro.launch import steps
from repro.launch.mesh import make_mesh
from repro.launch.train import resolve_config
from repro.training import optimizer as jopt
arch, comp, step, mesh_shape, weights, tokens, out = sys.argv[1:8]
mesh_shape = tuple(int(x) for x in mesh_shape.split(","))
mesh = make_mesh(mesh_shape, ("pod", "data", "model")[-len(mesh_shape):])
opt = jopt.OptConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3)
fn, _, in_sh, out_sh, nm, rules = steps.make_train_step(
    resolve_config(arch, False), ShapeConfig("t", "train", 32, 4), mesh,
    RunConfig(attn_q_block=16, attn_kv_block=16, grad_compression=comp), opt)
pj = jax.tree_util.tree_map(jnp.asarray, pickle.load(open(weights, "rb")))
state = {"params": pj, "opt": jopt.init_opt_state(pj, opt), "step": jnp.int32(int(step))}
if comp == "int8_ef":
    state["ef_err"] = jax.tree_util.tree_map(lambda p: jnp.zeros(p.shape, jnp.float32), pj)
with mesh:
    new, met = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
        state, {"tokens": jnp.asarray(np.load(tokens))})
to_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)
pickle.dump({"loss": float(met["loss"]), "grid": tuple(steps.dispatch_grid(mesh, rules)),
             "n_micro": nm, "params": to_np(new["params"]), "mu": to_np(new["opt"]["mu"]),
             "nu": to_np(new["opt"]["nu"])}, open(out, "wb"))
'''


def _multi_rank(tmp_path, arch, mesh_shape, comp, step):
    """The reference in a subprocess with its own host device count, and the
    port on ``prod(mesh_shape)`` gloo ranks, side by side."""
    world = int(np.prod(mesh_shape))
    _, pnp = _weights(arch)
    weights, tokens = str(tmp_path / "w.pkl"), str(tmp_path / "t.npy")
    with open(weights, "wb") as f:
        pickle.dump(pnp, f)
    np.save(tokens, _tokens(256))
    shape_s = ",".join(map(str, mesh_shape))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={world}")
    ref_out, port_out = str(tmp_path / "ref.pkl"), str(tmp_path / "port.pkl")
    procs = [subprocess.Popen([sys.executable, "-c", REF, arch, comp, str(step), shape_s,
                               weights, tokens, ref_out], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    env_t = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env_t.pop("XLA_FLAGS", None)
    rdv = "file://" + str(tmp_path / "rdv")
    procs += [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_steps_worker.py"),
                                str(r), str(world), shape_s, arch, comp, str(step), weights,
                                tokens, rdv, port_out], env=env_t,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for r in range(world)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    with open(ref_out, "rb") as f, open(port_out, "rb") as g:
        return pickle.load(f), pickle.load(g)


def _assert_same_step(ref, port, masked=False):
    """Grids, microbatches, the loss within 1e-5 relative, mu and nu within
    1e-5, the parameters within 1e-5 (``masked``: by ``_close_params``)."""
    assert port["grid"] == ref["grid"]
    assert port["n_micro"] == ref["n_micro"]
    assert abs(float(port["loss"]) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    if masked:
        _close_params(ref["params"], ref["mu"], port["params"])
    else:
        _close(ref["params"], port["params"], 1e-5)
    _close(ref["mu"], port["mu"], 1e-5)
    _close(ref["nu"], port["nu"], 1e-5)


def test_train_step_on_four_ranks_matches_the_reference_mesh(tmp_path):
    """(2, 2) ("data", "model") at step 1 (learning rate 1e-3; mu and nu from
    0 carry the same gradients as at step 0): the MoE dispatches in the
    reference's two tiles, the batch over data and the heads and experts'
    hidden dims over model."""
    ref, port = _multi_rank(tmp_path, "tiny-moe", (2, 2), "none", 1)
    assert ref["grid"] == (2, 1)
    _assert_same_step(ref, port, masked=True)


def test_int8_error_feedback_across_pods_matches_the_reference(tmp_path):
    """(2, 1, 1) ("pod", "data", "model") with ``grad_compression="int8_ef"``
    at step 1 (learning rate 1e-3): the experts are sharded over the pods,
    and the reference's ``shard_map`` takes each gradient whole over "pod"
    with one scale for the tensor. A gradient at a rounding tie may land one
    int8 step apart (3.7e-6 in mu), within the band."""
    ref, port = _multi_rank(tmp_path, "tiny-moe", (2, 1, 1), "int8_ef", 1)
    _assert_same_step(ref, port)
