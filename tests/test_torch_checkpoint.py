"""PyTorch port, checkpoints: ``training/checkpoint.py`` and the loop's
checkpoint boundaries, held to ``tests/test_training.py``'s and
``tests/test_elastic.py``'s checks and to the JAX package itself:
checkpoints cross between the packages in float32, the port restores the
bf16 checkpoints the reference writes and cannot read back, and a run
stopped by SIGTERM resumes to the uninterrupted run's losses and
parameters. Also ``core/execution.py::shard_blocks`` against the
reference's."""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan, shard_blocks as jshard_blocks
from repro.launch.train import resolve_config as jresolve
from repro.models import model as jmodel
from repro.training import checkpoint as jck
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro_torch.configs import RunConfig, resolve_config
from repro_torch.core.execution import ExecutionPlan, shard_blocks
from repro_torch.launch import train as ttrain
from repro_torch.models.params import from_numpy_tree, to_numpy_tree, tree_leaves
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training.checkpoint import (SEP, AsyncCheckpointer, latest_checkpoint,
                                             list_checkpoints, restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.loop import LoopConfig, train_loop
from repro_torch.training.train_state import make_train_state

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

CFG_J, CFG_T = jresolve("tiny-moe", False), resolve_config("tiny-moe")
BLK = 16
quiet = lambda *_: None


def _state(v=1.0):
    return {"params": {"w": torch.full((3, 2), v)}, "step": 7}


def _flat_equal(want, got):
    """Two trees of tensors / ints hold the same bits leaf by leaf."""
    for w, g in zip(tree_leaves(want), tree_leaves(got)):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
        else:
            assert type(g) is type(w) and g == w


# ---------------------------------------------------------------------------
# tests/test_training.py's checkpoint and loop checks, on the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 10, _state(2.5))
    restored, step = restore_checkpoint(d, _state())
    assert step == 10 and restored["step"] == 7 and type(restored["step"]) is int
    torch.testing.assert_close(restored["params"]["w"], torch.full((3, 2), 2.5))


def test_restore_copies_into_the_templates_tensors(tmp_path):
    """Without ``device`` a restore writes into the template's own tensors
    (so a resume holds one copy of the state): the leaves it returns are
    the template's, with the stored bits, their dtype and their
    ``requires_grad``."""
    d = str(tmp_path / "ck")
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    save_checkpoint(d, 2, {"params": {"w": w}, "mu": w.float() * 3, "step": 4})
    tmpl = {"params": {"w": torch.zeros(5, 3, dtype=torch.bfloat16).requires_grad_(True)},
            "mu": torch.zeros(5, 3), "step": 0}
    restored, step = restore_checkpoint(d, tmpl)
    assert step == 2 and restored["step"] == 4
    assert restored["params"]["w"] is tmpl["params"]["w"] and restored["mu"] is tmpl["mu"]
    assert restored["params"]["w"].requires_grad
    assert torch.equal(restored["params"]["w"].detach(), w)
    assert torch.equal(restored["mu"], w.float() * 3)


def test_checkpoint_keep_k(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, _state(float(s)), keep=2)
    assert list_checkpoints(d) == [4, 5]
    assert latest_checkpoint(d) == 5
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]   # no temp left


def test_checkpoint_atomicity_ignores_partial(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, _state())
    os.makedirs(os.path.join(d, "step_00000009"))        # a crashed write: no DONE
    assert latest_checkpoint(d) == 3
    restored, step = restore_checkpoint(d, _state())
    assert step == 3


def test_checkpoint_shape_and_key_mismatch_raise(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, _state())
    with pytest.raises(ValueError):
        restore_checkpoint(d, {"params": {"w": torch.zeros(4, 4)}, "step": 0})
    with pytest.raises(KeyError):
        restore_checkpoint(d, {"params": {"w": torch.zeros(3, 2), "b": torch.zeros(2)},
                               "step": 0})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _state())


def test_loop_checkpoints_and_restores(tmp_path):
    d = str(tmp_path / "loop")

    def step_fn(state, batch):
        return ({"w": state["w"] + 1.0},
                {"loss": torch.tensor(1.0 / (float(state["w"]) + 1.0))})

    cfg = LoopConfig(total_steps=10, ckpt_dir=d, ckpt_every=5, log_every=100)
    loop1 = train_loop({"w": torch.tensor(0.0)}, step_fn, lambda s: None, cfg, log=quiet)
    assert loop1.step == 10 and list_checkpoints(d) == [5, 10]
    # re-run: restores at 10 and does nothing more
    loop2 = train_loop({"w": torch.tensor(0.0)}, step_fn, lambda s: None, cfg, log=quiet)
    assert loop2.step == 10 and loop2.losses == []
    # from step 5 it runs steps 5-9 again on the restored value
    os.remove(os.path.join(d, "step_00000010", "DONE"))
    seen = []
    loop3 = train_loop({"w": torch.tensor(0.0)}, lambda s, b: (seen.append(float(s["w"])),
                                                               step_fn(s, b))[1],
                       lambda s: None, cfg, log=quiet)
    assert loop3.step == 10 and seen == [5.0, 6.0, 7.0, 8.0, 9.0]


def test_async_checkpointer(tmp_path):
    d = str(tmp_path / "ack")
    ck = AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3):
        ck.save(s, _state(float(s)))
    ck.wait()
    assert list_checkpoints(d) == [2, 3]
    restored, step = restore_checkpoint(d, _state())
    assert step == 3
    torch.testing.assert_close(restored["params"]["w"], torch.full((3, 2), 3.0))


def test_async_save_snapshots_before_returning(tmp_path):
    """``save`` copies the state on the caller's thread: an in-place update
    right after it (as the port's AdamW makes) does not reach the file."""
    d = str(tmp_path / "snap")
    state = _state(1.0)
    ck = AsyncCheckpointer(d, keep=1)
    ck.save(1, state)
    state["params"]["w"].add_(100.0)
    ck.wait()
    restored, _ = restore_checkpoint(d, _state())
    torch.testing.assert_close(restored["params"]["w"], torch.full((3, 2), 1.0))


def test_loop_async_checkpointing(tmp_path):
    d = str(tmp_path / "loop_async")

    def step_fn(state, batch):
        return {"w": state["w"] + 1.0}, {"loss": torch.tensor(0.5)}

    cfg = LoopConfig(total_steps=6, ckpt_dir=d, ckpt_every=2, async_ckpt=True,
                     log_every=100)
    loop = train_loop({"w": torch.tensor(0.0)}, step_fn, lambda s: None, cfg, log=quiet)
    assert loop.step == 6 and latest_checkpoint(d) == 6
    restored, _ = restore_checkpoint(d, {"w": torch.tensor(0.0)})
    assert float(restored["w"]) == 6.0


# ---------------------------------------------------------------------------
# tests/test_elastic.py, on the port
# ---------------------------------------------------------------------------

def test_elastic_restore_onto_another_device(tmp_path):
    """A checkpoint restores into an abstract template (tensors on the meta
    device, as ``jax.eval_shape`` gives the reference) onto the device the
    caller names, keeping each leaf's dtype and ``requires_grad``."""
    d = str(tmp_path / "ck")
    w = torch.arange(32, dtype=torch.float32).reshape(8, 4).requires_grad_(True)
    save_checkpoint(d, 5, {"w": w, "step": 3})
    tmpl = {"w": torch.empty((8, 4), device="meta").requires_grad_(True), "step": 0}
    restored, step = restore_checkpoint(d, tmpl, device="cpu")
    assert step == 5 and restored["step"] == 3
    assert restored["w"].device.type == "cpu" and restored["w"].requires_grad
    assert torch.equal(restored["w"].detach(), w.detach())


@pytest.mark.parametrize("B,S,grid", [
    (4, 16, (2, 4)), (3, 16, (2, 4)),   # B not divisible by grid -> largest divisor
    (1, 7, (4, 4)),                     # degenerate dims
    (8, 8, (1, 1)),
])
def test_shard_blocks_roundtrip_matches_reference(B, S, grid):
    x = np.arange(B * S * 4, dtype=np.float32).reshape(B, S, 4)
    xb, restore = shard_blocks(torch.tensor(x), ExecutionPlan(dispatch_grid=grid))
    assert xb.shape[0] * xb.shape[1] == B * S
    np.testing.assert_array_equal(restore(xb.reshape(-1, 4)).numpy(), x)
    with execution_plan(JPlan(dispatch_grid=grid)):
        jb, _ = jshard_blocks(jnp.asarray(x))
    np.testing.assert_array_equal(xb.numpy(), np.asarray(jb))


def test_shard_blocks_tile_alignment():
    """Each row of the blocked layout is one (batch-block, seq-block) tile."""
    B, S = 4, 8
    x = (torch.arange(B)[:, None] * 100 + torch.arange(S)[None, :]).float()[..., None]
    xb, _ = shard_blocks(x, ExecutionPlan(dispatch_grid=(2, 2)))
    assert set(xb[0, :, 0].tolist()) == {0, 1, 2, 3, 100, 101, 102, 103}


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_states():
    """A float32 tiny-moe train state after one AdamW step (mu, nu, count
    and step nonzero) in each package, from the same weights and
    gradients: the reference's (jax arrays) and the port's (tensors)."""
    pj = jmodel.init_model(jax.random.PRNGKey(0), CFG_J)
    cfg_j, cfg_t = jopt.OptConfig(warmup_steps=1), topt.OptConfig(warmup_steps=1)
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype), pj)
    new_p, new_o, _ = jopt.adamw_update(pj, grads, jopt.init_opt_state(pj, cfg_j), cfg_j,
                                        step=jnp.int32(1))
    state_j = {"params": new_p, "opt": new_o, "step": jnp.int32(1)}
    state_t = make_train_state(from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu"),
                               cfg_t)
    g_t = from_numpy_tree(jax.tree_util.tree_map(np.asarray, grads), "cpu")
    _, state_t["opt"], _ = topt.adamw_update(state_t["params"], g_t, state_t["opt"], cfg_t,
                                             step=1)
    state_t["step"] = 1
    return state_j, state_t


def test_float32_checkpoints_cross_between_the_packages(tmp_path, trained_states):
    """The reference's checkpoint of a tiny-moe train state restores in the
    port, and the port's in the reference: the same keys in both files,
    every leaf bit-equal, the ints as ints."""
    state_j, state_t = trained_states
    dj, dt = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save_checkpoint(dj, 1, state_j)
    save_checkpoint(dt, 1, state_t)
    with np.load(os.path.join(dj, "step_00000001", "state.npz")) as a, \
            np.load(os.path.join(dt, "step_00000001", "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert f"opt{SEP}count" in a.files
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
    tmpl = make_train_state(from_numpy_tree(to_numpy_tree(state_t["params"]), "cpu"),
                            topt.OptConfig())
    got_t, step = restore_checkpoint(dj, tmpl)
    assert step == 1 and got_t["step"] == 1 and got_t["opt"]["count"] == 1
    assert all(t.requires_grad for t in tree_leaves(got_t["params"]))
    got_j, step = jck.restore_checkpoint(dt, jax.eval_shape(lambda: state_j))
    assert step == 1 and int(got_j["step"]) == 1 and int(got_j["opt"]["count"]) == 1
    leaves = lambda tree: jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, tree))
    parts = lambda st, conv: [conv(st["params"]), conv(st["opt"]["mu"]), conv(st["opt"]["nu"])]
    for want, got in ((parts(state_j, leaves), parts(got_t, lambda t: leaves(to_numpy_tree(t)))),
                      (parts(state_t, lambda t: leaves(to_numpy_tree(t))), parts(got_j, leaves))):
        for w, g in zip(want, got):
            for a, b in zip(w, g, strict=True):
                np.testing.assert_array_equal(b, a)


def test_bf16_checkpoint_restores_in_the_port_where_the_reference_raises(tmp_path):
    """A bf16 leaf is stored as 2-byte ``V2`` records by both packages; the
    reference's restore raises ``ValueError`` on its own file and on the
    port's, the port restores both bit for bit (no ``ml_dtypes``)."""
    bits = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)
    w_t = torch.tensor(bits).to(torch.bfloat16)
    w_j = jnp.asarray(bits).astype(jnp.bfloat16)
    np.testing.assert_array_equal(w_t.view(torch.int16).numpy(),
                                  np.asarray(w_j).view(np.int16))
    dj, dt = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save_checkpoint(dj, 2, {"params": {"w": w_j}, "step": jnp.int32(2)})
    save_checkpoint(dt, 2, {"params": {"w": w_t}, "step": 2})
    for d in (dj, dt):
        with np.load(os.path.join(d, "step_00000002", "state.npz")) as f:
            assert f[f"params{SEP}w"].dtype == np.dtype("V2")
        with pytest.raises(ValueError):
            jck.restore_checkpoint(d, jax.eval_shape(
                lambda: {"params": {"w": w_j}, "step": jnp.int32(0)}))
        tmpl = {"params": {"w": torch.zeros((4, 6), dtype=torch.bfloat16)}, "step": 0}
        got, step = restore_checkpoint(d, tmpl)
        assert step == 2 and got["step"] == 2
        assert got["params"]["w"].dtype == torch.bfloat16
        assert torch.equal(got["params"]["w"].view(torch.int16), w_t.view(torch.int16))


# ---------------------------------------------------------------------------
# SIGTERM and resume
# ---------------------------------------------------------------------------

def test_sigterm_resume_equals_the_uninterrupted_run_and_the_reference(tmp_path):
    """tiny-moe, 4 steps (seq 48, the flash core), checkpoints every 2. Run
    1 is uninterrupted; run 2 sends itself SIGTERM in its first step, so it
    checkpoints at step 1 and stops; run 3 starts from other weights,
    restores step 1 and runs to step 4. Runs 2 + 3 give run 1's losses and
    final parameters bit for bit, and the losses are the reference's
    ``make_step``'s within 1e-5 (``tests/test_torch_train.py``'s band)."""
    S, B, steps = 48, 2, 4
    cfg_j = jopt.OptConfig(learning_rate=1e-3, warmup_steps=1, total_steps=steps)
    cfg_t = topt.OptConfig(learning_rate=1e-3, warmup_steps=1, total_steps=steps)
    kw = dict(moe_impl="grouped", attn_q_block=BLK, attn_kv_block=BLK)
    data = tdata.SyntheticLMData(tdata.DataConfig(CFG_T.vocab_size, S, B, seed=0))
    batch_fn = lambda s: {"tokens": torch.tensor(data.batch_at(s)["tokens"])}
    step_t = ttrain.make_step(CFG_T, cfg_t, RunConfig(remat_policy="none"),
                              plan=ExecutionPlan(use_kernels=True, **kw))
    pj = jmodel.init_model(jax.random.PRNGKey(1), CFG_J)
    fresh = lambda p: make_train_state(from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, p), "cpu"), cfg_t)
    last = {}

    def recording(signal_at=None):
        def step(state, batch):
            if state["step"] == signal_at:
                handler = signal.getsignal(signal.SIGTERM)
                assert getattr(handler, "__qualname__", "").startswith("train_loop")
                os.kill(os.getpid(), signal.SIGTERM)
            state, m = step_t(state, batch)
            last["state"] = state
            return state, m
        return step

    lc = dict(total_steps=steps, ckpt_every=2, keep=2, log_every=100)
    run1 = train_loop(fresh(pj), recording(), batch_fn,
                      LoopConfig(ckpt_dir=str(tmp_path / "r1"), **lc), log=quiet)
    final1 = last.pop("state")
    d = str(tmp_path / "r2")
    run2 = train_loop(fresh(pj), recording(signal_at=0), batch_fn,
                      LoopConfig(ckpt_dir=d, **lc), log=quiet)
    assert run2.interrupted and run2.step == 1 and list_checkpoints(d) == [1]
    other = fresh(jmodel.init_model(jax.random.PRNGKey(7), CFG_J))
    run3 = train_loop(other, recording(), batch_fn, LoopConfig(ckpt_dir=d, **lc), log=quiet)
    assert not run3.interrupted and run3.step == steps and list_checkpoints(d) == [2, 4]
    assert run2.losses + run3.losses == run1.losses
    _flat_equal(final1, last["state"])
    assert all(t.requires_grad for t in tree_leaves(last["state"]["params"]))

    plan_j = JPlan(**kw)
    state_j = {"params": pj, "opt": jopt.init_opt_state(pj, cfg_j), "step": jnp.int32(0)}

    @jax.jit
    def ref_step(state, tokens):
        with execution_plan(plan_j):
            (loss, _), grads = jax.value_and_grad(
                lambda p: jmodel.loss_fn(p, CFG_J, {"tokens": tokens}, remat="none"),
                has_aux=True)(state["params"])
            new_p, new_o, _ = jopt.adamw_update(state["params"], grads, state["opt"], cfg_j,
                                                step=state["step"])
        return {"params": new_p, "opt": new_o, "step": state["step"] + 1}, loss

    jdata_ = jdata.SyntheticLMData(jdata.DataConfig(CFG_J.vocab_size, S, B, seed=0))
    for step in range(steps):
        state_j, loss_j = ref_step(state_j, jnp.asarray(jdata_.batch_at(step)["tokens"]))
        assert abs(run1.losses[step] - float(loss_j)) <= 1e-5


def test_cli_checkpoints_and_resumes(tmp_path, capsys):
    """``--ckpt-dir``: three steps checkpoint at steps 2 and 3; a run of
    four resumes from step 3 and trains one more step."""
    d = str(tmp_path / "cli")
    argv = ["--arch", "tiny-moe", "--device", "cpu", "--seq", "32", "--batch", "2",
            "--ckpt-dir", d, "--ckpt-every", "2"]
    assert ttrain.main(argv + ["--steps", "3"]) == 0
    assert list_checkpoints(d) == [2, 3]
    assert ttrain.main(argv + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert f"[loop] restored step 3 from {d}" in out
    assert "[train] tiny-moe: steps=4 " in out
    assert list_checkpoints(d) == [2, 3, 4]
