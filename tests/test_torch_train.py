"""PyTorch port, training: ``loss_fn`` and its gradients, AdamW, the data
pipeline, three ``make_step`` steps and the CLI, each against the JAX
package on tiny-moe (2 layers, 4 heads over 2 KV heads, 8 experts top-2,
float32) with the same weights and batches. At seq 48 with 16-row tiles
the attention runs the flash core (its hand-written backward); at seq 16
the unblocked path, differentiated by autograd. Also the loss and
gradients of a tiny hybrid (Mamba-2 + attention + MoE) stack."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jb
from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan
from repro.launch.train import resolve_config as jresolve
from repro.models import model as jmodel
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro_torch.configs import RunConfig, resolve_config
from repro_torch.configs import base as tb
from repro_torch.core.execution import ExecutionPlan
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models.params import from_numpy_tree, to_numpy_tree, tree_leaves, tree_map
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training.loop import LoopConfig, train_loop
from repro_torch.training.train_state import make_train_state

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

BLK = 16
CFG_J, CFG_T = jresolve("tiny-moe", False), resolve_config("tiny-moe")


def _plans():
    kw = dict(moe_impl="grouped", attn_q_block=BLK, attn_kv_block=BLK)
    return JPlan(**kw), ExecutionPlan(use_kernels=True, **kw)


def _params(seed=0):
    pj = jmodel.init_model(jax.random.PRNGKey(seed), CFG_J)
    return pj, from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")


def _tokens(S, B=2, seed=3):
    return np.random.default_rng(seed).integers(0, CFG_J.vocab_size, (B, S)).astype(np.int32)


def _assert_tree_close(want, got, *, atol=0.0, rel=None):
    """Leaf by leaf (matched by path): within ``atol``, or with ``rel``
    within rel x the leaf's largest |entry|."""
    def one(w, g):
        w, g = np.asarray(w, np.float32), np.asarray(g, np.float32)
        tol = atol if rel is None else rel * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)
    jax.tree_util.tree_map(one, want, got)


@pytest.fixture(scope="module", params=[48, 16], ids=["S48", "S16"])
def loss_and_grads(request):
    """Reference and port (loss, ce, aux, grads) at seq 48 and 16, each
    computed once for the tests below."""
    S = request.param
    pj, pt = _params()
    toks = _tokens(S)
    plan_j, plan_t = _plans()

    @jax.jit
    def ref(p, t):
        with execution_plan(plan_j):
            return jax.value_and_grad(
                lambda q: jmodel.loss_fn(q, CFG_J, {"tokens": t}, remat="none"),
                has_aux=True)(p)

    (loss_j, m_j), g_j = ref(pj, jnp.asarray(toks))
    pt = make_train_state(pt, topt.OptConfig())["params"]
    loss_t, m_t = tmodel.loss_fn(pt, CFG_T, {"tokens": torch.tensor(toks)}, plan=plan_t)
    grads = iter(torch.autograd.grad(loss_t, tree_leaves(pt)))
    g_t = tree_map(pt, lambda _: next(grads))
    return (loss_j, m_j, g_j), (loss_t.detach(), m_t, g_t)


def test_loss_matches_reference(loss_and_grads):
    """loss, ce and aux within 1e-5 (float32 sums in another order)."""
    (loss_j, m_j, _), (loss_t, m_t, _) = loss_and_grads
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5
    assert abs(float(m_t["ce"].detach()) - float(m_j["ce"])) <= 1e-5
    assert abs(float(m_t["aux"].detach()) - float(m_j["aux"])) <= 1e-5


def test_grads_match_reference(loss_and_grads):
    """Every gradient leaf within 1e-4 of the leaf's largest entry."""
    (_, _, g_j), (_, _, g_t) = loss_and_grads
    _assert_tree_close(g_j, to_numpy_tree(g_t), rel=1e-4)


def test_forward_matches_reference():
    """``forward``'s float32 logits within 1e-4 and aux within 1e-5 at seq
    48 (the flash core)."""
    pj, pt = _params()
    toks = _tokens(48)
    plan_j, plan_t = _plans()

    @jax.jit
    def ref(p, t):
        with execution_plan(plan_j):
            return jmodel.forward(p, CFG_J, {"tokens": t})

    logits_j, aux_j = ref(pj, jnp.asarray(toks))
    with torch.no_grad():
        logits_t, aux_t = tmodel.forward(pt, CFG_T, {"tokens": torch.tensor(toks)},
                                         plan=plan_t)
    assert logits_t.dtype == torch.float32
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=1e-4, rtol=0)
    assert abs(float(aux_t) - float(aux_j)) <= 1e-5


def _seeded_tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": ({"c": rng.standard_normal((2, 3, 5)).astype(np.float32)},
                  {"c": rng.standard_normal((7,)).astype(np.float32)})}


@pytest.mark.parametrize("grad_scale", [0.1, 10.0])   # under and over the clip norm
def test_adamw_clip_and_schedule_match_reference(grad_scale):
    """Four AdamW steps on a seeded tree (clip norm 1; step 0 has lr 0) and
    the clipping alone: params, mu, nu, the grad norm and the clipped
    gradients within 1e-6; the schedule's lr for steps 0-12 within 1e-9."""
    rng = np.random.default_rng(5)
    cfg_j = jopt.OptConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    cfg_t = topt.OptConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    for step in range(13):
        assert abs(topt.lr_schedule(cfg_t, step)
                   - float(jopt.lr_schedule(cfg_j, jnp.int32(step)))) <= 1e-9
    p_j = jax.tree_util.tree_map(jnp.asarray, _seeded_tree(rng))
    p_t = from_numpy_tree(_seeded_tree(np.random.default_rng(5)), "cpu")
    s_j, s_t = jopt.init_opt_state(p_j, cfg_j), topt.init_opt_state(p_t, cfg_t)
    for step in range(4):
        g = jax.tree_util.tree_map(lambda a: a * grad_scale, _seeded_tree(rng))
        clipped_j, norm_j = jopt.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), 1.0)
        clipped_t, norm_t = topt.clip_by_global_norm(from_numpy_tree(g, "cpu"), 1.0)
        assert abs(float(norm_t) - float(norm_j)) <= 1e-6 * float(norm_j)
        _assert_tree_close(clipped_j, to_numpy_tree(clipped_t), atol=1e-6)
        p_j, s_j, m_j = jopt.adamw_update(p_j, jax.tree_util.tree_map(jnp.asarray, g), s_j,
                                          cfg_j, step=jnp.int32(step))
        p_t, s_t, m_t = topt.adamw_update(p_t, from_numpy_tree(g, "cpu"), s_t, cfg_t,
                                          step=step)
        assert s_t["count"] == int(s_j["count"]) == step + 1
        assert abs(m_t["lr"] - float(m_j["lr"])) <= 1e-9
    _assert_tree_close(p_j, to_numpy_tree(p_t), atol=1e-6)
    _assert_tree_close(s_j["mu"], to_numpy_tree(s_t["mu"]), atol=1e-6)
    _assert_tree_close(s_j["nu"], to_numpy_tree(s_t["nu"]), atol=1e-6)


def test_synthetic_data_equals_reference():
    cfg = dict(vocab_size=CFG_J.vocab_size, seq_len=32, global_batch=3, seed=7)
    dj = jdata.SyntheticLMData(jdata.DataConfig(**cfg))
    dt = tdata.SyntheticLMData(tdata.DataConfig(**cfg))
    for step in (0, 1, 5):
        np.testing.assert_array_equal(dt.batch_at(step)["tokens"], dj.batch_at(step)["tokens"])


@pytest.mark.parametrize("remat", ["none", "full"])
def test_three_steps_match_reference(remat):
    """Three ``make_step`` steps from the same weights and batches (seq 48,
    the flash core): losses within 1e-5, params, mu and nu within 1e-5.
    Step 0 has lr 0, so the parameters move from step 1 on. ``remat`` is the
    port's; it must not change a number."""
    S, B = 48, 2
    cfg_j = jopt.OptConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    cfg_t = topt.OptConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    plan_j, plan_t = _plans()
    data = jdata.SyntheticLMData(jdata.DataConfig(CFG_J.vocab_size, S, B, seed=0))
    pj, pt = _params(seed=1)
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

    state_t = make_train_state(pt, cfg_t)
    step_t = ttrain.make_step(CFG_T, cfg_t, RunConfig(remat_policy=remat), plan=plan_t)
    first = np.asarray(pj["final_norm"]["scale"]).copy()
    for step in range(3):
        toks = data.batch_at(step)["tokens"]
        state_j, loss_j = ref_step(state_j, jnp.asarray(toks))
        state_t, m_t = step_t(state_t, {"tokens": torch.tensor(toks)})
        assert abs(float(m_t["loss"]) - float(loss_j)) <= 1e-5
        moved = not np.array_equal(state_t["params"]["final_norm"]["scale"].detach().numpy(),
                                   first)
        assert moved == (step > 0)
    assert state_t["step"] == 3
    _assert_tree_close(state_j["params"], to_numpy_tree(state_t["params"]), atol=1e-5)
    _assert_tree_close(state_j["opt"]["mu"], to_numpy_tree(state_t["opt"]["mu"]), atol=1e-5)
    _assert_tree_close(state_j["opt"]["nu"], to_numpy_tree(state_t["opt"]["nu"]), atol=1e-5)


def test_cli_trains_tiny_moe_on_the_cpu(capsys):
    assert ttrain.main(["--arch", "tiny-moe", "--steps", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("[train]")]
    assert line and line[0].startswith("[train] tiny-moe: steps=3 loss ")
    assert "stragglers=" in line[0]


def test_unported_options_raise():
    """remat="dots" and checkpoints are not ported: they raise rather than
    run something else."""
    pt = make_train_state(_params()[1], topt.OptConfig())["params"]
    batch = {"tokens": torch.tensor(_tokens(16))}
    with pytest.raises(NotImplementedError):
        tmodel.loss_fn(pt, CFG_T, batch, remat="dots")
    with pytest.raises(NotImplementedError):
        train_loop(None, None, None, LoopConfig(total_steps=1, ckpt_dir="ckpt"))


def _hybrid(m):
    """Jamba's 8-layer period (attention at layer 4, MoE on odd layers) at
    d_model 64: 4 heads over 2 KV heads, 4 experts top-2, SSM headdim 16,
    chunk 8; float32."""
    pattern = tuple(m.LayerKind(m.ATTN if i == 4 else m.MAMBA, m.MOE if i % 2 else m.DENSE)
                    for i in range(8))
    return m.ModelConfig(
        name="tiny-hybrid", family="hybrid", num_layers=8, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256, segments=(m.Segment(pattern, 1),),
        moe=m.MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        ssm=m.SSMConfig(d_state=16, d_conv=4, expand=2, headdim=16, chunk_size=8),
        dtype="float32", param_dtype="float32").validate()


def test_hybrid_loss_and_grads_match_reference():
    """A tiny hybrid stack (Jamba's 8-layer period at d_model 64: Mamba-2
    and attention mixers, dense and MoE FFNs): the Mamba mixers train
    through ``mamba_forward`` under autograd. Loss and aux within 1e-5,
    every gradient leaf within 1e-4 of its largest entry."""
    cfg_j, cfg_t = _hybrid(jb), _hybrid(tb)
    pj = jmodel.init_model(jax.random.PRNGKey(0), cfg_j)
    pt = make_train_state(from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu"),
                          topt.OptConfig())["params"]
    toks = _tokens(16)

    @jax.jit
    def ref(p, t):
        with execution_plan(JPlan(moe_impl="grouped")):
            return jax.value_and_grad(
                lambda q: jmodel.loss_fn(q, cfg_j, {"tokens": t}, remat="none"),
                has_aux=True)(p)

    (loss_j, m_j), g_j = ref(pj, jnp.asarray(toks))
    loss_t, m_t = tmodel.loss_fn(pt, cfg_t, {"tokens": torch.tensor(toks)},
                                 plan=ExecutionPlan(moe_impl="grouped"))
    grads = iter(torch.autograd.grad(loss_t, tree_leaves(pt)))
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-5
    assert abs(float(m_t["aux"].detach()) - float(m_j["aux"])) <= 1e-5
    _assert_tree_close(g_j, to_numpy_tree(tree_map(pt, lambda _: next(grads))), rel=1e-4)
