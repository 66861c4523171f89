"""PyTorch port, deepseek-moe-16b (2 shared experts beside 64 routed ones,
top-6, a dense first layer) at ``reduced_config`` size against the JAX
package, float32, the reference's weights carried across:

* ``loss_fn`` and its gradients (the grouped MoE of training, the shared
  experts' FFN included) within 2e-5;
* the MoE layer with its shared experts on every route: ``duplex_moe_apply``
  plain against the reference's XLA route and through the kernels' plain
  versions against its Pallas kernels in interpret mode (ragged, at k_cold
  0, a half and all), ``moe_apply`` against the reference's grouped path,
  and the shared FFN's output added over every row;
* the engine (paged, chunked, duplex ragged, kernels on: their plain
  versions here) against the reference engine's greedy tokens, k_cold and
  streamed bytes;
* a float32 checkpoint of the parameters (the new "shared" leaves) across
  the packages both ways, bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config
from repro.core import duplex_moe as jdm
from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan
from repro.launch.train import reduced_config as ref_reduced_config
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.request import Request as RefRequest
from repro.training import checkpoint as jck
from repro_torch.configs import resolve_config
from repro_torch.core import duplex_moe as tdm
from repro_torch.core.execution import ExecutionPlan
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.ffn import ffn_apply
from repro_torch.models.params import from_numpy_tree, to_numpy_tree, tree_leaves, tree_map
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request
from repro_torch.training.checkpoint import SEP, restore_checkpoint, save_checkpoint

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

NAME = "deepseek-moe-16b"
CFG_J = ref_reduced_config(get_config(NAME))
CFG_T = resolve_config(NAME, reduced=True)
E = CFG_T.moe.num_experts
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def params():
    pj = jmodel.init_model(jax.random.PRNGKey(0), CFG_J)
    return pj, from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")


@pytest.fixture(scope="module")
def moe_params(params):
    """The MoE layer of the second segment (layer 1 of the stack)."""
    pj, pt = params
    ffn_j = jax.tree_util.tree_map(lambda a: a[0], pj["segments"][1]["blocks"][0]["ffn"])
    return ffn_j, tree_map(pt["segments"][1]["blocks"][0]["ffn"], lambda t: t[0])


def test_the_stack_is_a_dense_layer_then_moe_layers_with_shared_experts(params):
    _, pt = params
    dense, moe = (seg["blocks"][0]["ffn"] for seg in pt["segments"])
    assert set(dense) == {"wi_gate", "wi_up", "wo"}
    assert set(moe) == {"router", "wi_gate", "wi_up", "wo", "shared"}
    assert moe["shared"]["wi_gate"].shape == (1, CFG_T.d_model, CFG_T.moe.d_ff_shared)
    assert CFG_T.moe.d_ff_shared == 2816          # reduced_config keeps it, as the reference


def test_loss_and_grads_match_the_reference(params):
    """Two sequences of 24 tokens through ``loss_fn`` with the grouped MoE
    (training's): the loss, its ce and aux, and every gradient leaf within
    2e-5 (the leaf's largest entry times 2e-5 where that is larger)."""
    pj, pt = params
    toks = np.random.default_rng(3).integers(0, CFG_T.vocab_size, (2, 24)).astype(np.int32)
    kw = dict(moe_impl="grouped", attn_q_block=16, attn_kv_block=16)

    @jax.jit
    def ref(p, t):
        with execution_plan(JPlan(**kw)):
            return jax.value_and_grad(
                lambda q: jmodel.loss_fn(q, CFG_J, {"tokens": t}), has_aux=True)(p)

    (loss_j, m_j), g_j = ref(pj, jnp.asarray(toks))
    pt = tree_map(pt, lambda t: t.clone().requires_grad_(True))
    loss_t, m_t = tmodel.loss_fn(pt, CFG_T, {"tokens": torch.tensor(toks)},
                                 plan=ExecutionPlan(use_kernels=True, **kw))
    grads = iter(torch.autograd.grad(loss_t, tree_leaves(pt)))
    g_t = to_numpy_tree(tree_map(pt, lambda _: next(grads)))
    for a, b in ((loss_t, loss_j), (m_t["ce"], m_j["ce"]), (m_t["aux"], m_j["aux"])):
        assert abs(float(a.detach()) - float(b)) <= 2e-5
    assert float(m_t["aux"].detach()) > 0

    def close(w, g):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=2e-5 * max(1.0, float(np.abs(w).max())),
                                   rtol=0)
    jax.tree_util.tree_map(close, g_j, g_t)
    assert float(np.abs(g_t["segments"][1]["blocks"][0]["ffn"]["shared"]["wo"]).max()) > 0


def _tokens(seed, T=40):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, CFG_T.d_model)).astype(np.float32)
    return x, rng.random(T) > 0.2


@pytest.mark.parametrize("k_cold,use_kernels", [
    (0, True), (E // 2, True), (E, True), (E // 2, False)])
def test_duplex_moe_apply_with_shared_experts_matches(moe_params, k_cold, use_kernels):
    """Kernels on: the port's plain kernel versions against the Pallas
    ragged kernels (interpret mode); off: both plain grouped FFNs. The
    shared FFN is part of both outputs."""
    jp, tp = moe_params
    x, valid = _tokens(7 + k_cold)
    kw = dict(k_cold=k_cold, c_hot=16, c_cold=8)
    y_j, r_j = jax.jit(lambda p, x, v: jdm.duplex_moe_apply(
        p, CFG_J, x, use_kernels=use_kernels, ragged=use_kernels, return_stats=True,
        token_valid=v, **kw))(jp, jnp.asarray(x), jnp.asarray(valid))
    y_t, r_t = tdm.duplex_moe_apply(tp, CFG_T, torch.tensor(x), use_kernels=use_kernels,
                                    ragged=use_kernels, token_valid=torch.tensor(valid), **kw)
    np.testing.assert_array_equal(r_t.counts.numpy(), np.asarray(r_j.counts))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


def test_grouped_moe_apply_with_shared_experts_matches(moe_params):
    jp, tp = moe_params
    x, valid = _tokens(11)
    y_j, r_j = jmoe.moe_apply(jp, CFG_J, jnp.asarray(x), capacity=8, return_stats=True,
                              token_valid=jnp.asarray(valid))
    y_t, r_t = tmoe.moe_apply(tp, CFG_T, torch.tensor(x), capacity=8,
                              token_valid=torch.tensor(valid))
    np.testing.assert_array_equal(r_t.counts.numpy(), np.asarray(r_j.counts))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


@pytest.mark.parametrize("route", ["duplex kernels", "duplex plain", "grouped"])
def test_the_shared_ffn_adds_over_every_row(moe_params, route):
    """Each route's output less its output with the shared experts zeroed is
    the shared FFN over every row, dead rows and dropped tokens included."""
    _, tp = moe_params
    x, valid = _tokens(13)
    x, valid = torch.tensor(x), torch.tensor(valid)
    zeroed = dict(tp, shared=tree_map(tp["shared"], torch.zeros_like))

    def run(p):
        if route == "grouped":
            return tmoe.moe_apply(p, CFG_T, x, capacity=4, token_valid=valid)[0]
        kern = route == "duplex kernels"
        return tdm.duplex_moe_apply(p, CFG_T, x, k_cold=E // 2, c_hot=4, c_cold=2,
                                    use_kernels=kern, ragged=kern, token_valid=valid)[0]

    np.testing.assert_allclose((run(tp) - run(zeroed)).numpy(),
                               ffn_apply(tp["shared"], x).numpy(), atol=1e-5, rtol=0)


def test_engine_emits_the_reference_greedy_tokens(params):
    """Paged KV, chunked prefill, the duplex ragged MoE, kernels on (the
    port's plain versions; the reference's Pallas kernels in interpret
    mode, compiled anew per stage, so the run is kept to six stages): four
    requests over three slots emit the reference engine's greedy tokens,
    with its k_cold (hot-only and split stages) and its
    streamed KV and MoE bytes a stage."""
    pj, pt = params
    kw = dict(max_slots=3, max_len=64, kv_page_size=8, prefill_chunk_tokens=16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG_T.vocab_size, n).tolist() for n in (19, 5, 27, 9)]
    ref = RefEngine(CFG_J, pj, kv_layout="paged", use_kernels=True, **kw)
    ref_reqs = [RefRequest(rid=i, prompt=list(p), max_new_tokens=2)
                for i, p in enumerate(prompts)]
    ref.run(ref_reqs)
    eng = ServingEngine(CFG_T, pt, device="cpu", use_kernels=True, **kw)
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=2) for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert all(r.done for r in reqs) and len(eng.reports) <= 6
    assert [r.k_cold for r in eng.reports] == [r.k_cold for r in ref.reports]
    assert 0 in [r.k_cold for r in eng.reports]               # a stage with every expert hot
    assert any(0 < r.k_cold < E for r in eng.reports)        # and stages split both ways
    for key in ("kv_bytes_streamed", "moe_bytes_streamed", "moe_flops_live"):
        assert [getattr(r, key) for r in eng.reports] == [getattr(r, key) for r in ref.reports]
    assert eng.kv.live_pages == 0


def test_float32_checkpoint_crosses_between_the_packages(tmp_path, params):
    """The parameter tree, "shared" leaves included, saved by either package
    restores in the other bit for bit, under the same keys."""
    pj, pt = params
    dj, dt = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save_checkpoint(dj, 1, {"params": pj})
    save_checkpoint(dt, 1, {"params": pt})
    with np.load(os.path.join(dj, "step_00000001", "state.npz")) as a, \
            np.load(os.path.join(dt, "step_00000001", "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert f"params{SEP}segments{SEP}1{SEP}blocks{SEP}0{SEP}ffn{SEP}shared{SEP}wo" in a.files
    tmpl = {"params": tree_map(pt, torch.zeros_like)}
    got_t, step = restore_checkpoint(dj, tmpl)
    got_j, _ = jck.restore_checkpoint(dt, jax.eval_shape(lambda: {"params": pj}))
    assert step == 1
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, pj))
    for w, a, b in zip(want, jax.tree_util.tree_leaves(to_numpy_tree(got_t["params"])),
                       jax.tree_util.tree_leaves(got_j["params"]), strict=True):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(np.asarray(b), w)
