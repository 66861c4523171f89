"""PyTorch port, internvl2-1b (precomputed patch embeddings prepended to the
text, a GQA decoder with qkv bias) at ``reduced_config`` size against the
JAX package, float32, the reference's weights carried across:

* ``forward`` over patches and text, ``loss_fn`` (labels padded in front
  with one -100 a patch) and its gradients, within 2e-5;
* ``prefill`` plus two ``decode_step``s within 2e-5 of the reference's
  for two ``true_len``s: the stream's (patches plus text), whose decode
  logits also equal the port's own ``forward`` over the grown stream
  within 1e-4, and the text's alone, the reference's own smoke test's
  call, which reads the logits at a text position inside the prompt and
  caches only that many positions: carried over as the reference does it
  (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config
from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan
from repro.launch.train import reduced_config as ref_reduced_config
from repro.models import model as jmodel
from repro_torch.configs import resolve_config
from repro_torch.core.execution import ExecutionPlan
from repro_torch.models import model as tmodel
from repro_torch.models.params import from_numpy_tree, to_numpy_tree, tree_leaves, tree_map

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

NAME = "internvl2-1b"
CFG_J = ref_reduced_config(get_config(NAME))
CFG_T = resolve_config(NAME, reduced=True)
TOL = dict(atol=2e-5, rtol=2e-5)
N_PATCH, TEXT = 6, 12


@pytest.fixture(scope="module")
def params():
    pj = jmodel.init_model(jax.random.PRNGKey(0), CFG_J)
    return pj, from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((2, N_PATCH, CFG_T.d_model)).astype(np.float32)
    toks = rng.integers(0, CFG_T.vocab_size, (2, TEXT)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)},
            {"tokens": torch.tensor(toks), "patch_embeds": torch.tensor(patches)})


def test_forward_loss_and_grads_match_the_reference(params):
    """Logits over the 18 positions of patches and text, the loss over the
    text's next tokens, and every gradient leaf within 2e-5 (the leaf's
    largest entry times 2e-5 where that is larger), with 16-row tiles (the
    flash core past them; plain versions here)."""
    pj, pt = params
    bj, bt = _batch()
    kw = dict(attn_q_block=16, attn_kv_block=16)

    @jax.jit
    def ref(p, b):
        with execution_plan(JPlan(**kw)):
            fwd = jmodel.forward(p, CFG_J, b)[0]
            return fwd, jax.value_and_grad(lambda q: jmodel.loss_fn(q, CFG_J, b),
                                           has_aux=True)(p)

    f_j, ((loss_j, _), g_j) = ref(pj, bj)
    plan = ExecutionPlan(use_kernels=True, **kw)
    with torch.no_grad():
        f_t, _ = tmodel.forward(pt, CFG_T, bt, plan=plan)
    assert f_t.shape == (2, N_PATCH + TEXT, CFG_T.vocab_size)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **TOL)
    pt = tree_map(pt, lambda t: t.clone().requires_grad_(True))
    loss_t, _ = tmodel.loss_fn(pt, CFG_T, bt, plan=plan)
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 2e-5
    # the loss is the text's alone: the same text without patches moves it
    text_only, _ = tmodel.loss_fn(pt, CFG_T, {"tokens": bt["tokens"]}, plan=plan)
    assert abs(float(text_only.detach()) - float(loss_t.detach())) > 1e-4
    grads = iter(torch.autograd.grad(loss_t, tree_leaves(pt)))
    g_t = to_numpy_tree(tree_map(pt, lambda _: next(grads)))

    def close(w, g):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=2e-5 * max(1.0, float(np.abs(w).max())),
                                   rtol=0)
    jax.tree_util.tree_map(close, g_j, g_t)


@pytest.mark.parametrize("text_len_only", [False, True],
                         ids=["true_len=patches+text", "true_len=text (reference smoke)"])
def test_prefill_and_decode_match_the_reference(params, text_len_only):
    """Prefill of 6 patches and 12 text tokens (text lengths 12 and 7) into
    a 32-position cache, then two greedy decode steps, logits within 2e-5
    of the reference's at every step."""
    pj, pt = params
    bj, bt = _batch()
    text = np.asarray([TEXT, 7], np.int32)
    true_len = text if text_len_only else text + N_PATCH
    cache_j = jmodel.init_cache(CFG_J, 2, 32)
    lg_j, cache_j = jax.jit(lambda p, b, c, n: jmodel.prefill(p, CFG_J, b, c, n))(
        pj, bj, cache_j, jnp.asarray(true_len))
    cache_t = tmodel.init_cache(CFG_T, 2, 32, device="cpu")
    lg_t, cache_t = tmodel.prefill(pt, CFG_T, bt, cache_t, torch.tensor(true_len))
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
    np.testing.assert_array_equal(cache_t[0]["blocks"][0]["len"][0].numpy(), true_len)
    toks = np.asarray(bt["tokens"])
    seqs = [list(toks[b, :n]) for b, n in enumerate(text)]
    nxt = np.asarray(lg_t.argmax(-1), np.int32)
    step_j = jax.jit(lambda p, t, c: jmodel.decode_step(p, CFG_J, t, c))
    for _ in range(2):
        for b in range(2):
            seqs[b].append(int(nxt[b, 0]))
        dl_j, cache_j = step_j(pj, jnp.asarray(nxt), cache_j)
        dl_t, cache_t, _ = tmodel.decode_step(pt, CFG_T, torch.tensor(nxt), cache_t, {})
        np.testing.assert_allclose(dl_t.numpy(), np.asarray(dl_j), **TOL)
        if not text_len_only:     # the stream's true length: decode continues it
            for b in range(2):
                full, _ = tmodel.forward(pt, CFG_T, {
                    "tokens": torch.tensor([seqs[b]]),
                    "patch_embeds": bt["patch_embeds"][b:b + 1]})
                np.testing.assert_allclose(dl_t[b, 0].numpy(), full[0, -1].numpy(),
                                           atol=1e-4)
        nxt = np.asarray(dl_t.argmax(-1), np.int32)
