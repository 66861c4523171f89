"""PyTorch port, model level: ``mixed_step`` and paged ``decode_step`` against
the JAX package on the same weights, tokens and paged cache (tiny-moe, page
8, chunk 16, float32 with TF32 off). Three stages: two mixed (prefill
chunks + decode rows, with padded rows) then one decode-only. Logits must
agree within 1e-4 abs (float32 sums in another order through two MoE
layers) and the per-expert MoE counts exactly; the written KV pools within
1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig, small_test_config
from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan
from repro.models import model as jmodel
from repro.models.ffn import ffn_apply as j_ffn_apply
from repro_torch.configs import resolve_config
from repro_torch.core.execution import ExecutionPlan
from repro_torch.models import model as tmodel
from repro_torch.models.ffn import ffn_apply
from repro_torch.models.params import from_numpy_tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers
PAGE, P, MAXP = 8, 16, 4
ATOL = 1e-4


def _configs(qk_norm):
    j = small_test_config("tiny-moe", family="moe",
                          moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128))
    t = resolve_config("tiny-moe")
    return (dataclasses.replace(j, qk_norm=qk_norm),
            dataclasses.replace(t, qk_norm=qk_norm))


def _stages(rng, V):
    """(kind, decode rows, chunk rows) per stage, as numpy inputs."""
    bt = lambda rows: np.asarray(rows, np.int32)
    tok = lambda *s: rng.integers(0, V, s).astype(np.int32)
    return [
        ("mixed",
         dict(tokens=tok(1, 1), lengths=np.asarray([0], np.int32),
              bt=bt([[0, 0, 0, 0]])),                       # padded decode row
         dict(tokens=tok(2, 16), starts=np.asarray([0, 0], np.int32),
              clens=np.asarray([16, 11], np.int32),
              bt=bt([[1, 2, 0, 0], [3, 4, 0, 0]]))),
        ("mixed",
         dict(tokens=tok(2, 1), lengths=np.asarray([16, 11], np.int32),
              bt=bt([[1, 2, 5, 0], [3, 4, 0, 0]])),
         dict(tokens=tok(2, 16), starts=np.asarray([0, 0], np.int32),
              clens=np.asarray([9, 0], np.int32),           # a padded chunk row
              bt=bt([[6, 7, 0, 0], [0, 0, 0, 0]]))),
        ("decode",
         dict(tokens=tok(4, 1), lengths=np.asarray([17, 12, 9, 0], np.int32),
              bt=bt([[1, 2, 5, 0], [3, 4, 0, 0], [6, 7, 0, 0], [0, 0, 0, 0]])),
         None),
    ]


@pytest.mark.parametrize("use_kernels,qk_norm", [
    (True, True),      # kernels (plain versions here vs Pallas), OLMoE's qk-norm
    (False, False),    # the kernel-free torch path vs the XLA path
])
def test_mixed_and_decode_steps_match(use_kernels, qk_norm):
    cfg_j, cfg_t = _configs(qk_norm)
    pj = jmodel.init_model(jax.random.PRNGKey(3), cfg_j)
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    cache_j = jmodel.init_cache(cfg_j, 1, MAXP * PAGE, paged=True, page_size=PAGE,
                                num_pages=P)
    cache_t = tmodel.init_cache(cfg_t, page_size=PAGE, num_pages=P, device="cpu")
    plan_kw = dict(moe_impl="duplex", k_cold=4, c_hot=16, c_cold=8,
                   moe_ragged=use_kernels, use_kernels=use_kernels)
    plan_t = ExecutionPlan(**plan_kw)
    plan_j = JPlan(**plan_kw)
    J, T = jnp.asarray, torch.tensor
    for kind, dec, chunk in _stages(np.random.default_rng(0), cfg_j.vocab_size):
        actx_j = {"lengths": J(dec["lengths"]), "block_tables": J(dec["bt"]),
                  "valid": J(dec["lengths"] > 0)}
        actx_t = {"lengths": T(dec["lengths"]), "block_tables": T(dec["bt"]),
                  "valid": T(dec["lengths"] > 0)}
        if kind == "mixed":
            cctx_j = {"starts": J(chunk["starts"]), "chunk_lens": J(chunk["clens"]),
                      "block_tables": J(chunk["bt"])}
            cctx_t = {k: T(np.asarray(v)) for k, v in cctx_j.items()}
            with execution_plan(plan_j):      # read while jit traces
                dl_j, cl_j, cache_j, cnt_j = jax.jit(
                    lambda p, d, c, cache, a, cc: jmodel.mixed_step(
                        p, cfg_j, d, c, cache, attn_ctx=a, chunk_ctx=cc))(
                    pj, J(dec["tokens"]), J(chunk["tokens"]), cache_j, actx_j, cctx_j)
            dl_t, cl_t, cache_t, cnt_t = tmodel.mixed_step(
                pt, cfg_t, T(dec["tokens"]), T(chunk["tokens"]), cache_t,
                attn_ctx=actx_t, chunk_ctx=cctx_t, plan=plan_t)
            live = chunk["clens"] > 0          # padded rows' logits are unused
            np.testing.assert_allclose(cl_t.numpy()[live], np.asarray(cl_j)[live],
                                       atol=ATOL)
        else:
            with execution_plan(plan_j):
                dl_j, cache_j, cnt_j = jax.jit(
                    lambda p, d, cache, a: jmodel.decode_step(
                        p, cfg_j, d, cache, attn_ctx=a, return_moe_counts=True))(
                    pj, J(dec["tokens"]), cache_j, actx_j)
            dl_t, cache_t, cnt_t = tmodel.decode_step(
                pt, cfg_t, T(dec["tokens"]), cache_t, actx_t, plan=plan_t)
        live = dec["lengths"] > 0
        np.testing.assert_allclose(dl_t.numpy()[live], np.asarray(dl_j)[live], atol=ATOL)
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    for name in ("k_pages", "v_pages"):            # live pages 1..7 written alike
        np.testing.assert_allclose(
            cache_t[0]["blocks"][0][name].numpy()[:, 1:8],
            np.asarray(cache_j[0]["blocks"][0][name])[:, 1:8], atol=1e-5)


def test_dense_ffn_apply_matches():
    """The dense SwiGLU FFN (blocks with a dense FFN, e.g. tiny-dense)."""
    rng = np.random.default_rng(4)
    w = {"wi_gate": rng.standard_normal((64, 128)).astype(np.float32) * 0.1,
         "wi_up": rng.standard_normal((64, 128)).astype(np.float32) * 0.1,
         "wo": rng.standard_normal((128, 64)).astype(np.float32) * 0.1}
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    got = ffn_apply({k: torch.tensor(v) for k, v in w.items()}, torch.tensor(x))
    want = j_ffn_apply({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
