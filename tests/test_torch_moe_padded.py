"""PyTorch port, capacity-padded duplex MoE: the padded kernels' plain
versions against the Pallas ``moe_gemm`` / ``moe_gemv(counts=None)``
(interpret mode) at float32 2e-5, the padded duplex layer against the
reference's, and the engine's greedy tokens with ``moe_ragged=False`` and
with ``use_duplex=False`` (kernels on)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig, small_test_config
from repro.core import duplex_moe as jdm
from repro.kernels import ops as jops
from repro.models.model import init_model
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.request import Request as RefRequest
from repro_torch.configs import resolve_config
from repro_torch.core import duplex_moe as tdm
from repro_torch.kernels import build, moe_gemm, moe_gemv
from repro_torch.kernels import ops as tops
from repro_torch.models.params import from_numpy_tree
from repro_torch.models.params import init_model as init_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

TOL = dict(atol=2e-5, rtol=2e-5)
CFG_J = small_test_config("tiny-moe", family="moe",
                          moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128))
CFG_T = resolve_config("tiny-moe")
E = CFG_J.moe.num_experts
KW = dict(max_slots=3, max_len=64, kv_page_size=8, prefill_chunk_tokens=16)


def _experts(rng, E_, d=16, f=64):
    return {"wi_gate": rng.standard_normal((E_, d, f)).astype(np.float32) * 0.1,
            "wi_up": rng.standard_normal((E_, d, f)).astype(np.float32) * 0.1,
            "wo": rng.standard_normal((E_, f, d)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("n,C", [(4, 16), (6, 8)])
@pytest.mark.parametrize("hot", [True, False])
def test_padded_moe_plain_matches_pallas(hot, n, C):
    """Every slot is computed (no slot is zeroed, none skipped): random x in
    every slot of the capacity, weights read through perm."""
    rng = np.random.default_rng(n * 10 + C + hot)
    w = _experts(rng, 7)
    perm = rng.permutation(7)[:n].astype(np.int32)
    x = rng.standard_normal((n, C, 16)).astype(np.float32)
    tw = {k: torch.tensor(v) for k, v in w.items()}
    if hot:
        got = tops.moe_gemm(tw, torch.tensor(x), torch.tensor(perm)).numpy()
    else:
        got = tops.moe_gemv(tw, torch.tensor(x), None, torch.tensor(perm)).numpy()
    w_perm = {k: jnp.asarray(v[perm]) for k, v in w.items()}
    if hot:
        want = jops.moe_gemm(w_perm, jnp.asarray(x), c_block=8, f_block=32,
                             interpret=True)
    else:
        want = jops.moe_gemv(w_perm, jnp.asarray(x), None, f_block=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert np.abs(got).min(axis=-1).max() > 0        # no row zeroed


def test_padded_equals_ragged_where_dead_slots_are_zero():
    """With zeros in the slots past each count (what dispatch leaves there)
    the padded kernels' functions equal the ragged ones exactly: the
    difference is the work, not the result."""
    rng = np.random.default_rng(3)
    w = {k: torch.tensor(v) for k, v in _experts(rng, 5).items()}
    counts = torch.tensor([0, 3, 8, 1], dtype=torch.int32)
    x = torch.tensor(rng.standard_normal((4, 8, 16)).astype(np.float32))
    x = x * (torch.arange(8)[None, :, None] < counts[:, None, None])
    perm = torch.tensor([4, 0, 2, 1], dtype=torch.int32)
    args = (x, w["wi_gate"], w["wi_up"], w["wo"], perm)
    torch.testing.assert_close(moe_gemm.moe_gemm_plain(*args),
                               moe_gemm.ragged_moe_gemm_plain(*args, counts), rtol=0, atol=0)
    torch.testing.assert_close(moe_gemv.moe_gemv_plain(*args),
                               moe_gemv.ragged_moe_gemv_plain(*args, counts), rtol=0, atol=0)


@pytest.fixture(scope="module")
def ffn_params():
    p = init_model(jax.random.PRNGKey(0), CFG_J)
    ffn = jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                 p["segments"][0]["blocks"][0]["ffn"])
    return ffn, from_numpy_tree(ffn, "cpu")


@pytest.mark.parametrize("k_cold", [E // 2, E, 1])
def test_padded_duplex_moe_apply_matches(ffn_params, k_cold):
    """ragged=False with kernels: cold experts through the padded GEMV, hot
    through the padded GEMM (plain versions here, Pallas in interpret mode
    in the reference); tight capacities so some tokens overflow."""
    jp, tp = ffn_params
    rng = np.random.default_rng(20 + k_cold)
    x = rng.standard_normal((40, CFG_J.d_model)).astype(np.float32)
    valid = rng.random(40) > 0.2
    kw = dict(k_cold=k_cold, c_hot=16, c_cold=8)
    y_j, r_j = jax.jit(lambda p, x, v: jdm.duplex_moe_apply(
        p, CFG_J, x, use_kernels=True, ragged=False, return_stats=True,
        token_valid=v, **kw))(jp, jnp.asarray(x), jnp.asarray(valid))
    y_t, r_t = tdm.duplex_moe_apply(tp, CFG_T, torch.tensor(x), use_kernels=True,
                                    ragged=False, token_valid=torch.tensor(valid), **kw)
    np.testing.assert_array_equal(r_t.counts.numpy(), np.asarray(r_j.counts))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


def test_padded_wrappers_do_not_fall_back_off_cpu():
    x = torch.zeros((1, 2, 64), device="meta")
    w = torch.zeros((1, 64, 64), device="meta")
    perm = torch.zeros((1,), dtype=torch.int32, device="meta")
    before = dict(build.launch_counts)
    for fn in (moe_gemm.moe_gemm_kernel, moe_gemv.moe_gemv_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, w, w, w, perm)
    assert build.launch_counts == before


def test_padded_plan_takes_the_grouped_path_at_k_cold_0():
    """moe_ragged=False: a stage whose k_cold is 0 runs the grouped plain
    MoE (no MoE kernel), as the reference engine plans it; k_cold > 0 runs
    the padded duplex kernels."""
    eng = ServingEngine(CFG_T, init_params(CFG_T, device="cpu"), device="cpu",
                        use_kernels=True, moe_ragged=False, **KW)
    assert not eng.moe_ragged
    assert eng._moe_plan(0, 16, 8).moe_impl == "grouped"
    plan = eng._moe_plan(3, 16, 8)
    assert (plan.moe_impl, plan.moe_ragged, plan.use_kernels) == ("duplex", False, True)


@pytest.mark.parametrize("flags", [dict(moe_ragged=False), dict(use_duplex=False)])
def test_engine_emits_the_reference_greedy_tokens(flags):
    """Kernels on, float pools: the capacity-padded duplex MoE, and no
    duplex at all (attention kernels, plain grouped MoE). Greedy tokens,
    per-stage k_cold, stage mix and streamed KV and MoE bytes equal the
    reference engine's."""
    params_j = init_model(jax.random.PRNGKey(0), CFG_J)
    params_t = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, CFG_J.vocab_size, n).tolist() for n in (19, 5, 27, 9)]
    ref = RefEngine(CFG_J, params_j, kv_layout="paged", use_kernels=True, **flags, **KW)
    ref_reqs = [RefRequest(rid=i, prompt=list(p), max_new_tokens=3)
                for i, p in enumerate(prompts)]
    ref.run(ref_reqs)
    eng = ServingEngine(CFG_T, params_t, device="cpu", use_kernels=True, **flags, **KW)
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=3) for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert [r.k_cold for r in eng.reports] == [r.k_cold for r in ref.reports]
    if flags.get("use_duplex", True):
        assert any(0 < r.k_cold < E for r in eng.reports)
    else:
        assert all(r.k_cold == 0 for r in eng.reports)
    assert [(r.is_mixed, r.num_decode, r.num_prefill, r.stage_tokens)
            for r in eng.reports] == [(r.is_mixed, r.num_decode, r.num_prefill,
                                       r.stage_tokens) for r in ref.reports]
    assert [r.kv_bytes_streamed for r in eng.reports] == \
        [r.kv_bytes_streamed for r in ref.reports]
    assert [r.moe_bytes_streamed for r in eng.reports] == \
        [r.moe_bytes_streamed for r in ref.reports]
