"""PyTorch port, MoE level: routing, duplex dispatch and the duplex / grouped
MoE layers against the JAX package on the same weights and inputs
(tiny-moe, float32). Integer outputs — counts, the rank permutation, the
slot -> token map — must be equal exactly; float outputs within 1e-5 abs
(float32 sums in another order)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig, small_test_config
from repro.core import duplex_moe as jdm
from repro.core.partition import DuplexPlanner as JPlanner
from repro.core.partition import build_luts as j_build_luts
from repro.core.costmodel import DUPLEX as J_DUPLEX
from repro.models import moe as jmoe
from repro.models.model import init_model
from repro_torch.configs import resolve_config
from repro_torch.core import duplex_moe as tdm
from repro_torch.core.costmodel import DUPLEX
from repro_torch.core.partition import DuplexPlanner, build_luts
from repro_torch.models import moe as tmoe
from repro_torch.models.params import from_numpy_tree

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

CFG_J = small_test_config("tiny-moe", family="moe",
                          moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128))
CFG_T = resolve_config("tiny-moe")
E = CFG_J.moe.num_experts
ATOL = 1e-5


@pytest.fixture(scope="module")
def ffn_params():
    p = init_model(jax.random.PRNGKey(0), CFG_J)
    ffn = jax.tree_util.tree_map(lambda a: np.asarray(a)[1],
                                 p["segments"][0]["blocks"][0]["ffn"])
    return ffn, from_numpy_tree(ffn, "cpu")


def _tokens(seed, T=40):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, CFG_J.d_model)).astype(np.float32)
    valid = rng.random(T) > 0.2
    return x, valid


def test_route_matches(ffn_params):
    jp, tp = ffn_params
    x, valid = _tokens(0)
    r_j = jmoe.route(jp, CFG_J.moe, jax.numpy.asarray(x), valid=jax.numpy.asarray(valid))
    r_t = tmoe.route(tp, CFG_T.moe, torch.tensor(x), valid=torch.tensor(valid))
    np.testing.assert_array_equal(r_t.expert_idx.numpy(), np.asarray(r_j.expert_idx))
    np.testing.assert_array_equal(r_t.counts.numpy(), np.asarray(r_j.counts))
    np.testing.assert_allclose(r_t.gates.numpy(), np.asarray(r_j.gates), atol=ATOL)


@pytest.mark.parametrize("k_cold", [0, E // 2, E])
def test_duplex_dispatch_matches(ffn_params, k_cold):
    jp, tp = ffn_params
    x, valid = _tokens(1 + k_cold)
    T = x.shape[0]
    r_j = jmoe.route(jp, CFG_J.moe, jax.numpy.asarray(x), valid=jax.numpy.asarray(valid))
    r_t = tmoe.route(tp, CFG_T.moe, torch.tensor(x), valid=torch.tensor(valid))
    # tight capacities so some tokens overflow and drop
    kw = dict(k_cold=k_cold, c_hot=8, c_cold=4)
    d_j = jdm.duplex_dispatch(r_j, CFG_J.moe, T, token_valid=jax.numpy.asarray(valid), **kw)
    d_t = tdm.duplex_dispatch(r_t, CFG_T.moe, T, token_valid=torch.tensor(valid), **kw)
    np.testing.assert_array_equal(d_t.perm.numpy(), np.asarray(d_j.perm))
    np.testing.assert_array_equal(d_t.counts.numpy(), np.asarray(d_j.counts))
    np.testing.assert_array_equal(d_t.src_token.numpy(), np.asarray(d_j.src_token)[0])
    np.testing.assert_allclose(d_t.slot_gate.numpy(), np.asarray(d_j.slot_gate)[0],
                               atol=ATOL)
    assert (d_t.k_cold, d_t.c_hot, d_t.c_cold) == (d_j.k_cold, d_j.c_hot, d_j.c_cold)


@pytest.mark.parametrize("k_cold,use_kernels", [
    (0, True), (E // 2, True), (E, True), (E // 2, False)])
def test_duplex_moe_apply_matches(ffn_params, k_cold, use_kernels):
    """Kernels on: the port's plain kernel versions vs the Pallas ragged
    kernels (interpret mode); off: both XLA-recipe grouped FFNs."""
    jp, tp = ffn_params
    x, valid = _tokens(7 + k_cold)
    kw = dict(k_cold=k_cold, c_hot=16, c_cold=8)
    y_j, r_j = jax.jit(lambda p, x, v: jdm.duplex_moe_apply(
        p, CFG_J, x, use_kernels=use_kernels, ragged=use_kernels, return_stats=True,
        token_valid=v, **kw))(jp, jax.numpy.asarray(x), jax.numpy.asarray(valid))
    y_t, r_t = tdm.duplex_moe_apply(tp, CFG_T, torch.tensor(x), use_kernels=use_kernels,
                                    ragged=use_kernels, token_valid=torch.tensor(valid),
                                    **kw)
    np.testing.assert_array_equal(r_t.counts.numpy(), np.asarray(r_j.counts))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)


def test_grouped_moe_apply_matches(ffn_params):
    """The grouped (capacity-padded, kernel-free) path k_cold == 0 takes
    without the ragged kernels."""
    jp, tp = ffn_params
    x, valid = _tokens(11)
    y_j, r_j = jmoe.moe_apply(jp, CFG_J, jax.numpy.asarray(x), capacity=8,
                              return_stats=True, token_valid=jax.numpy.asarray(valid))
    y_t, r_t = tmoe.moe_apply(tp, CFG_T, torch.tensor(x), capacity=8,
                              token_valid=torch.tensor(valid))
    np.testing.assert_array_equal(r_t.counts.numpy(), np.asarray(r_j.counts))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)


@pytest.mark.parametrize("T", [1, 7, 64, 300])
def test_default_capacities_match(T):
    for m in (CFG_J.moe, MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024)):
        for k_cold in (0, 1, m.num_experts // 2, m.num_experts):
            assert tdm.default_capacities(T, m, k_cold) == \
                jdm.default_capacities(T, m, k_cold)


def test_group_positions_is_the_cumsum_order():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, E + 1, 200)          # E = the masked-out id
    got = tmoe.group_positions(torch.tensor(ids), E).numpy()
    want = np.asarray(jmoe.group_positions(jax.numpy.asarray(ids, np.int32), E))
    live = ids < E
    np.testing.assert_array_equal(got[live], want[live])


def test_planner_picks_the_reference_k_cold():
    """OLMoE's LUTs, ragged hot path: the same counts give the same k_cold."""
    d, f, E64 = 2048, 1024, 64
    jl = j_build_luts(J_DUPLEX, d, f, max_tokens=768, hot_block=64)
    tl = build_luts(DUPLEX, d, f, max_tokens=768, hot_block=64)
    jp, tp = JPlanner(*jl, E64), DuplexPlanner(*tl, E64)
    rng = np.random.default_rng(0)
    for T in (4, 16, 80, 272):
        for _ in range(5):
            counts = rng.multinomial(T * 8, rng.dirichlet(np.ones(E64)))
            assert tp.k_cold_static(counts) == jp.k_cold_static(counts)
