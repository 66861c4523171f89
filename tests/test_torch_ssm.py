"""PyTorch port, Mamba-2 mixer: the SSD decode kernel's plain version, the
chunked SSD scan, ``mamba_forward`` with its decode cache and both branches
of ``mamba_decode_step``, each against the JAX package on the same numpy
inputs and weights (float32, TF32 off). Also the reference's padded-state
behaviour, shown in both packages: a prompt prefilled with padding gives
the same prefill logits as unpadded, but its decode cache holds the state
after the padding, so the next decode step differs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig, small_test_config
from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch.configs import base as tbase
from repro_torch.core.execution import ExecutionPlan
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ssd_decode import ssd_decode_kernel, ssd_decode_plain
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models.params import from_numpy_tree

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

T = torch.tensor


def _configs():
    j = small_test_config("tiny-ssm", family="ssm",
                          ssm=SSMConfig(d_state=16, headdim=16, chunk_size=8))
    t = tbase.small_test_config("tiny-ssm", family="ssm",
                                ssm=tbase.SSMConfig(d_state=16, headdim=16, chunk_size=8))
    return j, t


def _mixer_params(seed=0):
    cfg_j, cfg_t = _configs()
    pj = jmodel.init_model(jax.random.PRNGKey(seed), cfg_j)
    mixer_j = jax.tree_util.tree_map(lambda a: a[0],
                                     pj["segments"][0]["blocks"][0]["mixer"])
    mixer_t = from_numpy_tree(jax.tree_util.tree_map(np.asarray, mixer_j), "cpu")
    return cfg_j, cfg_t, mixer_j, mixer_t


@pytest.mark.parametrize("B,H,N,P", [(1, 8, 16, 16), (2, 16, 16, 32), (3, 12, 8, 64)])
def test_ssd_decode_plain_matches_pallas_and_ref(B, H, N, P):
    """y within 1e-4 and the state within 1e-5 (the reference's own sweep
    tolerances; float32 sums over N in another order)."""
    rng = np.random.default_rng(B * 7 + H)
    state = rng.standard_normal((B, H, N, P)).astype(np.float32)
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    a_log = rng.uniform(size=(H,)).astype(np.float32)
    b = rng.standard_normal((B, N)).astype(np.float32)
    c = rng.standard_normal((B, N)).astype(np.float32)
    d = rng.standard_normal((H,)).astype(np.float32)
    args = (state, x, dt, a_log, b, c, d)
    y_k, s_k = jops.ssd_decode(*map(jnp.asarray, args))          # Pallas, interpret
    y_r, s_r = ref.ssd_decode_ref(*map(jnp.asarray, args))
    y_p, s_p = ssd_decode_plain(*map(T, args))
    y_w, s_w = ssd_decode_kernel(*map(T, args))                   # CPU: the plain version
    y_o, s_o = tops.ssd_decode(*map(T, args))
    for y, s in ((y_p, s_p), (y_w, s_w), (y_o, s_o)):
        for y_j, s_j in ((y_k, s_k), (y_r, s_r)):
            np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,with_state", [(21, False), (16, True), (5, True)])
def test_ssd_chunked_matches(S, with_state):
    """Chunk 8 over 21 (padded), 16 (exact) and 5 positions, with and
    without an entering state: y and the final state within 1e-5 (float32;
    the intra-chunk (Q x Q) sums run in another order)."""
    rng = np.random.default_rng(S)
    Bt, H, P, N = 2, 4, 8, 16
    x = rng.standard_normal((Bt, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, H)) - 1.0)).astype(np.float32)
    A = -np.exp(rng.uniform(size=(H,))).astype(np.float32)
    Bm = rng.standard_normal((Bt, S, N)).astype(np.float32)
    Cm = rng.standard_normal((Bt, S, N)).astype(np.float32)
    s0 = rng.standard_normal((Bt, H, N, P)).astype(np.float32) if with_state else None
    y_j, st_j = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 8,
                                 initial_state=None if s0 is None else jnp.asarray(s0))
    y_t, st_t = tssm.ssd_chunked(*map(T, (x, dt, A, Bm, Cm)), 8,
                                 initial_state=None if s0 is None else T(s0))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [12, 2])
def test_mamba_forward_with_state_matches(S):
    """mamba_forward's output and its decode cache (conv tail, left-padded
    when S < d_conv - 1, and the final state) within 1e-5 (float32)."""
    cfg_j, cfg_t, mj, mt = _mixer_params()
    x = np.random.default_rng(S).standard_normal((2, S, cfg_j.d_model)).astype(np.float32)
    out_j, c_j = jssm.mamba_forward(mj, cfg_j, jnp.asarray(x), return_state=True)
    out_t, c_t = tssm.mamba_forward(mt, cfg_t, T(x), return_state=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(c_t[k].numpy(), np.asarray(c_j[k]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tssm.mamba_forward(mt, cfg_t, T(x)).numpy(),
                               out_t.numpy(), atol=0, rtol=0)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_mamba_decode_step_matches(use_kernels):
    """Both branches (the SSD kernel's plain version vs the Pallas kernel in
    interpret mode; the plain recurrence vs XLA): the output within 1e-5 and
    the updated cache (written in place) within 1e-5 (float32)."""
    cfg_j, cfg_t, mj, mt = _mixer_params(1)
    rng = np.random.default_rng(2)
    c0 = tssm.mamba_init_cache(cfg_t, 3, torch.float32, "cpu")
    conv = rng.standard_normal(c0["conv"].shape[1:]).astype(np.float32)
    ssm = rng.standard_normal(c0["ssm"].shape[1:]).astype(np.float32)
    x = rng.standard_normal((3, 1, cfg_j.d_model)).astype(np.float32)
    with execution_plan(JPlan(use_kernels=use_kernels)):
        out_j, new_j = jssm.mamba_decode_step(mj, cfg_j, jnp.asarray(x),
                                              {"conv": jnp.asarray(conv),
                                               "ssm": jnp.asarray(ssm)})
    cache_t = {"conv": T(conv), "ssm": T(ssm)}
    out_t, new_t = tssm.mamba_decode_step(mt, cfg_t, T(x), cache_t,
                                          use_kernels=use_kernels)
    assert new_t is cache_t
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(cache_t[k].numpy(), np.asarray(new_j[k]), atol=1e-5,
                                   rtol=1e-5)


def test_padded_prefill_state_moves_the_next_decode_in_both_packages():
    """The reference takes a Mamba layer's decode state after the padded end
    of the prompt (``mamba_forward`` has no ``true_len``), and the port keeps
    that. A 12-token prompt prefilled at its own length and padded to 16 (the
    engine pads to a bucket): the prefill logits agree within 1e-5 (causal:
    the last valid position never sees the padding), the next decode step's
    logits move by more than 0.1 in each package, and the port matches the
    JAX package within 1e-4 on each variant."""
    cfg_j, cfg_t = _configs()
    pj = jmodel.init_model(jax.random.PRNGKey(0), cfg_j)
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    prompt = np.random.default_rng(0).integers(0, cfg_j.vocab_size, 12).astype(np.int32)
    logits = {}
    for pad in (12, 16):
        toks = np.zeros((1, pad), np.int32)
        toks[0, :12] = prompt
        true_len = np.asarray([12], np.int32)
        cache_j = jmodel.init_cache(cfg_j, 1, 32)
        lg_j, cache_j = jmodel.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)}, cache_j,
                                       jnp.asarray(true_len))
        cache_t = tmodel.init_cache(cfg_t, 1, 32, device="cpu")
        lg_t, _ = tmodel.prefill(pt, cfg_t, {"tokens": T(toks)}, cache_t, T(true_len))
        nxt = np.asarray(jnp.argmax(lg_j[:, -1], -1))[:, None].astype(np.int32)
        dl_j, _ = jmodel.decode_step(pj, cfg_j, jnp.asarray(nxt), cache_j)
        dl_t, _, _ = tmodel.decode_step(pt, cfg_t, T(nxt), cache_t, {},
                                        plan=ExecutionPlan())
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=1e-4)
        np.testing.assert_allclose(dl_t.numpy(), np.asarray(dl_j), atol=1e-4)
        logits[pad] = (np.asarray(lg_j), np.asarray(dl_j), lg_t.numpy(), dl_t.numpy())
    for pre, dec in ((0, 1), (2, 3)):          # the JAX package, then the port
        np.testing.assert_allclose(logits[16][pre], logits[12][pre], atol=1e-5)
        assert np.abs(logits[16][dec] - logits[12][dec]).max() > 0.1
