"""PyTorch port, whisper-small (an encoder of bidirectional attention and a
decoder of self- and cross-attention over precomputed frame embeddings) at
``reduced_config`` size (its 12 encoder layers kept, 2 decoder layers)
against the JAX package, float32, the reference's weights carried across:

* ``loss_fn`` and its gradients within 2e-5, the encoder past the 16-row
  flash tiles (its non-causal flash core, plain versions here);
* ``prefill`` plus two ``decode_step``s within 2e-5 of the reference's, and
  within 1e-4 of the port's own ``forward`` over the grown sequences, with
  the encoder shorter and longer than the decoder's ``max_len``: the
  reference's prefill replaces its max_len cross cache with the encoder's
  length, the port writes the first Se positions of a cache sized by
  ``init_cache(enc_len=)``;
* packed ``segment_ids`` reaching cross-attention as the keys' segments
  too, as the reference does: equal logits where Se == S, an error in both
  packages where not;
* the refusals: the engine and the serve CLI (as the reference's), an
  encoder block's cache, a paged cross cache, a cross cache too short;
* a float32 checkpoint of the parameters ("encoder", "cross",
  "norm_cross") across the packages both ways, bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config
from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan
from repro.launch.serve import main as ref_serve_main
from repro.launch.train import reduced_config as ref_reduced_config
from repro.models import model as jmodel
from repro.training import checkpoint as jck
from repro_torch.configs import resolve_config
from repro_torch.configs.base import ATTN_BIDIR, DENSE, LayerKind
from repro_torch.core.execution import ExecutionPlan
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import model as tmodel
from repro_torch.models.blocks import block_init_cache
from repro_torch.models.params import from_numpy_tree, to_numpy_tree, tree_leaves, tree_map
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.checkpoint import SEP, restore_checkpoint, save_checkpoint

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

NAME = "whisper-small"
CFG_J = ref_reduced_config(get_config(NAME))
CFG_T = resolve_config(NAME, reduced=True)
TOL = dict(atol=2e-5, rtol=2e-5)
MAX_LEN = 32


@pytest.fixture(scope="module")
def params():
    pj = jmodel.init_model(jax.random.PRNGKey(0), CFG_J)
    return pj, from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")


def _batch(Se, S=12, seed=1):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((2, Se, CFG_T.d_model)).astype(np.float32)
    toks = rng.integers(0, CFG_T.vocab_size, (2, S)).astype(np.int32)
    return ({"frames": jnp.asarray(frames), "dec_tokens": jnp.asarray(toks)},
            {"frames": torch.tensor(frames), "dec_tokens": torch.tensor(toks)})


def test_the_configuration_keeps_its_encoder(params):
    _, pt = params
    assert CFG_T.enc_num_layers == 12 and CFG_T.num_layers == 2
    assert set(pt["encoder"]) == {"segments", "final_norm"}
    blk = pt["segments"][0]["blocks"][0]
    assert {"cross", "norm_cross"} <= set(blk) and "cross" not in pt["encoder"]["segments"][0]


def test_loss_and_grads_match_the_reference(params):
    """20 frames and 12 decoder tokens through ``loss_fn`` with 16-row
    tiles: loss, ce and every gradient leaf within 2e-5 (the leaf's largest
    entry times 2e-5 where that is larger), the encoder's and the cross
    projections' gradients nonzero."""
    pj, pt = params
    bj, bt = _batch(20)
    kw = dict(attn_q_block=16, attn_kv_block=16)

    @jax.jit
    def ref(p, b):
        with execution_plan(JPlan(**kw)):
            return jax.value_and_grad(lambda q: jmodel.loss_fn(q, CFG_J, b), has_aux=True)(p)

    (loss_j, m_j), g_j = ref(pj, bj)
    pt = tree_map(pt, lambda t: t.clone().requires_grad_(True))
    loss_t, m_t = tmodel.loss_fn(pt, CFG_T, bt, plan=ExecutionPlan(use_kernels=True, **kw))
    grads = iter(torch.autograd.grad(loss_t, tree_leaves(pt)))
    g_t = to_numpy_tree(tree_map(pt, lambda _: next(grads)))
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 2e-5
    assert abs(float(m_t["ce"].detach()) - float(m_j["ce"])) <= 2e-5

    def close(w, g):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=2e-5 * max(1.0, float(np.abs(w).max())),
                                   rtol=0)
    jax.tree_util.tree_map(close, g_j, g_t)
    enc_wq = g_t["encoder"]["segments"][0]["blocks"][0]["mixer"]["wq"]["kernel"]
    cross_wk = g_t["segments"][0]["blocks"][0]["cross"]["wk"]["kernel"]
    assert np.abs(enc_wq).max() > 0 and np.abs(cross_wk).max() > 0


@pytest.mark.parametrize("Se", [20, 48], ids=["Se<max_len", "Se>max_len"])
def test_prefill_and_decode_match_the_reference(params, Se):
    """Prefill of 12 decoder tokens (true lengths 12 and 7) into a cache of
    max_len 32, then two greedy decode steps: logits within 2e-5 of the
    reference's at every step, the cross cache's first Se positions equal
    to the reference's cross K/V with "cross_len" Se, and each decode
    step's logits within 1e-4 of the port's ``forward`` over the grown
    sequence."""
    pj, pt = params
    bj, bt = _batch(Se)
    true_len = np.asarray([12, 7], np.int32)
    cache_j = jmodel.init_cache(CFG_J, 2, MAX_LEN)
    lg_j, cache_j = jax.jit(lambda p, b, c, n: jmodel.prefill(p, CFG_J, b, c, n))(
        pj, bj, cache_j, jnp.asarray(true_len))
    cache_t = tmodel.init_cache(CFG_T, 2, MAX_LEN, device="cpu", enc_len=max(Se, MAX_LEN))
    lg_t, cache_t = tmodel.prefill(pt, CFG_T, bt, cache_t, torch.tensor(true_len))
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
    blk_j, blk_t = cache_j[0]["blocks"][0], cache_t[0]["blocks"][0]
    assert blk_j["cross_k"].shape[2] == Se                  # the reference's leaf, replaced
    np.testing.assert_array_equal(blk_t["cross_len"].numpy(), np.full((2, 2), Se))
    np.testing.assert_allclose(blk_t["cross_k"][:, :, :Se].numpy(),
                               np.asarray(blk_j["cross_k"]), **TOL)
    seqs = [list(np.asarray(bt["dec_tokens"])[b, :n]) for b, n in enumerate(true_len)]
    nxt = np.asarray(lg_t.argmax(-1), np.int32)
    step_j = jax.jit(lambda p, t, c: jmodel.decode_step(p, CFG_J, t, c))
    for _ in range(2):
        for b in range(2):
            seqs[b].append(int(nxt[b, 0]))
        dl_j, cache_j = step_j(pj, jnp.asarray(nxt), cache_j)
        dl_t, cache_t, _ = tmodel.decode_step(pt, CFG_T, torch.tensor(nxt), cache_t, {})
        np.testing.assert_allclose(dl_t.numpy(), np.asarray(dl_j), **TOL)
        for b in range(2):
            full, _ = tmodel.forward(pt, CFG_T, {"frames": bt["frames"][b:b + 1],
                                                 "dec_tokens": torch.tensor([seqs[b]])})
            np.testing.assert_allclose(dl_t[b, 0].numpy(), full[0, -1].numpy(), atol=1e-4)
        nxt = np.asarray(dl_t.argmax(-1), np.int32)


def test_segment_ids_reach_cross_attention_as_the_reference(params):
    """``forward`` with packed ``segment_ids`` (B, S): with as many frames
    as decoder tokens both packages mask cross-attention by the decoder's
    ids on both sides, logits within 2e-5; with another number of frames
    both raise (the reference never passes the encoder's own ids)."""
    pj, pt = params
    seg = np.repeat(np.asarray([[0] * 5 + [1] * 7]), 2, 0).astype(np.int32)
    bj, bt = _batch(12)
    fj, _ = jax.jit(lambda p, b, s: jmodel.forward(p, CFG_J, b, segment_ids=s))(
        pj, bj, jnp.asarray(seg))
    ft, _ = tmodel.forward(pt, CFG_T, bt, segment_ids=torch.tensor(seg))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)
    plain_t, _ = tmodel.forward(pt, CFG_T, bt)
    assert not np.allclose(ft.numpy(), plain_t.numpy(), atol=1e-3)
    bj, bt = _batch(20)
    with pytest.raises((TypeError, ValueError)):
        jmodel.forward(pj, CFG_J, bj, segment_ids=jnp.asarray(seg))
    with pytest.raises(RuntimeError):
        tmodel.forward(pt, CFG_T, bt, segment_ids=torch.tensor(seg))


def test_the_refusals(params):
    _, pt = params
    with pytest.raises(ValueError, match="decoder-only"):
        ServingEngine(CFG_T, pt, device="cpu", max_slots=2, max_len=MAX_LEN)
    for main in (serve_main, ref_serve_main):
        argv = ["--arch", NAME, "--reduced"] + (["--device", "cpu"] if main is serve_main
                                                else [])
        with pytest.raises(SystemExit, match="enc-dec"):
            main(argv)
    with pytest.raises(ValueError, match="no decode cache"):
        block_init_cache(CFG_T, LayerKind(ATTN_BIDIR, DENSE), 2, MAX_LEN,
                         dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="full self-attention"):
        tmodel.init_cache(CFG_T, page_size=8, num_pages=4, device="cpu")
    cache = tmodel.init_cache(CFG_T, 2, MAX_LEN, device="cpu")     # cross leaves of max_len
    _, bt = _batch(MAX_LEN + 1)
    with pytest.raises(ValueError, match="enc_len"):
        tmodel.prefill(pt, CFG_T, bt, cache, torch.tensor([12, 12]))


def test_float32_checkpoint_crosses_between_the_packages(tmp_path, params):
    """The parameter tree, with the "encoder", "cross" and "norm_cross"
    leaves, saved by either package restores in the other bit for bit,
    under the same keys."""
    pj, pt = params
    dj, dt = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save_checkpoint(dj, 1, {"params": pj})
    save_checkpoint(dt, 1, {"params": pt})
    with np.load(os.path.join(dj, "step_00000001", "state.npz")) as a, \
            np.load(os.path.join(dt, "step_00000001", "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in (f"params{SEP}encoder{SEP}final_norm{SEP}scale",
                    f"params{SEP}segments{SEP}0{SEP}blocks{SEP}0{SEP}cross{SEP}wq{SEP}kernel",
                    f"params{SEP}segments{SEP}0{SEP}blocks{SEP}0{SEP}norm_cross{SEP}scale"):
            assert key in a.files
    got_t, step = restore_checkpoint(dj, {"params": tree_map(pt, torch.zeros_like)})
    got_j, _ = jck.restore_checkpoint(dt, jax.eval_shape(lambda: {"params": pj}))
    assert step == 1
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, pj))
    for w, a, b in zip(want, jax.tree_util.tree_leaves(to_numpy_tree(got_t["params"])),
                       jax.tree_util.tree_leaves(got_j["params"]), strict=True):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(np.asarray(b), w)
