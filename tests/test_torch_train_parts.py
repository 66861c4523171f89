"""PyTorch port, the trainer's parts, each against the JAX package on the
same numpy inputs: ``remat="dots"`` (loss and gradients on tiny-moe and a
tiny hybrid stack), the flash core's bf16 score chain and a bf16 mirror of
the flash backward kernel's rounding, packed sequences (``segment_ids``)
through ``full_attention``, ``blockwise_attention`` and ``forward``, int8
error-feedback compression (bit-exact), and ``cross_pod_mean_int8``,
``pipeline_apply`` and ``mesh_info`` on a one-rank gloo group."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as jb
from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan
from repro.launch import mesh as jmesh
from repro.launch.train import resolve_config as jresolve
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.training import compression as jcomp
from repro.training import pipeline as jpipe
from repro_torch.configs import base as tb
from repro_torch.configs import resolve_config
from repro_torch.core.execution import ExecutionPlan
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attn import flash_attention_bwd_plain, flash_attention_plain
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.params import from_numpy_tree, to_numpy_tree, tree_leaves, tree_map
from repro_torch.training import compression as tcomp
from repro_torch.training import pipeline as tpipe
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_state import make_train_state
from torch_flash_mirror import flash_bwd_rounded

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

BLK, HD = 16, 16
CFG_J, CFG_T = jresolve("tiny-moe", False), resolve_config("tiny-moe")
BF16 = dict(atol=2e-2, rtol=2e-2)
F32 = dict(atol=2e-5, rtol=2e-5)


def _assert_tree_close(want, got, *, rel):
    """Leaf by leaf (matched by path), within rel x the leaf's largest |entry|."""
    def one(w, g):
        w, g = np.asarray(w, np.float32), np.asarray(g, np.float32)
        np.testing.assert_allclose(g, w, atol=rel * max(float(np.abs(w).max()), 1e-30), rtol=0)
    jax.tree_util.tree_map(one, want, got)


def _hybrid(m):
    """Jamba's 8-layer period (attention at layer 4, MoE on odd layers) at
    d_model 64 (``tests/test_torch_train.py``'s)."""
    pattern = tuple(m.LayerKind(m.ATTN if i == 4 else m.MAMBA, m.MOE if i % 2 else m.DENSE)
                    for i in range(8))
    return m.ModelConfig(
        name="tiny-hybrid", family="hybrid", num_layers=8, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256, segments=(m.Segment(pattern, 1),),
        moe=m.MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        ssm=m.SSMConfig(d_state=16, d_conv=4, expand=2, headdim=16, chunk_size=8),
        dtype="float32", param_dtype="float32").validate()


def _qkv(S, KV, qpk, seed, B=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, KV * qpk, HD)).astype(np.float32),
            rng.standard_normal((B, S, KV, HD)).astype(np.float32),
            rng.standard_normal((B, S, KV, HD)).astype(np.float32))


# ---------------------------------------------------------------------------
# remat="dots"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,S", [("tiny-moe", 48), ("hybrid", 16)])
def test_remat_dots_matches_reference(arch, S, monkeypatch):
    """``remat="dots"`` against the reference's (``checkpoint_dots_with_no_
    batch_dims``): loss and aux within 1e-5, every gradient within 1e-4 of
    its leaf's largest entry (``tests/test_torch_train.py``'s bands). In
    the port it changes no number: loss and gradients equal "none"'s bit for
    bit, and the flash core's forward runs again in each layer's backward
    under "dots" and "full" (tiny-moe at seq 48 runs it)."""
    cfg_j, cfg_t = (CFG_J, CFG_T) if arch == "tiny-moe" else (_hybrid(jb), _hybrid(tb))
    pj = jmodel.init_model(jax.random.PRNGKey(0), cfg_j)
    pt = make_train_state(from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu"),
                          OptConfig())["params"]
    toks = np.random.default_rng(3).integers(0, cfg_j.vocab_size, (2, S)).astype(np.int32)
    kw = dict(moe_impl="grouped", attn_q_block=BLK, attn_kv_block=BLK)

    @jax.jit
    def ref(p, t):
        with execution_plan(JPlan(**kw)):
            return jax.value_and_grad(
                lambda q: jmodel.loss_fn(q, cfg_j, {"tokens": t}, remat="dots"),
                has_aux=True)(p)

    (loss_j, m_j), g_j = ref(pj, jnp.asarray(toks))
    forwards = []
    real = tops.flash_attention
    monkeypatch.setattr(tops, "flash_attention",
                        lambda *a, **k: forwards.append(1) or real(*a, **k))
    out = {}
    for remat in ("none", "dots", "full"):
        forwards.clear()
        loss, m = tmodel.loss_fn(pt, cfg_t, {"tokens": torch.tensor(toks)},
                                 plan=ExecutionPlan(use_kernels=True, **kw), remat=remat)
        out[remat] = (loss.detach(), m["aux"].detach(),
                      torch.autograd.grad(loss, tree_leaves(pt)), len(forwards))
    loss_t, aux_t, g_t, n = out["dots"]
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5
    assert abs(float(aux_t) - float(m_j["aux"])) <= 1e-5
    grads = iter(g_t)
    _assert_tree_close(g_j, to_numpy_tree(tree_map(pt, lambda _: next(grads))), rel=1e-4)
    assert torch.equal(out["none"][0], loss_t)
    assert all(torch.equal(a, b) for a, b in zip(out["none"][2], g_t))
    layers = cfg_t.num_layers if arch == "tiny-moe" else 0
    assert [out[r][3] for r in ("none", "dots", "full")] == [layers, 2 * layers, 2 * layers]


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched while it is on, by name."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_keeps_the_products_that_full_recomputes():
    """What tells "dots" from "full": the aten ops of tiny-moe's backward
    (seq 48, the flash core over 16-row blocks). "full" recomputes every
    product of the layers' forward, so its backward runs more 2-D products
    (mm, addmm) than "none"'s; "dots" keeps their outputs (``DOTS_SAVED``)
    and runs exactly "none"'s, while it recomputes the batched products
    (the experts' and the attention's bmm) as "full" does."""
    toks = torch.tensor(np.random.default_rng(3).integers(0, CFG_T.vocab_size, (2, 48)))
    pt = make_train_state(from_numpy_tree(jax.tree_util.tree_map(
        np.asarray, jmodel.init_model(jax.random.PRNGKey(0), CFG_J)), "cpu"),
        OptConfig())["params"]
    plan = ExecutionPlan(moe_impl="grouped", attn_q_block=BLK, attn_kv_block=BLK)
    mm, bmm = {}, {}
    for remat in ("none", "dots", "full"):
        loss, _ = tmodel.loss_fn(pt, CFG_T, {"tokens": toks}, plan=plan, remat=remat)
        with _OpCount() as count:
            torch.autograd.grad(loss, tree_leaves(pt))
        mm[remat], bmm[remat] = count.n["mm"] + count.n["addmm"], count.n["bmm"]
    assert mm["dots"] == mm["none"] < mm["full"]
    assert bmm["none"] < bmm["dots"] == bmm["full"]


# ---------------------------------------------------------------------------
# the flash core's bf16 score chain, and the bf16 backward kernel's rounding
# ---------------------------------------------------------------------------

SCORE_CASES = [(40, 2, 1, True, 0, 0.0), (64, 2, 2, True, 12, 0.0),
               (48, 1, 4, False, 20, 5.0)]


def _bf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


@pytest.mark.parametrize("S,KV,qpk,causal,window,softcap", SCORE_CASES)
def test_score_bf16_flash_core_matches_reference(S, KV, qpk, causal, window, softcap,
                                                 monkeypatch):
    """bf16 inputs, ``score_bf16``: the port's flash core forward and
    (dq, dk, dv) against ``jax.vjp`` of the reference's ``_flash_core``
    with its bf16 score chain, within 2e-2. With ``use_kernels`` the chain
    goes through ``kernels/ops.py`` to the flash kernel's wrapper (its
    plain version on CPU tensors; kernel 9's chain on the card, in
    ``tests/test_torch_cuda.py``) and gives the same bits as without; the
    flag moves the output."""
    q, k, v = _qkv(S, KV, qpk, seed=11)
    dout = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    args = (causal, window, softcap, BLK, BLK, True)
    out_j, vjp = jax.vjp(lambda a, b, c: jattn._flash_core(a, b, c, *args), *map(_bf, (q, k, v)))
    grads_j = vjp(_bf(dout))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    kw = dict(causal=causal, window=window, softcap=softcap, q_block=BLK, kv_block=BLK)
    called = []
    real = tops.flash_attention

    def spy(*a, **kw_):
        called.append(kw_.get("score_bf16"))
        return real(*a, **kw_)

    monkeypatch.setattr(tops, "flash_attention", spy)
    got = {}
    for use_kernels in (False, True):
        tq, tk, tv = (torch.tensor(a).to(torch.bfloat16).requires_grad_(True)
                      for a in (q, k, v))
        out_t = tattn.blockwise_attention(tq, tk, tv, use_kernels=use_kernels,
                                          score_bf16=True, **kw)
        out_t.backward(torch.tensor(dout).to(torch.bfloat16))
        got[use_kernels] = [out_t.detach(), tq.grad, tk.grad, tv.grad]
    assert called == [True]
    assert all(torch.equal(a, b) for a, b in zip(got[False], got[True]))
    np.testing.assert_allclose(got[True][0].float().numpy(), f32(out_j), **BF16)
    for g, w in zip(got[True][1:], grads_j):
        np.testing.assert_allclose(g.float().numpy(), f32(w), **BF16)
    plain32 = flash_attention_plain(*(torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)),
                                    **kw)[0]
    assert not torch.equal(plain32, got[True][0])


@pytest.mark.parametrize("S,KV,qpk,causal,window,softcap", SCORE_CASES)
def test_bf16_backward_rounding_mirror_matches_reference(S, KV, qpk, causal, window,
                                                         softcap):
    """The flash backward kernel (``flash_bwd_sm90.cu``) rounds P and dS to
    bf16 before the dV, dK and dQ products; the reference keeps them in
    float32. Its CPU mirror (``tests/torch_flash_mirror.py``) on bf16
    inputs, from the forward's float32 output and lse, against ``jax.vjp``
    of the reference's ``_flash_core`` within 2e-2; the rounding moves the
    gradients off the unrounded plain version's. (At this band the plain
    version passes too: ``tests/test_torch_cuda.py`` holds the mirror
    against kernel 9b, closer than the plain version.)"""
    q, k, v = _qkv(S, KV, qpk, seed=13)
    dout = np.random.default_rng(14).standard_normal(q.shape).astype(np.float32)
    args = (causal, window, softcap, BLK, BLK, False)
    _, vjp = jax.vjp(lambda a, b, c: jattn._flash_core(a, b, c, *args), *map(_bf, (q, k, v)))
    grads_j = [np.asarray(g.astype(jnp.float32)) for g in vjp(_bf(dout))]
    kw = dict(causal=causal, window=window, softcap=softcap, q_block=BLK, kv_block=BLK)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    _, lse, out32 = flash_attention_plain(tq, tk, tv, f32_out=True, **kw)
    td = torch.tensor(dout).to(torch.bfloat16)
    mirror = flash_bwd_rounded(tq, tk, tv, out32, lse, td, **kw)
    plain = flash_attention_bwd_plain(tq, tk, tv, out32, lse, td, **kw)
    for g, w in zip(mirror, grads_j):
        np.testing.assert_allclose(g.float().numpy(), w, **BF16)
    assert any(not torch.equal(a, b) for a, b in zip(mirror, plain))


# ---------------------------------------------------------------------------
# packed sequences
# ---------------------------------------------------------------------------

def _segments(B, S, seed):
    """Three packed documents a row, at seeded split points."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        a, c = sorted(rng.choice(np.arange(1, S), 2, replace=False))
        seg[b, a:c], seg[b, c:] = 1, 2
    return seg


@pytest.mark.parametrize("causal,Skv", [(True, None), (False, 24)])
def test_segment_ids_full_attention_matches_reference(causal, Skv):
    """Three documents a row through ``full_attention``, causal, and
    non-causal against keys of another length with ``kv_segment_ids``
    (float32, 2e-5)."""
    S, KV, qpk = 20, 2, 2
    q, k, v = _qkv(S, KV, qpk, seed=21)
    seg = _segments(2, S, seed=22)
    kw, kv_seg = {}, None
    if Skv is not None:
        _, k, v = _qkv(Skv, KV, qpk, seed=23)
        kv_seg = _segments(2, Skv, seed=24)
        kw = dict(kv_segment_ids=kv_seg)
    want = jattn.full_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                segment_ids=jnp.asarray(seg),
                                **{n: jnp.asarray(a) for n, a in kw.items()})
    got = tattn.full_attention(*map(torch.tensor, (q, k, v)), causal=causal,
                               segment_ids=torch.tensor(seg),
                               **{n: torch.tensor(a) for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    plain = tattn.full_attention(*map(torch.tensor, (q, k, v)), causal=causal)
    assert not torch.allclose(plain, got)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (12, 5.0)])
def test_segment_ids_blockwise_matches_reference(window, softcap, use_kernels):
    """Three documents a row through ``blockwise_attention`` at S 40 > the
    16-row blocks: the reference's segmented route, forward and (dq, dk,
    dv) by autograd against ``jax.vjp`` (float32, 2e-5); ``use_kernels``
    changes nothing there (the route has no kernel)."""
    S, KV, qpk = 40, 2, 2
    q, k, v = _qkv(S, KV, qpk, seed=31)
    seg = _segments(2, S, seed=32)
    dout = np.random.default_rng(33).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=softcap, q_block=BLK, kv_block=BLK)
    out_j, vjp = jax.vjp(lambda a, b, c: jattn.blockwise_attention(
        a, b, c, segment_ids=jnp.asarray(seg), **kw), *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out_t = tattn.blockwise_attention(tq, tk, tv, segment_ids=torch.tensor(seg),
                                      use_kernels=use_kernels, **kw)
    out_t.backward(torch.tensor(dout))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **F32)
    for g, w in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_segment_ids_forward_matches_reference():
    """``forward(..., segment_ids=)`` on tiny-moe at seq 48 (16-row blocks,
    so every attention layer takes the segmented route): float32 logits
    within 1e-4 and aux within 1e-5 of the reference's."""
    pj = jmodel.init_model(jax.random.PRNGKey(0), CFG_J)
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    toks = np.random.default_rng(41).integers(0, CFG_J.vocab_size, (2, 48)).astype(np.int32)
    seg = _segments(2, 48, seed=42)
    kw = dict(moe_impl="grouped", attn_q_block=BLK, attn_kv_block=BLK)

    @jax.jit
    def ref(p, t, s):
        with execution_plan(JPlan(**kw)):
            return jmodel.forward(p, CFG_J, {"tokens": t}, segment_ids=s)

    logits_j, aux_j = ref(pj, jnp.asarray(toks), jnp.asarray(seg))
    with torch.no_grad():
        logits_t, aux_t = tmodel.forward(pt, CFG_T, {"tokens": torch.tensor(toks)},
                                         plan=ExecutionPlan(use_kernels=True, **kw),
                                         segment_ids=torch.tensor(seg))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=1e-4, rtol=0)
    assert abs(float(aux_t) - float(aux_j)) <= 1e-5


# ---------------------------------------------------------------------------
# int8 error-feedback compression: bit-exact
# ---------------------------------------------------------------------------

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((5, 7)) * 3).astype(np.float32),
            "b": ({"c": (rng.standard_normal((33,)) * 1e-3).astype(np.float32)},
                  {"c": np.zeros((4,), np.float32)})}


def test_compression_is_bit_exact_against_reference():
    """compress, decompress, ef_step, init_error_state, compress_tree,
    decompress_tree and compressed_bytes on seeded trees (one all-zero
    leaf: the 1e-12 scale floor), three error-feedback rounds."""
    g_np = _grads(51)
    g_j, g_t = jax.tree_util.tree_map(jnp.asarray, g_np), from_numpy_tree(g_np, "cpu")
    e_j, e_t = jcomp.init_error_state(g_j), tcomp.init_error_state(g_t)
    eq = lambda t, j: np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for _ in range(3):
        (q_j, s_j), e_j = jcomp.compress_tree(g_j, e_j)
        (q_t, s_t), e_t = tcomp.compress_tree(g_t, e_t)
        for t, j in zip(tree_leaves(q_t) + tree_leaves(s_t) + tree_leaves(e_t),
                        jax.tree_util.tree_leaves((q_j, s_j, e_j))):
            eq(t, j)
        assert all(t.dtype == torch.int8 for t in tree_leaves(q_t))
        for t, j in zip(tree_leaves(tcomp.decompress_tree(q_t, s_t, g_t)),
                        jax.tree_util.tree_leaves(jcomp.decompress_tree(q_j, s_j, g_j))):
            eq(t, j)
    x = torch.tensor(g_np["a"])
    q, s = tcomp.compress(x)
    qj, sj = jcomp.compress(jnp.asarray(g_np["a"]))
    eq(q, qj), eq(s, sj)
    eq(tcomp.decompress(q, s, torch.bfloat16).float(),
       jcomp.decompress(qj, sj, jnp.bfloat16).astype(jnp.float32))
    for t, j in zip(tcomp.ef_step(x, torch.ones_like(x)),
                    jcomp.ef_step(jnp.asarray(g_np["a"]), jnp.ones((5, 7)))):
        eq(t, j)
    assert tcomp.compressed_bytes(g_t) == jcomp.compressed_bytes(g_j) == 35 + 33 + 4


@settings(max_examples=15, deadline=None)
@given(scale=st.floats(1e-3, 1e3), n=st.integers(2, 64))
def test_compress_roundtrip_error_bound(scale, n):
    """The reference's round-trip bound on the port (|err| <= scale / 2 an
    element), and the same bits as the reference's ``compress``."""
    g_np = (np.random.default_rng(n).standard_normal(n) * scale).astype(np.float32)
    g = torch.tensor(g_np)
    q, s = tcomp.compress(g)
    back = tcomp.decompress(q, s)
    assert float((back - g).abs().max()) <= float(s) * 0.5 + 1e-9
    qj, sj = jcomp.compress(jnp.asarray(g_np))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert float(s) == float(sj)


def test_error_feedback_reduces_bias():
    """With EF, the accumulated compressed sum tracks the true sum."""
    g = torch.tensor([0.004, -0.003, 0.002])   # below one quantization step
    err, total = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(64):
        q, s, err = tcomp.ef_step(g, err)
        total = total + tcomp.decompress(q, s)
    np.testing.assert_allclose((total / 64).numpy(), g.numpy(), atol=5e-4)


# ---------------------------------------------------------------------------
# the mesh, the cross-pod mean and the pipeline on a one-rank gloo group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    with tmesh.process_group("cpu"):
        yield


def test_mesh_info_matches_reference(one_rank):
    mesh = tmesh.make_local_mesh(1, 1, device="cpu")
    assert tmesh.mesh_info(mesh) == jmesh.mesh_info(jmesh.make_local_mesh(1, 1))
    assert tmesh.mesh_info(tmesh.make_mesh((1,), ("pod",), "cpu")) == \
        jmesh.mesh_info(jmesh.make_mesh((1,), ("pod",)))


def test_cross_pod_mean_int8_matches_reference(one_rank):
    """One pod: the int8 mean equals decompress(compress(g + err)) and the
    reference's ``shard_map`` collective on a one-device mesh, bit for bit,
    mean and new error state."""
    g_np = _grads(61)
    e_np = jax.tree_util.tree_map(lambda a: np.full(a.shape, 0.25, np.float32), g_np)
    mean_j, err_j = jcomp.cross_pod_mean_int8(
        jax.tree_util.tree_map(jnp.asarray, g_np), jax.tree_util.tree_map(jnp.asarray, e_np),
        jmesh.make_mesh((1,), ("pod",)), axis="pod")
    g_t, e_t = from_numpy_tree(g_np, "cpu"), from_numpy_tree(e_np, "cpu")
    mean_t, err_t = tcomp.cross_pod_mean_int8(g_t, e_t, tmesh.make_mesh((1,), ("pod",), "cpu"))
    for t, j in zip(tree_leaves(mean_t) + tree_leaves(err_t),
                    jax.tree_util.tree_leaves((mean_j, err_j))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for m, g, e in zip(tree_leaves(mean_t), tree_leaves(g_t), tree_leaves(e_t)):
        assert torch.equal(m, tcomp.decompress(*tcomp.compress(g + e)))


def test_pipeline_matches_sequential_and_reference(one_rank):
    """One stage, four microbatches: ``pipeline_apply`` equals the stage
    applied to each microbatch and the reference's schedule (1e-6);
    ``pipeline_loss`` its mean loss; ``bubble_fraction`` the reference's."""
    W = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 8, 8)) * 0.3)
    mbs = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 2, 8)))
    out_j = jpipe.pipeline_apply(lambda w, x: jnp.tanh(x @ w), jnp.asarray(W),
                                 jnp.asarray(mbs), mesh=jmesh.make_mesh((1,), ("pipe",)))
    mesh = tmesh.make_mesh((1,), ("pipe",), "cpu")
    fn = lambda w, x: torch.tanh(x @ w)
    out_t = tpipe.pipeline_apply(fn, torch.tensor(W), torch.tensor(mbs), mesh=mesh)
    want = torch.stack([fn(torch.tensor(W[0]), x) for x in torch.tensor(mbs)])
    torch.testing.assert_close(out_t, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6, rtol=0)
    targets = torch.zeros_like(want)
    loss = tpipe.pipeline_loss(fn, lambda o, t: ((o - t) ** 2).mean(), torch.tensor(W),
                               torch.tensor(mbs), targets, mesh=mesh)
    torch.testing.assert_close(loss, (want ** 2).mean(), atol=1e-6, rtol=0)
    assert tpipe.bubble_fraction(8, 4) == jpipe.bubble_fraction(8, 4) == pytest.approx(3 / 11)
