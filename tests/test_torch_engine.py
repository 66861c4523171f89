"""PyTorch port, engine level: the port's ``ServingEngine`` emits exactly the
reference engine's greedy tokens on the paged + chunked + duplex-ragged
path (kernels on: the port's plain kernel versions on the CPU, the
reference's Pallas kernels in interpret mode), with the same per-stage
``k_cold`` and the same stage composition."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig, small_test_config
from repro.models.model import init_model
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.request import Request as RefRequest
from repro_torch.configs import resolve_config
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

KW = dict(max_slots=3, max_len=64, kv_page_size=8, prefill_chunk_tokens=16)
EOS = 156       # request 1's second greedy token with these weights and prompts


def test_engine_emits_the_reference_greedy_tokens():
    cfg_j = small_test_config("tiny-moe", family="moe",
                              moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128))
    params_j = init_model(jax.random.PRNGKey(0), cfg_j)
    params_t = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    rng = np.random.default_rng(0)
    # 4 requests over 3 slots: one waits for a slot; prompts span 1-2 chunks.
    # Each stage of the reference compiles anew (its plan is part of the jit
    # key) and runs the Pallas kernels in interpret mode, so the run is kept
    # to six stages.
    prompts = [rng.integers(0, cfg_j.vocab_size, n).tolist() for n in (19, 5, 27, 9)]

    ref = RefEngine(cfg_j, params_j, kv_layout="paged", use_kernels=True, **KW)
    # request 1 stops at an end-of-sequence id (the token the reference
    # emits second for it); the rest run to their length
    ref_reqs = [RefRequest(rid=i, prompt=list(p), max_new_tokens=3,
                           eos_id=EOS if i == 1 else None)
                for i, p in enumerate(prompts)]
    ref.run(ref_reqs)

    eng = ServingEngine(resolve_config("tiny-moe"), params_t, device="cpu",
                        use_kernels=True, **KW)
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=3,
                    eos_id=EOS if i == 1 else None) for i, p in enumerate(prompts)]
    eng.run(reqs)

    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert len(reqs[1].output) == 2 and reqs[1].output[-1] == EOS
    assert all(r.done for r in reqs)
    assert reqs[3].slot == reqs[1].slot      # request 3 waited for request 1's slot
    assert [r.k_cold for r in eng.reports] == [r.k_cold for r in ref.reports]
    assert [(r.is_mixed, r.num_decode, r.num_prefill, r.stage_tokens)
            for r in eng.reports] == [(r.is_mixed, r.num_decode, r.num_prefill,
                                       r.stage_tokens) for r in ref.reports]
    # both hot and cold experts ran (k_cold strictly between 0 and E)
    assert any(0 < r.k_cold < 8 for r in eng.reports)
    assert [r.kv_bytes_streamed for r in eng.reports] == \
        [r.kv_bytes_streamed for r in ref.reports]
    assert eng.kv.live_pages == 0 and eng.kv.free_slots == KW["max_slots"]


def test_engine_refuses_oversized_prompt():
    params = from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, init_model(
            jax.random.PRNGKey(0), small_test_config(
                "tiny-moe", family="moe",
                moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128)))), "cpu")
    eng = ServingEngine(resolve_config("tiny-moe"), params, device="cpu", **KW)
    with pytest.raises(ValueError, match="never silently truncated"):
        eng.submit(Request(rid=0, prompt=list(range(64)), max_new_tokens=2))
