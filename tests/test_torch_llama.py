"""Port Llama (paddle_tpu_torch.models) against the JAX Llama on carried
weights: dense forward logits, paged prefill (``_decode_chunk``) logits and
a few ``paged_token_step`` logits, tied and untied heads, GQA 4/2, fp32 on
the CPU, atol 1e-4 (two fp32 matmul stacks with different summation
orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

ATOL = 1e-4


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def pair(request):
    paddle.seed(21)
    tie = request.param
    jm = JaxLlama(JaxConfig.tiny(tie_word_embeddings=tie))
    tm = LlamaForCausalLM(LlamaConfig.tiny(tie_word_embeddings=tie),
                          device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


def test_forward_logits_match(pair):
    jm, tm = pair
    ids = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(np.int32)
    ref = jm(paddle.to_tensor(ids)).numpy()
    # parameters are trainable: the dense forward builds a graph
    out = tm(torch.from_numpy(ids)).detach().numpy()
    assert out.shape == (2, 12, 256)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_paged_prefill_and_token_steps_match(pair):
    jm, tm = pair
    ids = np.random.default_rng(1).integers(0, 256, (2, 11)).astype(np.int32)
    jc = jm._init_paged_caches(2, 32, 8)
    tc = tm._init_paged_caches(2, 32, 8, device="cpu")
    ref, jc = jm._decode_chunk(jnp.asarray(ids), jc, 0, None, None)
    out, tc = tm._decode_chunk(torch.from_numpy(ids), tc, 0, None, None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    tok = np.asarray(ref).argmax(-1).astype(np.int32)
    pos = np.full(2, 11, np.int32)
    for _ in range(3):
        ref, jc = jm.paged_token_step(jnp.asarray(tok), jc, jnp.asarray(pos))
        out, tc = tm.paged_token_step(torch.from_numpy(tok), tc,
                                      torch.from_numpy(pos))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
        tok = np.asarray(ref).argmax(-1).astype(np.int32)
        pos = pos + 1
    for (jk, jv), (tk, tv) in zip(jc["kv"], tc["kv"]):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_load_checks_names_and_shapes(pair):
    jm, tm = pair
    state = state_from_jax_layer(jm)
    bad = dict(state)
    bad.pop("model.norm.weight")
    with pytest.raises(KeyError, match="model.norm.weight"):
        load_jax_state(tm, bad)
    bad = dict(state)
    bad["model.norm.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_state(tm, bad)


def test_moe_and_training_paths_raise():
    with pytest.raises(NotImplementedError, match="MoE"):
        LlamaForCausalLM(LlamaConfig.tiny(num_experts=4), device="cpu")
    with pytest.raises(NotImplementedError, match="remat slice"):
        LlamaForCausalLM(LlamaConfig.tiny(recompute=True), device="cpu")
    # the training loss is ported: labels give the shifted CE, a scalar
    # with a graph back to every parameter
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    loss = tm(ids, labels=ids)
    assert loss.ndim == 0 and loss.requires_grad
    assert all(p.requires_grad for p in tm.parameters())
