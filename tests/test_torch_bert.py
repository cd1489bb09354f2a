"""Port BERT (paddle_tpu_torch.models.bert) against the JAX package's on
carried ``BertConfig.tiny()`` weights (fp32, CPU, dropout 0 as ``tiny``
and bench.py's ``bench_bert`` set it): the MLM and sequence-
classification heads' logits, losses, every gradient and three ``Engine``
steps; token-type ids; the -100 mask; recompute; the non-causal flash
routing; and dropout from the model's own generator (statistically: its
masks are not ``jax.random``'s).

Tolerances (fp32; only BLAS summation orders and the attention fallbacks
differ):
- logits: absolute 1e-4; losses relative 1e-5;
- gradients: max abs error <= 1e-5 * max(1, max |jax grad|) per
  parameter; a parameter the loss does not read (the token-type table
  without token types, the MLM head's pooler) has a zero gradient on both
  sides;
- three ``Engine.step``s (lr 1e-3, clip 1.0, the model's ``loss_fn``):
  losses relative 1e-5, moments 1e-4 of their largest magnitude (with a
  floor for the key biases, whose gradients are rounding noise: in the
  test), parameters within 2 * lr * steps with at most 0.1% of elements more
  than 2e-5 apart (tests/test_torch_training.py's bounds);
- dropout at p = 0.1 over 2^16 elements: the keep rate within 0.005 of
  0.9 (about 5 standard deviations) and every kept value scaled by
  exactly 1 / 0.9.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.auto_parallel import Engine as JaxTrainer
from paddle_tpu.models import BertConfig as JaxConfig
from paddle_tpu.models import BertForMaskedLM as JaxMLM
from paddle_tpu.models import BertForSequenceClassification as JaxSeqCls
from paddle_tpu_torch.distributed import Engine
from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                     BertForSequenceClassification)
from paddle_tpu_torch.models.bert import modeling as bert_mod
from paddle_tpu_torch.weights import (engine_state_from_jax,
                                      engine_state_to_host, load_jax_state,
                                      state_from_jax_layer)

torch.set_num_threads(1)

fa_mod = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
ATOL = 1e-4
HEADS = {"mlm": (JaxMLM, BertForMaskedLM),
         "seqcls": (JaxSeqCls, BertForSequenceClassification)}
B, S = 2, 24


def _pair(head, **over):
    jcls, tcls = HEADS[head]
    paddle.seed(5)
    jm = jcls(JaxConfig.tiny(num_labels=3, **over))
    tm = tcls(BertConfig.tiny(num_labels=3, **over), device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


@pytest.fixture(scope="module", params=sorted(HEADS))
def pair(request):
    return request.param, *_pair(request.param)


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


def _labels(head, seed):
    rng = np.random.default_rng(seed + 100)
    if head == "seqcls":
        return rng.integers(0, 3, (B,)).astype(np.int32)
    labels = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.7] = -100     # most positions unmasked
    return labels


def _jax_logits(jm, ids, tt=None):
    out = jm(paddle.to_tensor(ids),
             None if tt is None else paddle.to_tensor(tt))
    return np.asarray(getattr(out, "_data", out))


def test_logits_match_jax_with_and_without_token_types(pair):
    head, jm, tm = pair
    ids = _ids(0)
    tt = (np.arange(S)[None, :] >= S // 2).astype(np.int32).repeat(B, 0)
    for types_ in (None, tt):
        got = tm(torch.from_numpy(ids),
                 None if types_ is None else torch.from_numpy(types_))
        assert got.shape == ((B, S, 256) if head == "mlm" else (B, 3))
        np.testing.assert_allclose(got.detach().numpy(),
                                   _jax_logits(jm, ids, types_), atol=ATOL,
                                   rtol=0)
    # token types move the output
    assert not torch.allclose(tm(torch.from_numpy(ids)),
                              tm(torch.from_numpy(ids),
                                 torch.from_numpy(tt)))


def test_loss_matches_jax(pair):
    head, jm, tm = pair
    ids, labels = _ids(1), _labels(head, 1)
    loss = tm.loss_fn(torch.from_numpy(ids), torch.from_numpy(labels))
    assert loss.ndim == 0 and loss.dtype == torch.float32
    np.testing.assert_allclose(
        loss.item(), float(jm.loss_fn(jnp.asarray(ids), jnp.asarray(labels))),
        rtol=1e-5)


def test_mlm_ignores_minus_100():
    """Positions labelled -100 take no part in the MLM loss: it is the
    mean NLL over the labelled positions alone, and a batch with every
    label -100 has loss 0 (JAX's max(count, 1) denominator)."""
    _, tm = _pair("mlm")
    ids, labels = _ids(2), _labels("mlm", 2)
    lb = torch.from_numpy(labels)
    logp = torch.log_softmax(tm(torch.from_numpy(ids)).float(), -1)
    keep = lb != -100
    ref = -logp[keep].gather(-1, lb[keep].long()[:, None]).mean()
    torch.testing.assert_close(tm.loss_fn(torch.from_numpy(ids), lb), ref)
    assert tm.loss_fn(torch.from_numpy(ids),
                      torch.full_like(lb, -100)).item() == 0.0


def _jax_grads(jm, ids, labels):
    je = JaxTrainer(jm, mesh=None, loss_fn=jm.loss_fn)
    g = jax.grad(je._pure_loss)(je.params, jnp.asarray(ids),
                                jnp.asarray(labels))
    return dict(zip(je._param_names, g))


def _grads(tm, ids, labels):
    names = [n for n, _ in tm.named_parameters()]
    loss = tm.loss_fn(torch.from_numpy(ids), torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(tm.parameters()),
                                allow_unused=True, materialize_grads=True)
    return loss, dict(zip(names, grads))


def test_every_gradient_matches_jax(pair):
    head, jm, tm = pair
    ids, labels = _ids(3), _labels(head, 3)
    _, grads = _grads(tm, ids, labels)
    jg = _jax_grads(jm, ids, labels)
    assert sorted(grads) == sorted(jg)
    unused = {"bert.embeddings.token_type_embeddings_weight"}
    if head == "mlm":
        unused |= {"bert.pooler_weight", "bert.pooler_bias"}
    for name, g in grads.items():
        ref = np.asarray(jg[name])
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-5 * max(1.0, np.abs(ref).max()), (name, err)
        assert (not g.any()) == (name in unused), name


def test_three_engine_steps_match_jax(pair):
    head, _, _ = pair
    jm, tm = _pair(head)
    batches = [(_ids(10 + i), _labels(head, 10 + i)) for i in range(3)]
    je = JaxTrainer(jm, mesh=None, lr=1e-3, clip_norm=1.0,
                    loss_fn=jm.loss_fn)
    te = Engine(tm, lr=1e-3, clip_norm=1.0, loss_fn=tm.loss_fn)
    if head == "mlm":
        word = "bert.embeddings.word_embeddings_weight"
        assert te._param_names.count(word) == 1     # tied: one parameter
    jl = [float(je.step(ids, lb)) for ids, lb in batches]
    tl = [te.step(torch.from_numpy(ids), torch.from_numpy(lb)).item()
          for ids, lb in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    js, ts = engine_state_from_jax(je), engine_state_to_host(te)
    assert js["step"] == ts["step"] == 3
    lr, steps = 1e-3, 3
    far = total = 0
    for name, ref in js["model"].items():
        err = np.abs(ts["model"][name] - ref)
        assert err.max() <= 2 * lr * steps, (name, err.max())
        far += int((err > 2e-5).sum())
        total += err.size
    assert far <= 1e-3 * total, (far, total)
    for key in ("m", "v"):
        assert sorted(ts[key]) == sorted(js[key])
        # the key biases' gradients are 0 in exact arithmetic (softmax
        # does not see a shift of every key's logit): both sides hold
        # rounding noise there (~1e-13), so each moment is held to 1e-4
        # of its own largest magnitude or of 1e-6 of the largest of all
        floor = 1e-6 * max(np.abs(a).max() for a in js[key].values())
        for name, ref in js[key].items():
            err = np.abs(ts[key][name] - ref).max()
            assert err <= 1e-4 * max(np.abs(ref).max(), floor), \
                (key, name, err)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(fa_mod, name)

    def spy(q, k, v, causal=False, scale=None):
        calls.append(causal)
        return real(q, k, v, causal, scale)

    monkeypatch.setattr(fa_mod, name, spy)
    return calls


def test_encoder_attention_is_the_non_causal_flash_path(monkeypatch):
    """Every layer's attention runs ops.flash_attention with causal=False:
    its primal plain version without autograd, the training op's (with
    lse) while autograd records."""
    _, tm = _pair("seqcls")
    ids = torch.from_numpy(_ids(4))
    primal = _spy(monkeypatch, "flash_attention_reference")
    lse = _spy(monkeypatch, "flash_attention_reference_lse")
    with torch.no_grad():
        tm(ids)
    assert primal == [False, False] and lse == []
    primal.clear()
    tm.loss_fn(ids, torch.zeros(B, dtype=torch.long)).backward()
    assert primal == [] and lse == [False, False]


def test_recompute_equals_no_recompute(pair, monkeypatch):
    """recompute=True checkpoints each layer in training while autograd
    records (the forward runs again in the backward); loss and gradients
    are the same."""
    head, _, tm = pair
    ids, labels = _ids(5), _labels(head, 5)
    lse = _spy(monkeypatch, "flash_attention_reference_lse")
    loss, grads = _grads(tm, ids, labels)
    assert len(lse) == 2
    rm = HEADS[head][1](BertConfig.tiny(num_labels=3, recompute=True),
                        device="cpu")
    rm.load_state_dict(tm.state_dict())
    lse.clear()
    rloss, rgrads = _grads(rm, ids, labels)
    assert len(lse) == 4
    assert rloss.item() == loss.item()
    for name, g in grads.items():
        torch.testing.assert_close(rgrads[name], g, rtol=0, atol=1e-7)


def test_dropout_keep_rate_and_scale_from_the_model_generator():
    """hidden_dropout_prob 0.1 in training: the keep masks come from the
    model's own generator (same seed, same masks; another seed, other
    masks), keep ~90% and scale kept values by 1/0.9; eval mode and p = 0
    are the identity."""
    cfg = BertConfig.tiny(hidden_dropout_prob=0.1)
    x = torch.ones(64, 1024)
    m = BertForSequenceClassification(cfg, device="cpu", seed=3)
    gen = m.dropout_generator
    y = bert_mod._maybe_dropout(x, 0.1, True, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9),
                               rtol=0, atol=0)
    again = BertForSequenceClassification(cfg, device="cpu", seed=3)
    assert torch.equal(bert_mod._maybe_dropout(x, 0.1, True,
                                               again.dropout_generator), y)
    other = BertForSequenceClassification(cfg, device="cpu", seed=4)
    assert not torch.equal(bert_mod._maybe_dropout(
        x, 0.1, True, other.dropout_generator), y)
    assert bert_mod._maybe_dropout(x, 0.1, False, gen) is x
    assert bert_mod._maybe_dropout(x, 0.0, True, gen) is x
    # the model draws from it: two training forwards differ, eval ones
    # do not, and a recompute replays the forward's masks
    ids = torch.from_numpy(_ids(6))
    assert not torch.equal(m(ids), m(ids))
    m.eval()
    assert torch.equal(m(ids), m(ids))
    m.train()
    rm = BertForSequenceClassification(
        BertConfig.tiny(hidden_dropout_prob=0.1, recompute=True),
        device="cpu", seed=3)
    rm.load_state_dict(m.state_dict())
    plain = BertForSequenceClassification(cfg, device="cpu", seed=3)
    plain.load_state_dict(m.state_dict())
    lbl = torch.zeros(B, dtype=torch.long)
    g_plain = torch.autograd.grad(plain.loss_fn(ids, lbl),
                                  list(plain.parameters()),
                                  allow_unused=True, materialize_grads=True)
    g_re = torch.autograd.grad(rm.loss_fn(ids, lbl), list(rm.parameters()),
                               allow_unused=True, materialize_grads=True)
    for a, b in zip(g_plain, g_re):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-7)


def test_config_equals_jax():
    """The configs carry JAX's fields and defaults, ``tiny`` and
    ``num_params`` (JAX's formula) included."""
    for cfg, ref in ((BertConfig(), JaxConfig()),
                     (BertConfig.tiny(num_labels=3),
                      JaxConfig.tiny(num_labels=3))):
        assert vars(cfg) == vars(ref)
        assert cfg.num_params() == ref.num_params()
        assert cfg.head_dim == ref.head_dim
