"""BERT for fine-tuning, in PyTorch — port of
``paddle_tpu/models/bert/modeling.py`` (the bidirectional encoder: learned
positions and token types, post-LN blocks, an erf-GELU FFN, the pooler,
the tied masked-LM head and the sequence-classification head).

Parameter names and ``[in, out]`` layouts are the JAX package's, so a JAX
``state_dict()`` loads as it is (:func:`paddle_tpu_torch.weights.
load_jax_state`); the MLM head reads the word embedding
(``bert.embeddings.word_embeddings_weight``) transposed, one parameter.

Encoder attention (:func:`_encoder_attention`) is ``ops.flash_attention``
with ``causal=False``, the JAX function's bare-TPU branch: on CUDA tensors
the flash kernel K1 and, while autograd records, K1 with its lse and the
backward kernels K2/K3; on CPU tensors its plain version.

Dropout (``hidden_dropout_prob``, in training mode) draws its keep masks
from a ``torch.Generator`` the model owns, seeded by the constructor's
``seed``; the masks are not ``jax.random``'s. ``recompute=True``
checkpoints each layer while autograd records in training, and the
recompute draws the forward's masks again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device, resolve_dtype
from ...nn.functional.common import dropout
from ...ops.flash_attention import flash_attention
from .._common import _layer_norm, _normal, _replaying


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, layer_norm_eps=1e-12,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 initializer_range=0.02, dtype="float32", recompute=False,
                 num_labels=2):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.layer_norm_eps = layer_norm_eps
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range
        self.dtype = dtype
        self.recompute = recompute
        self.num_labels = num_labels

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    def num_params(self) -> int:
        h, v = self.hidden_size, self.vocab_size
        per_layer = 4 * h * h + 2 * h * self.intermediate_size + 13 * h
        emb = (v + self.max_position_embeddings + self.type_vocab_size) * h
        return emb + self.num_hidden_layers * per_layer + 2 * h * h

    @classmethod
    def tiny(cls, **over):
        """Small config for tests (the JAX package's ``tiny``: dropout 0,
        head_dim 16, a CPU config)."""
        d = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128,
                 max_position_embeddings=128, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
        d.update(over)
        return cls(**d)


def _const(n, value, config, device):
    return nn.Parameter(torch.full((n,), float(value),
                                   dtype=resolve_dtype(config.dtype),
                                   device=device))


def _maybe_dropout(x, p, training, generator):
    """Inverted dropout (:111-117): keep with probability 1 - p, scale kept
    values by 1 / (1 - p); the identity outside training or at p = 0."""
    return dropout(x, p, training=training, generator=generator)


def _encoder_attention(q, k, v, config):
    """Bidirectional attention on [b, s, h, d] tensors (:120-130): the
    flash kernels on the card, their plain version on the CPU."""
    return flash_attention(q, k, v, causal=False)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, device, gen, drop_gen):
        super().__init__()
        self.config = config
        self.drop_gen = drop_gen
        h = config.hidden_size
        self.word_embeddings_weight = _normal((config.vocab_size, h), config,
                                              device, gen)
        self.position_embeddings_weight = _normal(
            (config.max_position_embeddings, h), config, device, gen)
        self.token_type_embeddings_weight = _normal(
            (config.type_vocab_size, h), config, device, gen)
        self.ln_weight = _const(h, 1.0, config, device)
        self.ln_bias = _const(h, 0.0, config, device)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        x = self.word_embeddings_weight[input_ids.long()]
        x = x + self.position_embeddings_weight[:s][None]
        if token_type_ids is not None:
            x = x + self.token_type_embeddings_weight[token_type_ids.long()]
        x = _layer_norm(x, self.ln_weight, self.ln_bias,
                        self.config.layer_norm_eps)
        return _maybe_dropout(x, self.config.hidden_dropout_prob,
                              self.training, self.drop_gen)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, device, gen):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.num_heads, self.hd = config.num_attention_heads, config.head_dim
        for name in ("q", "k", "v"):
            setattr(self, f"{name}_weight", _normal((h, h), config, device,
                                                    gen))
            setattr(self, f"{name}_bias", _const(h, 0.0, config, device))
        self.out_weight = _normal((h, h), config, device, gen)
        self.out_bias = _const(h, 0.0, config, device)

    def forward(self, x):
        b, s, h = x.shape

        def heads(w, bias):
            return (x @ w + bias).reshape(b, s, self.num_heads, self.hd)

        q = heads(self.q_weight, self.q_bias)
        k = heads(self.k_weight, self.k_bias)
        v = heads(self.v_weight, self.v_bias)
        out = _encoder_attention(q, k, v, self.config).reshape(b, s, h)
        return out @ self.out_weight + self.out_bias


class BertLayer(nn.Module):
    """Post-LN encoder block (original BERT ordering)."""

    def __init__(self, config: BertConfig, device, gen, drop_gen):
        super().__init__()
        self.config = config
        self.drop_gen = drop_gen
        h, m = config.hidden_size, config.intermediate_size
        self.attention = BertSelfAttention(config, device, gen)
        self.attn_ln_weight = _const(h, 1.0, config, device)
        self.attn_ln_bias = _const(h, 0.0, config, device)
        self.inter_weight = _normal((h, m), config, device, gen)
        self.inter_bias = _const(m, 0.0, config, device)
        self.out_weight = _normal((m, h), config, device, gen)
        self.out_bias = _const(h, 0.0, config, device)
        self.out_ln_weight = _const(h, 1.0, config, device)
        self.out_ln_bias = _const(h, 0.0, config, device)

    def forward(self, x):
        cfg = self.config
        p, eps = cfg.hidden_dropout_prob, cfg.layer_norm_eps
        a = _maybe_dropout(self.attention(x), p, self.training, self.drop_gen)
        x = _layer_norm(x + a, self.attn_ln_weight, self.attn_ln_bias, eps)
        f = F.gelu(x @ self.inter_weight + self.inter_bias)   # erf GELU
        f = f @ self.out_weight + self.out_bias
        f = _maybe_dropout(f, p, self.training, self.drop_gen)
        return _layer_norm(x + f, self.out_ln_weight, self.out_ln_bias, eps)


class BertModel(nn.Module):
    def __init__(self, config: BertConfig, device, gen, drop_gen):
        super().__init__()
        self.config = config
        self.drop_gen = drop_gen
        self.embeddings = BertEmbeddings(config, device, gen, drop_gen)
        self.layers = nn.ModuleList([
            BertLayer(config, device, gen, drop_gen)
            for _ in range(config.num_hidden_layers)])
        h = config.hidden_size
        self.pooler_weight = _normal((h, h), config, device, gen)
        self.pooler_bias = _const(h, 0.0, config, device)

    def forward(self, input_ids, token_type_ids=None):
        """(sequence output [b, s, h], pooled [b, h])."""
        x = self.embeddings(input_ids, token_type_ids)
        remat = (self.config.recompute and self.training
                 and torch.is_grad_enabled())
        for layer in self.layers:
            if remat:
                x = checkpoint(_replaying(layer, [self.drop_gen]), x,
                               use_reentrant=False)
            else:
                x = layer(x)
        pooled = torch.tanh(x[:, 0] @ self.pooler_weight + self.pooler_bias)
        return x, pooled


def _encoder(config, device, seed):
    """(device, init generator, dropout generator, BertModel): weights
    drawn from a normal of ``config.initializer_range`` with a generator
    seeded by ``seed``; dropout masks from a second one seeded alike."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    drop = torch.Generator(device=dev)
    drop.manual_seed(int(seed))
    return dev, gen, drop, BertModel(config, dev, gen, drop)


class BertForMaskedLM(nn.Module):
    """MLM head tied to the word embeddings (bench config 2,
    pretrain-style), on ``device`` (default: the CUDA device; raises
    without one unless ``device="cpu"``)."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev, _, self.dropout_generator, self.bert = _encoder(config, device,
                                                             seed)
        self.mlm_bias = _const(config.vocab_size, 0.0, config, dev)

    def forward(self, input_ids, token_type_ids=None):
        x, _ = self.bert(input_ids, token_type_ids)
        return x @ self.bert.embeddings.word_embeddings_weight.T \
            + self.mlm_bias

    def loss_fn(self, input_ids, labels):
        """Masked-LM cross-entropy; label -100 positions are ignored (the
        HF convention), the mean over the rest."""
        logp = torch.log_softmax(self.forward(input_ids).float(), dim=-1)
        lbl = labels.long()
        mask = lbl != -100
        nll = -logp.gather(-1, torch.where(mask, lbl, 0)[..., None])[..., 0]
        return torch.where(mask, nll, 0.0).sum() / mask.sum().clamp_min(1)


class BertForSequenceClassification(nn.Module):
    """Classifier over the pooled output, on ``device`` (as
    :class:`BertForMaskedLM`)."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev, gen, self.dropout_generator, self.bert = _encoder(config, device,
                                                               seed)
        self.classifier_weight = _normal(
            (config.hidden_size, config.num_labels), config, dev, gen)
        self.classifier_bias = _const(config.num_labels, 0.0, config, dev)

    def forward(self, input_ids, token_type_ids=None):
        _, pooled = self.bert(input_ids, token_type_ids)
        pooled = _maybe_dropout(pooled, self.config.hidden_dropout_prob,
                                self.training, self.dropout_generator)
        return pooled @ self.classifier_weight + self.classifier_bias

    def loss_fn(self, input_ids, labels):
        logp = torch.log_softmax(self.forward(input_ids).float(), dim=-1)
        return -logp.gather(-1, labels.long()[..., None]).mean()
