"""Llama for serving and training, in PyTorch — port of
``paddle_tpu/models/llama/modeling.py``.

Parameter names and layouts are the JAX package's: every projection is an
``[in, out]`` matrix and the model computes ``x @ W``, so a JAX
``state_dict()`` loads with no transposes (:func:`paddle_tpu_torch.weights.
load_jax_state`). Attention runs through the port's kernels: causal prefill
through ``ops.flash_attention`` and paged decode through
``ops.paged_decode_attention``; projections, the MLP and the lm head are
plain ``torch.matmul``, as the JAX package leaves them to XLA.

bf16 rounding follows the JAX package: rope tables are computed in fp32 and
cast to the activation dtype, RMSNorm normalises in fp32, casts back, then
multiplies the weight in the activation dtype, and logits come from a
model-dtype matmul cast to fp32.

Parameters are trainable (``requires_grad=True``, as the JAX package's
are): ``loss_fn`` computes the shifted causal-LM loss through the fused,
chunked cross-entropy (``ops.fused_ce``) and ``forward(ids, labels)`` the
unfused criterion; gradients flow through the flash kernels' backward
(K2/K3). The serving hooks (``_decode_chunk``, ``paged_token_step``) run
under ``torch.no_grad()`` and build no graph. Remat (``recompute=True``)
and MoE layers arrive with later slices and raise here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device, resolve_dtype
from ...ops.flash_attention import flash_attention
from ...ops.fused_ce import fused_linear_cross_entropy
from ...ops.paged_attention import append_paged_kv, paged_decode_attention
from ..generation_utils import GenerationMixin


class LlamaConfig:
    def __init__(
        self,
        vocab_size: int = 32000,
        hidden_size: int = 4096,
        intermediate_size: int = 11008,
        num_hidden_layers: int = 32,
        num_attention_heads: int = 32,
        num_key_value_heads: Optional[int] = None,
        max_position_embeddings: int = 4096,
        rms_norm_eps: float = 1e-6,
        rope_theta: float = 10000.0,
        initializer_range: float = 0.02,
        tie_word_embeddings: bool = False,
        dtype: str = "float32",
        recompute: bool = False,
        remat_policy: str = "flash",
        remat_every: int = 1,
        num_experts: int = 1,
        fused_ce: bool = True,
        fused_ce_chunk: int = 1024,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.initializer_range = initializer_range
        self.tie_word_embeddings = tie_word_embeddings
        self.dtype = dtype
        self.recompute = recompute
        if remat_policy not in ("flash", "flash_qkv", "flash_mlp", "full"):
            raise ValueError(f"remat_policy must be 'flash', 'flash_qkv', "
                             f"'flash_mlp' or 'full', got {remat_policy!r}")
        self.remat_policy = remat_policy
        if remat_every < 1:
            raise ValueError(f"remat_every must be >= 1 (got {remat_every}); "
                             "use recompute=False to disable remat")
        self.remat_every = remat_every
        self.num_experts = num_experts
        # chunked lm-head + CE (ops/fused_ce.py) in the training loss
        self.fused_ce = fused_ce
        self.fused_ce_chunk = fused_ce_chunk

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def num_params(self) -> int:
        """Parameter count."""
        h, v, m = self.hidden_size, self.vocab_size, self.intermediate_size
        kvh = self.num_key_value_heads * self.head_dim
        per_layer = h * h + 2 * h * kvh + h * h + 3 * h * m + 2 * h
        total = v * h + self.num_hidden_layers * per_layer + h
        if not self.tie_word_embeddings:
            total += h * v
        return total

    @classmethod
    def tiny(cls, **over):
        """Small config for tests (the JAX package's ``tiny``)."""
        d = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=128)
        d.update(over)
        return cls(**d)


def _rope_cos_sin(seq_len: int, head_dim: int, theta: float, dtype,
                  device=None):
    """Rotary tables [seq, head_dim] (half-rotated, GPT-NeoX style),
    computed in fp32 and cast to ``dtype``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                    # [s, d/2]
    emb = torch.cat([freqs, freqs], dim=-1)             # [s, d]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q,k: [b, s, h, d]; cos/sin: [s, d] (shared positions) or [b, s, d]
    (per-row positions) — broadcast over heads."""
    if cos.ndim == 3:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    else:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


def _normal(shape, config, device, gen):
    t = torch.empty(shape, dtype=resolve_dtype(config.dtype), device=device)
    t.normal_(0.0, config.initializer_range, generator=gen)
    return nn.Parameter(t)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        self.config = config
        h, hd = config.hidden_size, config.head_dim
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.q_proj_weight = _normal((h, self.num_heads * hd), config, device,
                                     gen)
        self.k_proj_weight = _normal((h, self.num_kv_heads * hd), config,
                                     device, gen)
        self.v_proj_weight = _normal((h, self.num_kv_heads * hd), config,
                                     device, gen)
        self.o_proj_weight = _normal((self.num_heads * hd, h), config, device,
                                     gen)

    def _qkv(self, x):
        b, s, _ = x.shape
        hd = self.config.head_dim
        q = (x @ self.q_proj_weight).reshape(b, s, -1, hd)
        k = (x @ self.k_proj_weight).reshape(b, s, -1, hd)
        v = (x @ self.v_proj_weight).reshape(b, s, -1, hd)
        return q, k, v

    def forward(self, hidden, cos, sin):
        b, s, _ = hidden.shape
        q, k, v = self._qkv(hidden)
        q, k = apply_rotary_pos_emb(q, k, cos, sin)
        out = _attention(q, k, v)
        return out.reshape(b, s, -1) @ self.o_proj_weight

    def paged_decode_step(self, x, cos, sin, k_pages, v_pages, tables, pos):
        """Paged-KV chunk step at absolute positions [pos, pos+s) for every
        row. Prefill chunks (s > 1, pos == 0) run causal flash attention
        over the chunk; single-token steps run the paged decode kernel over
        the whole cache. K/V always scatter into the pages (in place).
        Returns (out, k_pages, v_pages)."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        q, k = apply_rotary_pos_emb(q, k, cos, sin)
        dev = x.device
        seq_ids = torch.arange(b, device=dev).repeat_interleave(s)
        positions = (pos + torch.arange(s, device=dev)).repeat(b)
        k_pages, v_pages = append_paged_kv(
            k_pages, v_pages, k.reshape(b * s, self.num_kv_heads, -1),
            v.reshape(b * s, self.num_kv_heads, -1), tables, positions,
            seq_ids)
        if s == 1:
            ctx = torch.full((b,), pos + 1, dtype=torch.int32, device=dev)
            out = paged_decode_attention(q[:, 0], k_pages, v_pages, tables,
                                         ctx)[:, None]
        else:
            out = flash_attention(q, k, v, causal=True)
        return out.reshape(b, s, -1) @ self.o_proj_weight, k_pages, v_pages

    def paged_token_step(self, x, cos, sin, k_pages, v_pages, tables,
                         pos_vec):
        """ONE token per row at PER-ROW positions (continuous batching).
        x: [b, 1, h]; cos/sin [b, 1, d]; pos_vec [b] int32."""
        b = x.shape[0]
        q, k, v = self._qkv(x)
        q, k = apply_rotary_pos_emb(q, k, cos, sin)
        k_pages, v_pages = append_paged_kv(k_pages, v_pages, k[:, 0],
                                           v[:, 0], tables, pos_vec)
        out = paged_decode_attention(q[:, 0], k_pages, v_pages, tables,
                                     (pos_vec + 1).to(torch.int32))
        return out.reshape(b, 1, -1) @ self.o_proj_weight, k_pages, v_pages


def _attention(q, k, v):
    """Causal attention on [b, s, h, d] tensors: the single-device branch
    of the JAX package's ``_attention`` (flash attention)."""
    return flash_attention(q, k, v, causal=True)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj_weight = _normal((h, m), config, device, gen)
        self.up_proj_weight = _normal((h, m), config, device, gen)
        self.down_proj_weight = _normal((m, h), config, device, gen)

    def forward(self, x):
        act = F.silu(x @ self.gate_proj_weight) * (x @ self.up_proj_weight)
        return act @ self.down_proj_weight


class LlamaRMSNorm(nn.Module):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        self.eps = config.rms_norm_eps
        self.weight = nn.Parameter(
            torch.ones(config.hidden_size, dtype=resolve_dtype(config.dtype),
                       device=device))

    def forward(self, x):
        dt = x.dtype
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)).to(dt) * self.weight


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        if config.num_experts > 1:
            raise NotImplementedError(
                "MoE layers (num_experts > 1) are not ported yet: they "
                "arrive with the MoE slice (grouped-matmul kernels K5/K6)")
        self.config = config
        self.input_layernorm = LlamaRMSNorm(config, device)
        self.self_attn = LlamaAttention(config, device, gen)
        self.post_attention_layernorm = LlamaRMSNorm(config, device)
        self.mlp = LlamaMLP(config, device, gen)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))

    def paged_decode_step(self, x, cos, sin, k_pages, v_pages, tables, pos):
        a, k_pages, v_pages = self.self_attn.paged_decode_step(
            self.input_layernorm(x), cos, sin, k_pages, v_pages, tables, pos)
        x = x + a
        return x + self.mlp(self.post_attention_layernorm(x)), k_pages, v_pages

    def paged_token_step(self, x, cos, sin, k_pages, v_pages, tables,
                         pos_vec):
        a, k_pages, v_pages = self.self_attn.paged_token_step(
            self.input_layernorm(x), cos, sin, k_pages, v_pages, tables,
            pos_vec)
        x = x + a
        return x + self.mlp(self.post_attention_layernorm(x)), k_pages, v_pages


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        if config.recompute:
            raise NotImplementedError(
                "recompute=True (remat, remat_policy_of) is not ported yet: "
                "it arrives with the remat slice (torch.utils.checkpoint "
                "saving flash_out/flash_lse); use recompute=False")
        self.config = config
        self.embed_tokens_weight = _normal(
            (config.vocab_size, config.hidden_size), config, device, gen)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, device, gen)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config, device)
        # rope tables per (length, dtype, device): the same values
        # _rope_cos_sin recomputes, kept off the per-token decode path
        self._rope: Dict[tuple, tuple] = {}

    def rope_tables(self, seq_len: int, dtype, device):
        key = (seq_len, dtype, device)
        tables = self._rope.get(key)
        if tables is None:
            cfg = self.config
            tables = self._rope[key] = _rope_cos_sin(
                seq_len, cfg.head_dim, cfg.rope_theta, dtype, device)
        return tables

    def embed(self, ids):
        return self.embed_tokens_weight[ids.long()]

    def forward(self, input_ids):
        x = self.embed(input_ids)
        cos, sin = self.rope_tables(input_ids.shape[1], x.dtype, x.device)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x)


def _decode_model_paged(model: LlamaModel, ids, caches, pos):
    """Paged-KV chunk decode: caches = {"kv": [(k_pages, v_pages)] per
    layer, "tables": [b, pages_per_seq]}; ids [b, s] at absolute positions
    [pos, pos+s)."""
    x = model.embed(ids)
    tables = caches["tables"]
    page = caches["kv"][0][0].shape[2]
    max_len = tables.shape[1] * page
    cos_full, sin_full = model.rope_tables(max_len, x.dtype, x.device)
    s = ids.shape[1]
    cos = cos_full[pos:pos + s]
    sin = sin_full[pos:pos + s]
    new_kv = []
    for layer, (kp, vp) in zip(model.layers, caches["kv"]):
        x, kp, vp = layer.paged_decode_step(x, cos, sin, kp, vp, tables, pos)
        new_kv.append((kp, vp))
    return model.norm(x), {"kv": new_kv, "tables": tables}


class LlamaForCausalLM(GenerationMixin, nn.Module):
    """Llama causal LM on ``device`` (default: the CUDA device; raises
    without one unless ``device="cpu"``), weights drawn from a normal of
    ``config.initializer_range`` with a ``torch.Generator`` seeded by
    ``seed``."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.config = config
        self.model = LlamaModel(config, dev, gen)
        if config.tie_word_embeddings:
            self.register_parameter("lm_head_weight", None)
        else:
            self.lm_head_weight = _normal(
                (config.hidden_size, config.vocab_size), config, dev, gen)

    def _lm_head_w(self):
        """[hidden, vocab] projection — tied embedding transpose or lm_head."""
        if self.lm_head_weight is None:
            return self.model.embed_tokens_weight.T
        return self.lm_head_weight

    def logits(self, hidden):
        return hidden @ self._lm_head_w()

    def forward(self, input_ids, labels=None):
        """Logits [b, s, vocab] in the model dtype; with ``labels``, the
        unfused shifted cross-entropy of those logits (fp32 scalar)."""
        logits = self.logits(self.model(input_ids))
        if labels is None:
            return logits
        return LlamaPretrainingCriterion.compute(logits, labels)

    def loss_fn(self, input_ids, labels):
        """The training loss (``Engine.step`` differentiates it)."""
        return self._lm_loss(self.model(input_ids), labels)

    def _lm_loss(self, hidden, labels):
        """Shifted CE from final hidden states; fused and chunked by
        default."""
        if self.config.fused_ce:
            return fused_linear_cross_entropy(
                hidden, self._lm_head_w(), labels,
                chunk=self.config.fused_ce_chunk)
        return LlamaPretrainingCriterion.compute(self.logits(hidden), labels)

    @torch.no_grad()
    def paged_token_step(self, toks, caches, pos_vec):
        """Continuous-batching hook: ONE token per row at per-row positions.
        toks [b] int, pos_vec [b] int32, caches from _init_paged_caches.
        Inactive rows arrive at pos_vec == 0 over their own slot's pages;
        their logits are computed and ignored. Returns (logits [b, vocab]
        fp32, caches)."""
        model = self.model
        x = model.embed(toks[:, None])
        tables = caches["tables"]
        page = caches["kv"][0][0].shape[2]
        max_len = tables.shape[1] * page
        cos_full, sin_full = model.rope_tables(max_len, x.dtype, x.device)
        posc = pos_vec.long().clamp(0, max_len - 1)
        cos = cos_full[posc][:, None, :]
        sin = sin_full[posc][:, None, :]
        new_kv = []
        for layer, (kp, vp) in zip(model.layers, caches["kv"]):
            x, kp, vp = layer.paged_token_step(x, cos, sin, kp, vp, tables,
                                               pos_vec)
            new_kv.append((kp, vp))
        hidden = model.norm(x)
        logits = self.logits(hidden[:, -1:])
        return logits[:, -1].float(), {"kv": new_kv, "tables": tables}

    @torch.no_grad()
    def _decode_chunk(self, ids, caches, pos, pad_bias, pos_offset):
        """Run a chunk at absolute positions [pos, pos+s) through the paged
        cache; returns (last-position logits [b, vocab] fp32, caches). Only
        the paged serving branch is ported (no left padding)."""
        if not isinstance(caches, dict):
            raise NotImplementedError(
                "dense-cache decoding arrives with the dense-generation "
                "slice; this port serves through paged caches")
        if pad_bias is not None or pos_offset is not None:
            raise ValueError("the paged path does not take left padding")
        hidden, caches = _decode_model_paged(self.model, ids, caches, pos)
        # lm head only on the position we sample from
        logits = self.logits(hidden[:, -1:])
        return logits[:, -1].float(), caches


class LlamaPretrainingCriterion(nn.Module):
    """Shifted causal-LM cross entropy with an fp32 softmax."""

    @staticmethod
    def compute(logits, labels, ignore_index: int = -100):
        lg = logits[:, :-1, :].float()
        lb = labels[:, 1:].long()
        logz = torch.logsumexp(lg, dim=-1)
        mask = lb != ignore_index
        picked = lg.gather(-1, torch.where(mask, lb, 0)[..., None])[..., 0]
        nll = torch.where(mask, logz - picked, 0.0)
        return nll.sum() / mask.sum().float().clamp_min(1.0)

    def forward(self, prediction_scores, masked_lm_labels):
        return self.compute(prediction_scores, masked_lm_labels)
