"""GPT for serving and training, in PyTorch — port of
``paddle_tpu/models/gpt/modeling.py`` (pre-LN GPT-2/3: learned positions,
LayerNorm, a tanh-GELU MLP, multi-head attention with one fused qkv
projection; the lm head is the word embedding, tied).

Parameter names and ``[in, out]`` layouts are the JAX package's, so a JAX
``state_dict()`` loads as it is (:func:`paddle_tpu_torch.weights.
load_jax_state`); the tied embedding ``gpt.wte`` is one parameter, which
the lm head reads as ``wte.T``.

Attention takes the shared routing (:func:`.._common._attention`):
the training and dense forward run ``ops.flash_attention`` causal (K1, and
K2/K3 for gradients), or the dense ``_xla_attention`` with
``use_flash_attention=False``. The serving hooks run K1 on a legacy
prefill and the paged decode kernel K4 on every token step; the dense
generation cache (``decode_step``) and the prefix-cache chunk
(``ops.paged_prefill_attention``) are plain tensor ops, as in the JAX
package. q, k and v are views of the fused ``[b, s, 3h]`` product: K1
takes them as they are, K4 gets q as a contiguous copy.

LayerNorm follows the JAX package's rounding: it normalises in fp32 (the
population variance), casts to the activation dtype, then multiplies the
weight and adds the bias in that dtype. Positions past the table are
clipped on the device (a fused engine's parked rows, a final prefill
chunk's pad rows), so a captured step reads no host value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device, resolve_dtype
from ...nn.functional.flash_attention import _xla_attention
from ...ops.flash_attention import flash_attention
from ...ops.paged_attention import (append_paged_kv, paged_decode_attention,
                                    paged_prefill_attention)
from .._common import _attention, _layer_norm, _normal
from ..generation_utils import GenerationMixin, causal_cache_bias
from ..llama.modeling import LlamaPretrainingCriterion


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768,
                 intermediate_size=None, num_hidden_layers=12,
                 num_attention_heads=12, max_position_embeddings=1024,
                 layer_norm_eps=1e-5, initializer_range=0.02,
                 dtype="float32", recompute=False, use_flash_attention=True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.layer_norm_eps = layer_norm_eps
        self.initializer_range = initializer_range
        self.dtype = dtype
        self.recompute = recompute
        self.use_flash_attention = use_flash_attention

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **over):
        """Small config for tests (the JAX package's ``tiny``; head_dim 16,
        which the kernels do not take: a CPU config)."""
        d = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=128)
        d.update(over)
        return cls(**d)


def _zeros(n, config, device):
    return nn.Parameter(torch.zeros(n, dtype=resolve_dtype(config.dtype),
                                    device=device))


class GPTLayerNorm(nn.Module):
    def __init__(self, config: GPTConfig, device):
        super().__init__()
        self.eps = config.layer_norm_eps
        self.weight = nn.Parameter(torch.ones(
            config.hidden_size, dtype=resolve_dtype(config.dtype),
            device=device))
        self.bias = _zeros(config.hidden_size, config, device)

    def forward(self, x):
        return _layer_norm(x, self.weight, self.bias, self.eps)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device, gen):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.qkv_weight = _normal((h, 3 * h), config, device, gen)
        self.qkv_bias = _zeros(3 * h, config, device)
        self.out_weight = _normal((h, h), config, device, gen)
        self.out_bias = _zeros(h, config, device)

    def _qkv(self, x):
        """q, k, v [b, s, heads, d]: views of the one fused product."""
        b, s, h = x.shape
        qkv = x @ self.qkv_weight + self.qkv_bias
        return tuple(t.reshape(b, s, self.num_heads, -1)
                     for t in qkv.split(h, dim=-1))

    def _out(self, out):
        b, s = out.shape[:2]
        return out.reshape(b, s, -1) @ self.out_weight + self.out_bias

    def forward(self, hidden):
        q, k, v = self._qkv(hidden)
        return self._out(_attention(q, k, v, self.config))

    def decode_step(self, x, k_cache, v_cache, pos, pad_bias=None):
        """Dense KV-cache attention for generation, prefill and decode
        (:74): the chunk's k/v written into the [b, max_len, heads, d]
        caches in place at [pos, pos + s), then attention over the whole
        cache with the causal and left-pad bias."""
        q, k, v = self._qkv(x)
        s = x.shape[1]
        k_cache[:, pos:pos + s] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + s] = v.to(v_cache.dtype)
        bias = causal_cache_bias(k_cache, pos, s, pad_bias)
        out = _xla_attention(q, k_cache, v_cache, bias=bias, causal=False)
        return self._out(out), k_cache, v_cache

    def _append(self, k, v, k_pages, v_pages, tables, positions, seq_ids):
        n = k.shape[0] * k.shape[1]
        return append_paged_kv(k_pages, v_pages,
                               k.reshape(n, self.num_heads, -1),
                               v.reshape(n, self.num_heads, -1), tables,
                               positions, seq_ids)

    def paged_decode_step(self, x, k_pages, v_pages, tables, pos):
        """Paged-KV chunk at positions [pos, pos + s) for every row (:97):
        k/v scatter into the pages, then causal flash attention over the
        chunk (s > 1) or the paged decode kernel over the cache."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        dev = x.device
        seq_ids = torch.arange(b, device=dev).repeat_interleave(s)
        positions = (pos + torch.arange(s, device=dev)).repeat(b)
        k_pages, v_pages = self._append(k, v, k_pages, v_pages, tables,
                                        positions, seq_ids)
        if s == 1:
            ctx = torch.full((b,), pos + 1, dtype=torch.int32, device=dev)
            out = paged_decode_attention(q[:, 0].contiguous(), k_pages,
                                         v_pages, tables, ctx)[:, None]
        else:
            out = flash_attention(q, k, v, causal=True)
        return self._out(out), k_pages, v_pages

    def paged_prefill_chunk(self, x, k_pages, v_pages, tables, starts):
        """Prefill chunk at per-row absolute offsets over cached history
        (:125): appends clipped to the table's extent, then attention over
        the gathered table with an absolute-position mask."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        dev = x.device
        max_len = tables.shape[1] * k_pages.shape[2]
        seq_ids = torch.arange(b, device=dev).repeat_interleave(s)
        positions = (starts.to(dev).long()[:, None]
                     + torch.arange(s, device=dev)).clamp(0, max_len - 1)
        k_pages, v_pages = self._append(k, v, k_pages, v_pages, tables,
                                        positions.reshape(-1), seq_ids)
        out = paged_prefill_attention(q, k_pages, v_pages, tables, starts)
        return self._out(out), k_pages, v_pages

    def paged_token_step(self, x, k_pages, v_pages, tables, pos_vec):
        """One token per row at per-row positions (:152)."""
        q, k, v = self._qkv(x)
        k_pages, v_pages = append_paged_kv(k_pages, v_pages, k[:, 0],
                                           v[:, 0], tables, pos_vec)
        out = paged_decode_attention(q[:, 0].contiguous(), k_pages, v_pages,
                                     tables, (pos_vec + 1).to(torch.int32))
        return self._out(out[:, None]), k_pages, v_pages


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device, gen):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.fc_weight = _normal((h, m), config, device, gen)
        self.fc_bias = _zeros(m, config, device)
        self.proj_weight = _normal((m, h), config, device, gen)
        self.proj_bias = _zeros(h, config, device)

    def forward(self, x):
        # jax.nn.gelu's default is the tanh approximation
        a = F.gelu(x @ self.fc_weight + self.fc_bias, approximate="tanh")
        return a @ self.proj_weight + self.proj_bias


class GPTDecoderLayer(nn.Module):
    def __init__(self, config: GPTConfig, device, gen):
        super().__init__()
        self.ln_1 = GPTLayerNorm(config, device)
        self.attn = GPTAttention(config, device, gen)
        self.ln_2 = GPTLayerNorm(config, device)
        self.mlp = GPTMLP(config, device, gen)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))

    def _hook(self, name, x, *args):
        """Run the attention hook ``name`` on ln_1(x), then the MLP block;
        returns (x, k, v caches)."""
        a, kc, vc = getattr(self.attn, name)(self.ln_1(x), *args)
        x = x + a
        return x + self.mlp(self.ln_2(x)), kc, vc

    def decode_step(self, x, k_cache, v_cache, pos, pad_bias=None):
        return self._hook("decode_step", x, k_cache, v_cache, pos, pad_bias)

    def paged_decode_step(self, x, k_pages, v_pages, tables, pos):
        return self._hook("paged_decode_step", x, k_pages, v_pages, tables,
                          pos)

    def paged_token_step(self, x, k_pages, v_pages, tables, pos_vec):
        return self._hook("paged_token_step", x, k_pages, v_pages, tables,
                          pos_vec)

    def paged_prefill_chunk(self, x, k_pages, v_pages, tables, starts):
        return self._hook("paged_prefill_chunk", x, k_pages, v_pages, tables,
                          starts)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device, gen):
        super().__init__()
        self.config = config
        self.wte = _normal((config.vocab_size, config.hidden_size), config,
                           device, gen)
        self.wpe = _normal((config.max_position_embeddings,
                            config.hidden_size), config, device, gen)
        self.layers = nn.ModuleList([GPTDecoderLayer(config, device, gen)
                                     for _ in range(config.num_hidden_layers)])
        self.ln_f = GPTLayerNorm(config, device)

    def embed(self, ids, positions):
        """Token plus learned position embeddings; ``positions`` indexes
        ``wpe`` (a slice or a tensor broadcast against ids)."""
        return self.wte[ids.long()] + self.wpe[positions]

    def forward(self, input_ids):
        x = self.embed(input_ids, slice(0, input_ids.shape[1]))
        # remat only while autograd records, as JAX applies it only under
        # tracing (:292): every layer checkpointed whole (no policy)
        remat = self.config.recompute and torch.is_grad_enabled()
        for layer in self.layers:
            x = (checkpoint(layer, x, use_reentrant=False) if remat
                 else layer(x))
        return self.ln_f(x)

    def run_layers(self, name, x, caches, *args):
        """``layer.<name>`` over every layer with its (k, v) pair of
        ``caches``; returns (ln_f(x), the new pairs)."""
        pairs = []
        for layer, (kc, vc) in zip(self.layers, caches):
            x, kc, vc = getattr(layer, name)(x, kc, vc, *args)
            pairs.append((kc, vc))
        return self.ln_f(x), pairs


class GPTForCausalLM(GenerationMixin, nn.Module):
    """GPT causal LM on ``device`` (default: the CUDA device; raises
    without one unless ``device="cpu"``), weights drawn from a normal of
    ``config.initializer_range`` with a ``torch.Generator`` seeded by
    ``seed``; biases zero, norm gains one."""

    def __init__(self, config: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.config = config
        self.gpt = GPTModel(config, dev, gen)

    def logits(self, hidden):
        """The tied lm head: hidden @ wte.T, in the model dtype."""
        return hidden @ self.gpt.wte.T

    def forward(self, input_ids, labels=None):
        """Logits [b, s, vocab] in the model dtype; with ``labels``, the
        shifted cross-entropy of those logits (:307-315; JAX's GPT has no
        fused CE)."""
        logits = self.logits(self.gpt(input_ids))
        if labels is None:
            return logits
        return LlamaPretrainingCriterion.compute(logits, labels)

    def loss_fn(self, input_ids, labels):
        return self.forward(input_ids, labels)

    # ---- generation and serving hooks ----
    def _validate_generate(self, prompt_len, total_len):
        if total_len > self.config.max_position_embeddings:
            raise ValueError(
                f"GPT learned position table holds "
                f"{self.config.max_position_embeddings} positions; prompt + "
                f"max_new_tokens = {total_len} exceeds it")

    def _positions(self, starts, s, device):
        """[b, s] positions ``starts[b] + i``, clipped to the table."""
        return (starts.to(device).long()[:, None]
                + torch.arange(s, device=device)).clamp(
                    0, self.config.max_position_embeddings - 1)

    @torch.no_grad()
    def paged_token_step(self, toks, caches, pos_vec):
        """Continuous-batching hook (:329): one token per row at per-row
        positions; parked rows arrive at position 0 over a parking page.
        Returns (logits [b, vocab] fp32, caches)."""
        x = self.gpt.embed(toks[:, None], self._positions(pos_vec, 1,
                                                          toks.device))
        hidden, kv = self.gpt.run_layers("paged_token_step", x,
                                         caches["kv"], caches["tables"],
                                         pos_vec)
        logits = self.logits(hidden[:, -1])
        return logits.float(), {"kv": kv, "tables": caches["tables"]}

    @torch.no_grad()
    def paged_prefill_chunk(self, ids, caches, starts):
        """Serving hook (:349): one prefill chunk per row at per-row
        absolute offsets over cached history; returns the caches. Rows may
        share one sequence's table at different starts (packed prefill):
        every layer appends all rows' k/v before any row gathers."""
        x = self.gpt.embed(ids, self._positions(starts, ids.shape[1],
                                                ids.device))
        _, kv = self.gpt.run_layers("paged_prefill_chunk", x, caches["kv"],
                                    caches["tables"], starts)
        return {"kv": kv, "tables": caches["tables"]}

    @torch.no_grad()
    def paged_verify_step(self, toks, caches, pos_vec):
        """Speculative-decode verify hook (:368): a K+1-token window per
        row at positions ``pos_vec[b] + i`` through the chunk layers, with
        logits [b, s, vocab] fp32 at every window position."""
        x = self.gpt.embed(toks, self._positions(pos_vec, toks.shape[1],
                                                 toks.device))
        hidden, kv = self.gpt.run_layers("paged_prefill_chunk", x,
                                         caches["kv"], caches["tables"],
                                         pos_vec)
        return self.logits(hidden).float(), {"kv": kv,
                                             "tables": caches["tables"]}

    @torch.no_grad()
    def _decode_chunk(self, ids, caches, pos, pad_bias, pos_offset):
        """A chunk at absolute positions [pos, pos + s) through the cache
        (:389): paged (a dict; no left padding) or dense (a list, with the
        left-pad bias and each row's position offset, clipped to the
        table). Returns (last-position logits [b, vocab] fp32, caches)."""
        s = ids.shape[1]
        if pos_offset is None:
            positions = slice(pos, pos + s)
        else:
            positions = (pos + torch.arange(s, device=ids.device)[None, :]
                         - pos_offset.to(ids.device).long()[:, None]
                         ).clamp(0, self.config.max_position_embeddings - 1)
        x = self.gpt.embed(ids, positions)
        if isinstance(caches, dict):
            if pad_bias is not None or pos_offset is not None:
                raise ValueError("the paged path does not take left padding")
            hidden, kv = self.gpt.run_layers("paged_decode_step", x,
                                             caches["kv"], caches["tables"],
                                             pos)
            caches = {"kv": kv, "tables": caches["tables"]}
        else:
            hidden, caches = self.gpt.run_layers("decode_step", x, caches,
                                                 pos, pad_bias)
        return self.logits(hidden[:, -1]).float(), caches
