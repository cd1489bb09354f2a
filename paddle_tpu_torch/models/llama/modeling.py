"""Llama for serving and training, in PyTorch — port of
``paddle_tpu/models/llama/modeling.py``.

Parameter names and layouts are the JAX package's: every projection is an
``[in, out]`` matrix and the model computes ``x @ W``, so a JAX
``state_dict()`` loads with no transposes (:func:`paddle_tpu_torch.weights.
load_jax_state`). Attention runs through the port's kernels: causal prefill
through ``ops.flash_attention`` and paged decode through
``ops.paged_decode_attention``; projections, the MLP and the lm head are
plain ``torch.matmul``, as the JAX package leaves them to XLA. With
``use_flash_attention=False`` the training and dense forward take the
dense ``_xla_attention`` (plain tensor ops on either device) in place of
the flash kernels, as the JAX package's ``_attention`` does; the serving
hooks keep theirs.

bf16 rounding follows the JAX package: rope tables are computed in fp32 and
cast to the activation dtype, RMSNorm normalises in fp32, casts back, then
multiplies the weight in the activation dtype, and logits come from a
model-dtype matmul cast to fp32.

Parameters are trainable (``requires_grad=True``, as the JAX package's
are): ``loss_fn`` computes the shifted causal-LM loss through the fused,
chunked cross-entropy (``ops.fused_ce``) and ``forward(ids, labels)`` the
unfused criterion; gradients flow through the flash kernels' backward
(K2/K3). The serving hooks (``_decode_chunk``, ``paged_token_step``,
``paged_prefill_chunk``, ``paged_verify_step``) run under
``torch.no_grad()`` and build no graph; they take fp pools or int8
``QuantizedKVPool`` pools alike.

With ``num_experts > 1`` each layer's MLP is the Mixtral-class MoE layer
(``incubate.distributed.models.moe.MoELayer`` over ``SwiGLUExpertFFN``,
any of its dispatches: ``auto`` picks ``einsum`` or ``scatter``; ``ragged``
and ``pgmm`` run the grouped matmuls K5/K6) and ``loss_fn`` adds
``moe_aux_weight`` times the layers' summed load-balance loss, which each
layer returns as an output (never through the gate's side channel). The
serving and generation hooks run the MoE layer too, and drop its aux loss
(:meth:`LlamaDecoderLayer.ffn`).

Generation (``GenerationMixin.generate``) runs ``_decode_chunk`` over a
dense cache (``decode_step``: the chunk's k/v written into ``[b, max_len,
kv_heads, d]`` caches in place, then attention over the whole cache with
the causal and left-pad bias, in plain tensor ops as the JAX package's XLA
attention computes it) or over a paged one (``_decode_model_paged``: K1 for
the prompt, K4 for each token).

Remat (``recompute=True``, ``remat_policy``, ``remat_every``; :519-575):
while autograd records, layer ``i`` with ``i % remat_every == 0`` runs
under ``torch.utils.checkpoint``: ``flash`` saves the flash forward op's
outputs (the selective policy :func:`remat_policy_of` builds),
``flash_qkv`` also the rope'd q/k/v, ``flash_mlp`` also the swiglu
product, ``full`` nothing. q/k/v and the swiglu product are kept by where
:func:`_remat` cuts the checkpointed region, not by the policy: the ops in
front of a region's inputs run outside it, and the ops behind a region's
outputs too, so autograd keeps those tensors and never runs their ops
again (``torch.utils.checkpoint`` replays every op of a region that its
policy does not save). Explicit generators that a layer draws noise from
(``SwitchGate``'s jitter) are rewound for the recompute, so it sees the
forward's noise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from ...device import resolve_device, resolve_dtype
from ...distributed.auto_parallel.logical_sharding import (annotate,
                                                           constrain,
                                                           gather_fsdp)
from ...incubate.distributed.models.moe import MoELayer, SwiGLUExpertFFN
from ...nn.functional.flash_attention import _xla_attention
from ...ops.flash_attention import flash_attention
from ...ops.fused_ce import (fused_linear_cross_entropy,
                             fused_linear_cross_entropy_parts)
from ...ops.paged_attention import (append_paged_kv, paged_decode_attention,
                                    paged_prefill_attention)
from .._common import _attention, _normal, _replaying, mesh_matmul
from ..generation_utils import GenerationMixin, causal_cache_bias


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
        use_flash_attention: bool = True,
        sequence_parallel: bool = False,
        num_experts: int = 1,
        moe_topk: int = 2,
        moe_dispatch: str = "auto",
        moe_gate: str = "gshard",
        moe_aux_weight: float = 0.01,
        moe_capacity_factor: float = 1.25,
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
        self.use_flash_attention = use_flash_attention
        self.sequence_parallel = sequence_parallel
        self.num_experts = num_experts
        self.moe_topk = moe_topk
        self.moe_dispatch = moe_dispatch
        self.moe_gate = moe_gate
        self.moe_aux_weight = moe_aux_weight
        self.moe_capacity_factor = moe_capacity_factor
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


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        self.config = config
        h, hd = config.hidden_size, config.head_dim
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.q_proj_weight = annotate(_normal(
            (h, self.num_heads * hd), config, device, gen), "embed", "heads")
        self.k_proj_weight = annotate(_normal(
            (h, self.num_kv_heads * hd), config, device, gen),
            "embed", "heads")
        self.v_proj_weight = annotate(_normal(
            (h, self.num_kv_heads * hd), config, device, gen),
            "embed", "heads")
        self.o_proj_weight = annotate(_normal(
            (self.num_heads * hd, h), config, device, gen), "heads", "embed")

    def _qkv(self, x):
        hd = self.config.head_dim
        q = _split_heads(mesh_matmul(x, gather_fsdp(self.q_proj_weight)), hd)
        k = _split_heads(mesh_matmul(x, gather_fsdp(self.k_proj_weight)), hd)
        v = _split_heads(mesh_matmul(x, gather_fsdp(self.v_proj_weight)), hd)
        return q, k, v

    def forward(self, hidden, cos, sin):
        return self.attend(*self.qkv_heads(hidden, cos, sin))

    def qkv_heads(self, hidden, cos, sin):
        """The rope'd heads q, k, v [b, s, heads, d]: what the JAX package
        names ``attn_q/k/v`` (:182-189). Under a mesh the input is whole
        over the sequence first (Megatron-SP's all-gather into the
        projections) and the heads sharded by their logical axes."""
        q, k, v = self._qkv(constrain(hidden, "batch", "seq", "embed"))
        q = constrain(q, "batch", "seq", "heads", "head_dim")
        k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
        v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
        q, k = apply_rotary_pos_emb(q, k, cos, sin)
        return q, k, v

    def attend(self, q, k, v):
        """Causal attention over the heads, then the output projection
        (under a mesh: its partial sums reduced to the residual stream's
        placements)."""
        out = mesh_matmul(_merge_heads(_attention(q, k, v, self.config)),
                          gather_fsdp(self.o_proj_weight))
        return constrain(out, *_resid_axes(self.config))

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

    def decode_step(self, x, cos, sin, k_cache, v_cache, pos,
                    pad_bias=None):
        """Dense KV-cache attention for generation, prefill and decode
        (:196-221). x [b, s, h] holds the chunk at absolute positions
        [pos, pos + s); caches [b, max_len, kv_heads, d], written in place
        at those positions; cos/sin [s, d] or per row [b, s, d];
        ``pad_bias`` [b, 1, 1, max_len] masks left-pad columns. Returns
        (out, k_cache, v_cache)."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        q, k = apply_rotary_pos_emb(q, k, cos, sin)
        k_cache[:, pos:pos + s] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + s] = v.to(v_cache.dtype)
        bias = causal_cache_bias(k_cache, pos, s, pad_bias)
        out = _xla_attention(q, k_cache, v_cache, bias=bias)
        return out.reshape(b, s, -1) @ self.o_proj_weight, k_cache, v_cache

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

    def paged_prefill_chunk(self, x, cos, sin, k_pages, v_pages, tables,
                            starts):
        """Prefill CHUNK at PER-ROW absolute offsets over cached history
        (prefix-cache serving). x [b, s, h]: row b holds the tokens at
        positions [starts[b], starts[b] + s); cos/sin [b, s, d]. The chunk's
        k/v scatter into the pages first (positions clipped to the table's
        extent, as in the JAX package: a final chunk's pad rows land past
        the prompt, masked and later overwritten), then attention gathers
        the whole table with an absolute-position mask."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        q, k = apply_rotary_pos_emb(q, k, cos, sin)
        dev = x.device
        max_len = tables.shape[1] * k_pages.shape[2]
        seq_ids = torch.arange(b, device=dev).repeat_interleave(s)
        positions = (starts.to(dev).long()[:, None]
                     + torch.arange(s, device=dev)).clamp(0, max_len - 1)
        k_pages, v_pages = append_paged_kv(
            k_pages, v_pages, k.reshape(b * s, self.num_kv_heads, -1),
            v.reshape(b * s, self.num_kv_heads, -1), tables,
            positions.reshape(-1), seq_ids)
        out = paged_prefill_attention(q, k_pages, v_pages, tables, starts)
        return out.reshape(b, s, -1) @ self.o_proj_weight, k_pages, v_pages


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.config = config
        self.gate_proj_weight = annotate(
            _normal((h, m), config, device, gen), "embed", "mlp")
        self.up_proj_weight = annotate(
            _normal((h, m), config, device, gen), "embed", "mlp")
        self.down_proj_weight = annotate(
            _normal((m, h), config, device, gen), "mlp", "embed")

    def forward(self, x):
        return self.down(self.act(x))

    def down(self, act):
        return constrain(mesh_matmul(act, gather_fsdp(self.down_proj_weight)),
                         *_resid_axes(self.config))

    def act(self, x):
        """The swiglu product, what the JAX package names ``mlp_act``
        (:387-388)."""
        x = constrain(x, "batch", "seq", "embed")
        act = (F.silu(mesh_matmul(x, gather_fsdp(self.gate_proj_weight)))
               * mesh_matmul(x, gather_fsdp(self.up_proj_weight)))
        return constrain(act, "batch", "seq", "mlp")


class LlamaRMSNorm(nn.Module):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        self.eps = config.rms_norm_eps
        self.weight = annotate(nn.Parameter(
            torch.ones(config.hidden_size, dtype=resolve_dtype(config.dtype),
                       device=device)), "norm")

    def forward(self, x):
        dt = x.dtype
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)).to(dt) * self.weight


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen, remat=False):
        super().__init__()
        self.config = config
        # checkpointed in training (LlamaModel.forward)
        self.remat = remat
        self.input_layernorm = LlamaRMSNorm(config, device)
        self.self_attn = LlamaAttention(config, device, gen)
        self.post_attention_layernorm = LlamaRMSNorm(config, device)
        if config.num_experts > 1:
            # Mixtral-class MoE FFN: swiglu experts
            self.mlp = MoELayer(
                config.hidden_size, config.num_experts,
                experts=SwiGLUExpertFFN(
                    config.num_experts, config.hidden_size,
                    config.intermediate_size, dtype=config.dtype,
                    initializer_range=config.initializer_range,
                    device=device, generator=gen),
                gate=config.moe_gate, top_k=config.moe_topk,
                capacity_factor=config.moe_capacity_factor,
                dispatch_mode=config.moe_dispatch, device=device,
                generator=gen)
        else:
            self.mlp = LlamaMLP(config, device, gen)

    def forward(self, x, cos, sin):
        return self.forward_with_aux(x, cos, sin)[0]

    def forward_with_aux(self, x, cos, sin):
        """(the layer's output, the MoE layer's aux loss or None). The aux
        is an output (``MoELayer.forward_with_aux``), never read from the
        gate's side channel, so a checkpoint's recompute leaves nothing
        there."""
        q, k, v = self.self_attn.qkv_heads(self.input_layernorm(x), cos, sin)
        return self.forward_from_qkv(x, q, k, v)

    def forward_from_qkv(self, x, q, k, v):
        """:meth:`forward_with_aux` from the rope'd heads on."""
        x = x + self.self_attn.attend(q, k, v)
        h = self.post_attention_layernorm(x)
        if self.config.num_experts > 1:
            y, aux = self.mlp.forward_with_aux(h)
        else:
            y, aux = self.mlp(h), None
        # the residual stream's placements between blocks (:443-449):
        # sequence-sharded over tp under sequence_parallel
        return constrain(x + y, *_resid_axes(self.config)), aux

    def ffn(self, h):
        """The MLP of the serving and generation hooks. An MoE layer's aux
        loss is dropped there, as the JAX engine's programs drop it: it
        goes neither out nor into the gate's side channel, so a step keeps
        no tensor of its own past its end or inside a captured graph."""
        if self.config.num_experts > 1:
            return self.mlp.forward_with_aux(h)[0]
        return self.mlp(h)

    def forward_to_act(self, x, cos, sin):
        """A dense layer up to its swiglu product: (the attention block's
        output x, act); the layer's output is x + act @ down_proj."""
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x, self.mlp.act(self.post_attention_layernorm(x))

    def decode_step(self, x, cos, sin, k_cache, v_cache, pos,
                    pad_bias=None):
        a, k_cache, v_cache = self.self_attn.decode_step(
            self.input_layernorm(x), cos, sin, k_cache, v_cache, pos,
            pad_bias=pad_bias)
        x = x + a
        return x + self.ffn(self.post_attention_layernorm(x)), k_cache, v_cache

    def paged_decode_step(self, x, cos, sin, k_pages, v_pages, tables, pos):
        a, k_pages, v_pages = self.self_attn.paged_decode_step(
            self.input_layernorm(x), cos, sin, k_pages, v_pages, tables, pos)
        x = x + a
        return x + self.ffn(self.post_attention_layernorm(x)), k_pages, v_pages

    def paged_token_step(self, x, cos, sin, k_pages, v_pages, tables,
                         pos_vec):
        a, k_pages, v_pages = self.self_attn.paged_token_step(
            self.input_layernorm(x), cos, sin, k_pages, v_pages, tables,
            pos_vec)
        x = x + a
        return x + self.ffn(self.post_attention_layernorm(x)), k_pages, v_pages

    def paged_prefill_chunk(self, x, cos, sin, k_pages, v_pages, tables,
                            starts):
        a, k_pages, v_pages = self.self_attn.paged_prefill_chunk(
            self.input_layernorm(x), cos, sin, k_pages, v_pages, tables,
            starts)
        x = x + a
        return x + self.ffn(self.post_attention_layernorm(x)), k_pages, v_pages


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        self.config = config
        self.embed_tokens_weight = annotate(_normal(
            (config.vocab_size, config.hidden_size), config, device, gen),
            "vocab_in", "embed")
        # partial remat: layer i is checkpointed iff i % remat_every == 0
        self._remat_policy = remat_policy_of(config)
        every = config.remat_every
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(config, device, gen,
                              remat=config.recompute and i % every == 0)
            for i in range(config.num_hidden_layers)])
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
        if isinstance(ids, DTensor):
            # the table whole over fsdp before the lookup (:505-507)
            return F.embedding(ids, gather_fsdp(self.embed_tokens_weight))
        return self.embed_tokens_weight[ids.long()]

    def embed_and_rope(self, input_ids):
        """The embedded ids and the rope tables [s, d] of their (global)
        positions (Replicate DTensors under a mesh)."""
        x = constrain(self.embed(input_ids), "batch", "seq", "embed")
        cos, sin = self.rope_tables(input_ids.shape[1], x.dtype, x.device)
        if isinstance(x, DTensor):
            cos, sin = (DTensor.from_local(
                t, x.device_mesh, (Replicate(),) * x.device_mesh.ndim,
                run_check=False) for t in (cos, sin))
        return x, cos, sin

    def forward(self, input_ids):
        x, cos, sin = self.embed_and_rope(input_ids)
        # remat only while autograd records, as JAX applies it only under
        # tracing (:522): serving and no_grad forwards never checkpoint
        remat = torch.is_grad_enabled()
        auxes = []
        for layer in self.layers:
            if remat and layer.remat:
                x, aux = _remat(layer, self._remat_policy, x, cos, sin)
            else:
                x, aux = layer.forward_with_aux(x, cos, sin)
            auxes.append(aux)
        if self.config.num_experts > 1:
            self._moe_aux = torch.stack(auxes).sum()
        return self.norm(x)


#: the residuals each remat policy keeps (:549-571); None: keeps nothing
_REMAT_NAMES = {
    "flash": ("flash_out", "flash_lse"),
    # also the rope'd q/k/v heads
    "flash_qkv": ("flash_out", "flash_lse", "attn_q", "attn_k", "attn_v"),
    # also the swiglu product
    "flash_mlp": ("flash_out", "flash_lse", "mlp_act"),
    "full": None,
}


def remat_policy_of(cfg):
    """The selective-checkpoint policy function for ``cfg.remat_policy``,
    or None for 'full' (save nothing). Every ``flash*`` policy saves the
    outputs of the flash forward op ``paddle_tpu_torch::flash_fwd_lse``
    (``flash_out``/``flash_lse`` in the JAX package), so the backward does
    not run K1 again, and recomputes every other op of the region. Its
    ``names`` are the JAX names the policy keeps; :func:`_remat` keeps
    ``attn_q/k/v`` and ``mlp_act`` by where it cuts the region."""
    names = _REMAT_NAMES[getattr(cfg, "remat_policy", "flash")]
    if names is None:
        return None
    flash_op = torch.ops.paddle_tpu_torch.flash_fwd_lse.default

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op is flash_op
                else CheckpointPolicy.PREFER_RECOMPUTE)

    policy.names = frozenset(names)
    return policy


def _remat(layer, policy, x, cos, sin):
    """``layer.forward_with_aux(x, cos, sin)`` under ``torch.utils.
    checkpoint`` (non-reentrant) with ``policy`` (None: save nothing); the
    aux loss is an output of the checkpointed function (:528-539).

    ``attn_q`` among the policy's names: the projections and rope run
    outside the region, which starts at the rope'd heads; autograd keeps
    q/k/v (the region's inputs) and the normed input (the projections'),
    and only the norm is recomputed, in a region of its own. ``mlp_act``
    on a dense layer: the region ends at the swiglu product, and the down
    projection runs outside it. (A MoE layer has no ``mlp_act``, as in the
    JAX package, so 'flash_mlp' is 'flash' there.)"""
    context_fn = noop_context_fn if policy is None else (
        lambda: create_selective_checkpoint_contexts(policy))
    gens = list({id(g): g for g in (getattr(m, "noise_generator", None)
                                    for m in layer.modules())
                 if g is not None}.values())

    def region(fn, *args):
        return checkpoint(_replaying(fn, gens), *args, use_reentrant=False,
                          context_fn=context_fn)

    names = policy.names if policy is not None else ()
    if "attn_q" in names:
        h = checkpoint(layer.input_layernorm, x, use_reentrant=False)
        q, k, v = layer.self_attn.qkv_heads(h, cos, sin)
        return region(layer.forward_from_qkv, x, q, k, v)
    if "mlp_act" in names and layer.config.num_experts <= 1:
        x, act = region(layer.forward_to_act, x, cos, sin)
        return constrain(x + layer.mlp.down(act),
                         *_resid_axes(layer.config)), None
    return region(layer.forward_with_aux, x, cos, sin)


def _decode_model(model: LlamaModel, ids, caches, pos, pad_bias=None,
                  rope_offset=None):
    """Dense-cache chunk decode (:578-607): caches [(k, v)] per layer, each
    [b, max_len, kv_heads, d]; ids [b, s] at absolute positions [pos,
    pos + s). ``pad_bias`` [b, 1, 1, max_len] masks left-pad columns;
    ``rope_offset`` [b] shifts each row's positions (left padding moves a
    row's position 0 to its first real token; pads clip to 0)."""
    x = model.embed(ids)
    max_len = caches[0][0].shape[1]
    cos_full, sin_full = model.rope_tables(max_len, x.dtype, x.device)
    s = ids.shape[1]
    if rope_offset is None:
        cos, sin = cos_full[pos:pos + s], sin_full[pos:pos + s]
    else:
        positions = (pos + torch.arange(s, device=x.device)[None, :]
                     - rope_offset.long()[:, None]).clamp(0, max_len - 1)
        cos, sin = cos_full[positions], sin_full[positions]
    new_caches = []
    for layer, (kc, vc) in zip(model.layers, caches):
        x, kc, vc = layer.decode_step(x, cos, sin, kc, vc, pos,
                                      pad_bias=pad_bias)
        new_caches.append((kc, vc))
    return model.norm(x), new_caches


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
            self.lm_head_weight = annotate(_normal(
                (config.hidden_size, config.vocab_size), config, dev, gen),
                "embed", "vocab")

    def _lm_head_w(self):
        """[hidden, vocab] projection — tied embedding transpose or lm_head."""
        if self.lm_head_weight is None:
            return self.model.embed_tokens_weight.T
        return self.lm_head_weight

    def logits(self, hidden):
        return mesh_matmul(hidden, self._lm_head_w())

    def forward(self, input_ids, labels=None):
        """Logits [b, s, vocab] in the model dtype; with ``labels``, the
        unfused shifted cross-entropy of those logits (fp32 scalar)."""
        logits = self.logits(self.model(input_ids))
        if labels is None:
            return logits
        return LlamaPretrainingCriterion.compute(logits, labels)

    def remat_policy(self):
        """Engine hook (:788-790): the selective-checkpoint policy function
        for this model's blocks (None for 'full')."""
        return remat_policy_of(self.config)

    def moe_aux_loss(self):
        """Sum of the layers' gate load-balance losses from the last
        forward (0 for a dense model), collected as layer outputs: safe
        under recompute."""
        if self.config.num_experts <= 1:
            return 0.0
        return getattr(self.model, "_moe_aux", 0.0)

    def loss_fn(self, input_ids, labels):
        """The training loss (``Engine.step`` differentiates it): the
        shifted CE, plus ``moe_aux_weight`` times the aux loss of an MoE
        model."""
        loss = self._lm_loss(self.model(input_ids), labels)
        if self.config.num_experts > 1:
            loss = loss + self.config.moe_aux_weight * self.moe_aux_loss()
        return loss

    def _lm_loss(self, hidden, labels):
        """Shifted CE from final hidden states; fused and chunked by
        default."""
        if isinstance(hidden, DTensor):
            return _mesh_lm_loss(hidden, self._lm_head_w(), labels,
                                 self.config)
        if self.config.fused_ce:
            return fused_linear_cross_entropy(
                hidden, self._lm_head_w(), labels,
                chunk=self.config.fused_ce_chunk)
        return LlamaPretrainingCriterion.compute(self.logits(hidden), labels)

    # ---- pipeline-parallel protocol (Engine over a pp mesh; :835-880) ----
    @property
    def pipeline_with_aux(self) -> bool:
        """Blocks emit a scalar aux output (MoE gate load-balance loss)."""
        return self.config.num_experts > 1

    def pipeline_blocks(self):
        """The homogeneous block stack the pp dim splits."""
        return list(self.model.layers)

    def pipeline_loss(self, input_ids, labels, run_blocks):
        """The loss with the decoder stack replaced by ``run_blocks(x, cos,
        sin)``: the embedding, final norm and head run outside the
        pipeline, on every stage (replicated over pp). ``run_blocks`` may
        return ``(x, aux)``, the MoE gate loss averaged per microbatch."""
        x, cos, sin = self.model.embed_and_rope(input_ids)
        res = run_blocks(x, cos, sin)
        x, aux = res if isinstance(res, tuple) else (res, None)
        loss = self._lm_loss(self.model.norm(x), labels)
        if aux is not None:
            loss = loss + self.config.moe_aux_weight * aux
        return loss

    def pipeline_block_fn(self, block):
        """``fn(params, x, cos, sin)``: ``block``'s forward with ``params``
        (its parameters' tensors, in ``named_parameters`` order) in place
        of its own (``torch.func.functional_call``; JAX's ``_Swap``); the
        block's own tensors run the block as it is."""
        names = [n for n, _ in block.named_parameters()]
        own = [t for _, t in block.named_parameters()]

        def fn(params, x, cos, sin):
            if len(params) == len(own) and all(
                    a is b for a, b in zip(params, own)):
                return block(x, cos, sin)
            return torch.func.functional_call(
                block, dict(zip(names, params)), (x, cos, sin))

        return fn

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
    def paged_prefill_chunk(self, ids, caches, starts):
        """Serving hook (prefix cache, chunked prefill): prefill ONE chunk
        per row at per-row absolute offsets, attending over the cached
        prefix. ids [b, s] int, starts [b] int; returns the caches (the
        first token comes from a later ``paged_token_step`` re-step, so no
        lm-head work here). Rows may share one sequence's table at
        different starts (packed prefill): each layer appends every row's
        k/v before any row gathers, so a later chunk reads an earlier
        chunk's pages written in the same call."""
        model = self.model
        x = model.embed(ids)
        tables = caches["tables"]
        page = caches["kv"][0][0].shape[2]
        max_len = tables.shape[1] * page
        cos_full, sin_full = model.rope_tables(max_len, x.dtype, x.device)
        s = ids.shape[1]
        positions = (starts.to(x.device).long()[:, None]
                     + torch.arange(s, device=x.device)).clamp(0, max_len - 1)
        cos = cos_full[positions]
        sin = sin_full[positions]
        new_kv = []
        for layer, (kp, vp) in zip(model.layers, caches["kv"]):
            x, kp, vp = layer.paged_prefill_chunk(x, cos, sin, kp, vp,
                                                  tables, starts)
            new_kv.append((kp, vp))
        return {"kv": new_kv, "tables": tables}

    @torch.no_grad()
    def paged_verify_step(self, toks, caches, pos_vec):
        """Speculative-decode verify hook: score a K+1-token window per row
        in one pass. toks [b, s] int, the window [last_token, draft_1 ..
        draft_K] at positions ``pos_vec[b] + i``; returns (logits [b, s,
        vocab] fp32, caches) with the window's k/v appended. The K-wide
        sibling of :meth:`paged_token_step`: the ``paged_prefill_chunk``
        layers (append-then-gather, absolute-position mask, the body of
        ``ops.paged_verify_attention``) and the lm head at every window
        position, so position i's logits are what a token step at that
        position computes from the same cache bytes. Positions are clipped
        to ``max_len - 1`` (torch does not clamp a gather); parked rows
        arrive at ``pos_vec == 0`` over the parking page."""
        model = self.model
        x = model.embed(toks)
        tables = caches["tables"]
        page = caches["kv"][0][0].shape[2]
        max_len = tables.shape[1] * page
        cos_full, sin_full = model.rope_tables(max_len, x.dtype, x.device)
        s = toks.shape[1]
        positions = (pos_vec.long()[:, None]
                     + torch.arange(s, device=x.device)).clamp(0, max_len - 1)
        cos = cos_full[positions]
        sin = sin_full[positions]
        new_kv = []
        for layer, (kp, vp) in zip(model.layers, caches["kv"]):
            x, kp, vp = layer.paged_prefill_chunk(x, cos, sin, kp, vp,
                                                  tables, pos_vec)
            new_kv.append((kp, vp))
        logits = self.logits(model.norm(x))
        return logits.float(), {"kv": new_kv, "tables": tables}

    @torch.no_grad()
    def _decode_chunk(self, ids, caches, pos, pad_bias, pos_offset):
        """Run a chunk at absolute positions [pos, pos+s) through the
        cache: paged (a dict from ``_init_paged_caches``; no left padding)
        or dense (a list from ``_init_caches``, with the left-pad bias and
        position offsets). Returns (last-position logits [b, vocab] fp32,
        caches)."""
        if isinstance(caches, dict):
            if pad_bias is not None or pos_offset is not None:
                raise ValueError("the paged path does not take left padding")
            hidden, caches = _decode_model_paged(self.model, ids, caches, pos)
        else:
            hidden, caches = _decode_model(self.model, ids, caches, pos,
                                           pad_bias, pos_offset)
        # lm head only on the position we sample from
        logits = self.logits(hidden[:, -1:])
        return logits[:, -1].float(), caches


def _whole_over_split(t, dim, groups):
    """``t`` made whole over the mesh axes that shard ``dim`` when they do
    not split it at ``groups`` boundaries (heads that do not divide tp):
    DTensor cannot split or merge such a dim in place."""
    if not isinstance(t, DTensor):
        return t
    pl = tuple(t.placements)
    ways = 1
    for i, p in enumerate(pl):
        if p.is_shard(dim):
            ways *= t.device_mesh.size(i)
    if groups % ways == 0:
        return t
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if p.is_shard(dim) else p for p in pl))


def _split_heads(t, hd):
    """[b, s, n * hd] -> [b, s, n, hd]."""
    b, s, width = t.shape
    return _whole_over_split(t, 2, width // hd).reshape(b, s, -1, hd)


def _merge_heads(t):
    """[b, s, n, hd] -> [b, s, n * hd]."""
    b, s, n, _ = t.shape
    return _whole_over_split(t, 2, n).reshape(b, s, -1)


def _resid_axes(config):
    """The residual stream's logical axes (:443-449)."""
    return ("batch", "seq_sp" if config.sequence_parallel else "seq",
            "embed")


def _shift_labels(labels, ignore_index: int = -100):
    """``labels`` shifted left by one position on the global sequence, the
    last position ``ignore_index``: position i then holds the label its
    hidden state predicts. A sequence sharded over a mesh dim takes each
    rank's first column from the next rank along that dim (a
    ``ppermute``), so no pair is lost at a shard boundary."""
    from ...distributed.communication.functional import exchange, mesh_axis

    mesh = labels.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    seq_dims = [n for n, p in zip(names, labels.placements)
                if p.is_shard(1) and mesh.size(names.index(n)) > 1]
    if len(seq_dims) > 1:
        raise ValueError(f"labels sharded over {seq_dims} along the "
                         f"sequence: the shift takes one dim")
    lab = labels.to_local()
    tail = torch.full_like(lab[:, :1], ignore_index)
    if seq_dims:
        axis = mesh_axis(seq_dims[0], mesh)
        nxt = exchange(lab[:, :1], axis,
                       [(i, i - 1) for i in range(1, axis.size)])
        if axis.index < axis.size - 1:
            tail = nxt
    out = torch.cat([lab[:, 1:], tail], dim=1)
    return DTensor.from_local(out, mesh, labels.placements, run_check=False,
                              shape=labels.shape, stride=labels.stride())


def _mesh_lm_loss(hidden, w, labels, config):
    """The shifted CE under a mesh. The fused CE (``_ChunkedNLL``, raw
    pointers) cannot take a DTensor, so it runs under ``local_map`` on each
    rank's rows against the whole lm head (gathered over fsdp and tp); the
    rows' NLL sum and valid count come out as partial sums over the batch's
    (and the sequence's) axes, are reduced, and divide. The head's
    gradient is likewise partial over those axes. The labels are shifted
    on the global sequence first (:func:`_shift_labels`) and every rank
    takes its positions unshifted: a per-shard shift would drop the pair
    at each boundary of a sequence sharded over sep."""
    mesh = hidden.device_mesh
    hidden = constrain(hidden, "batch", "seq", "embed")
    labels = _shift_labels(labels)
    rep = (Replicate(),) * mesh.ndim
    w = w.redistribute(mesh, rep)
    hp = tuple(hidden.placements)
    part = tuple(Partial() if p.is_shard() else Replicate() for p in hp)

    def parts(h, wl, lb):
        if config.fused_ce:
            return fused_linear_cross_entropy_parts(
                h, wl, lb, chunk=config.fused_ce_chunk, shift=False)
        return LlamaPretrainingCriterion.parts(h @ wl, lb, shift=False)

    total, count = local_map(
        parts, out_placements=(part, part),
        in_placements=(hp, rep, tuple(labels.placements)),
        in_grad_placements=(hp, part, tuple(labels.placements)),
        device_mesh=mesh)(
            hidden, w, labels)
    total, count = total.redistribute(mesh, rep), count.redistribute(mesh,
                                                                     rep)
    return total / count.clamp_min(1.0)


class LlamaPretrainingCriterion(nn.Module):
    """Shifted causal-LM cross entropy with an fp32 softmax."""

    @staticmethod
    def compute(logits, labels, ignore_index: int = -100):
        total, count = LlamaPretrainingCriterion.parts(logits, labels,
                                                       ignore_index)
        return total / count.clamp_min(1.0)

    @staticmethod
    def parts(logits, labels, ignore_index: int = -100, shift: bool = True):
        """(the summed NLL, the count of valid positions), fp32; with
        ``shift`` False the labels are already aligned with the logits."""
        lg = (logits[:, :-1, :] if shift else logits).float()
        lb = (labels[:, 1:] if shift else labels).long()
        logz = torch.logsumexp(lg, dim=-1)
        mask = lb != ignore_index
        picked = lg.gather(-1, torch.where(mask, lb, 0)[..., None])[..., 0]
        nll = torch.where(mask, logz - picked, 0.0)
        return nll.sum(), mask.sum().float()

    def forward(self, prediction_scores, masked_lm_labels):
        return self.compute(prediction_scores, masked_lm_labels)
