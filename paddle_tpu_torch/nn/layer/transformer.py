"""Transformer layers — port of ``paddle_tpu/nn/layer/transformer.py``.

The same layers, names, arguments and parameter layouts as the JAX
package (``self_attn.q_proj.weight`` ``[in, out]`` ...), so a JAX state dict
loads by name. Attention runs through
``nn.functional.scaled_dot_product_attention``: with no mask and no dropout
(``dropout=0.0`` or eval mode) it reaches the flash kernels on the card
(K1-lse forward, K2 and K3 backward; the primal K1 under ``no_grad``), in
fp32, bf16 or fp16; with a mask or dropout it takes the dense path, as the
JAX package's ``_attention_impl`` does. ``TransformerEncoder`` and
``TransformerDecoder`` deep-copy their first layer, so every layer starts
from the same weights, as in the JAX package.
"""

from __future__ import annotations

import copy

import torch

from ...core.tensor import Tensor
from ...device import resolve_device
from ...tensor import manipulation as M
from .. import functional as F
from .common import Dropout, Linear
from .layers import Layer, LayerList
from .norm import LayerNorm


class MultiHeadAttention(Layer):
    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    class StaticCache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        dev = resolve_device(device)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             device=dev)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr,
                             device=dev)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr,
                             device=dev)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               device=dev)

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of the projected key/value (cross attention),
        or an empty incremental ``Cache`` ([b, 0, heads, head_dim] fp32)."""
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        b = key.shape[0]
        empty = torch.zeros((b, 0, self.num_heads, self.head_dim),
                            dtype=torch.float32, device=key.device)
        return self.Cache(empty.as_subclass(Tensor),
                          empty.clone().as_subclass(Tensor))

    def _shape(self, x):
        b, s = x.shape[0], x.shape[1]
        return M.reshape(x, [b, s, self.num_heads, self.head_dim])

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = key if key is not None else query
        value = value if value is not None else query
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
        new_cache = None
        if isinstance(cache, self.Cache):
            k = M.concat([cache.k, k], axis=1)
            v = M.concat([cache.v, v], axis=1)
            new_cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             dropout_p=self.dropout,
                                             training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = M.reshape(out, [b, s, self.embed_dim])
        out = self.out_proj(out)
        if cache is not None:
            return out, new_cache
        return out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            attn_dropout if attn_dropout is not None else dropout,
            weight_attr=weight_attr, bias_attr=bias_attr, device=dev)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, device=dev)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, device=dev)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, device=dev)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, device=dev)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is not None:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        else:
            src = self.self_attn(src, src, src, src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout_act(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is not None:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
            else:
                output = mod(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, ad,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, device=dev)
        self.cross_attn = MultiHeadAttention(d_model, nhead, ad,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, device=dev)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, device=dev)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, device=dev)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, device=dev)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, device=dev)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps, device=dev)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, inc = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, st = self.cross_attn(tgt, memory, memory, memory_mask,
                                      cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout_act(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (inc, st))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, device=dev)
            self.encoder = TransformerEncoder(
                enc_layer, num_encoder_layers,
                LayerNorm(d_model, device=dev) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, device=dev)
            self.decoder = TransformerDecoder(
                dec_layer, num_decoder_layers,
                LayerNorm(d_model, device=dev) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.where(keep, 0.0, float("-inf")).as_subclass(Tensor)
