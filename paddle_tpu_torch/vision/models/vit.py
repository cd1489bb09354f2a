"""Vision Transformer — port of ``paddle_tpu/vision/models/vit.py``
(bench config 5: ViT-L/16): pre-LN blocks, learned positions, a cls
token.

Names and ``[in, out]`` layouts are the JAX package's, so a JAX
``state_dict`` loads as it is. As there:
- the patch embedding is a reshape to ``(p, p, c)``-ordered patch rows
  and a matmul with ``patch_w`` ``[p * p * c, hidden]``, not a conv;
- LayerNorm has eps 1e-6, fp32 statistics (population variance) and the
  affine in the activation dtype (``models/_common._layer_norm``);
- attention is the dense ``_xla_attention`` with ``causal=False``, called
  directly (the JAX package never routes it to the flash kernels);
- the MLP's GELU is the tanh form (``jax.nn.gelu``'s default);
- ``recompute`` checkpoints each block while autograd records in
  training; sharding annotations are no-ops on one device.
``ViTConfig.dropout`` is unused, as in the JAX model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...device import resolve_dtype
from ...models._common import _layer_norm
from ...nn import initializer as I
from ...nn.functional.flash_attention import _xla_attention

__all__ = ["VisionTransformer", "ViTConfig", "vit_b_16", "vit_l_16"]

_EPS = 1e-6


class ViTConfig:
    def __init__(self, image_size=224, patch_size=16, in_channels=3,
                 hidden_size=768, num_layers=12, num_heads=12, mlp_ratio=4.0,
                 num_classes=1000, dropout=0.0, dtype="float32",
                 recompute=False):
        self.image_size = image_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.num_classes = num_classes
        self.dropout = dropout
        self.dtype = dtype
        self.recompute = recompute

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls, **over):
        d = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                 num_heads=4, num_classes=10)
        d.update(over)
        return cls(**d)


def _params(module, specs, dtype, device, gen):
    """Register ``name: (shape, initializer)`` pairs on ``module``."""
    for name, (shape, init) in specs.items():
        setattr(module, name, I.create_parameter(shape, init, device, gen,
                                                 dtype))


class ViTBlock(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, cfg: ViTConfig, device, generator):
        super().__init__()
        h = cfg.hidden_size
        m = int(h * cfg.mlp_ratio)
        self.num_heads = cfg.num_heads
        tn, one, zero = I.TruncatedNormal(std=0.02), I.Constant(1.0), \
            I.Constant(0.0)
        _params(self, dict(
            ln1_w=([h], one), ln1_b=([h], zero),
            qkv_w=([h, 3 * h], tn), qkv_b=([3 * h], zero),
            proj_w=([h, h], tn), proj_b=([h], zero),
            ln2_w=([h], one), ln2_b=([h], zero),
            fc1_w=([h, m], tn), fc1_b=([m], zero),
            fc2_w=([m, h], tn), fc2_b=([h], zero)),
            resolve_dtype(cfg.dtype), device, generator)

    def forward(self, x):
        b, n, h = x.shape
        nh = self.num_heads
        y = _layer_norm(x, self.ln1_w, self.ln1_b, _EPS)
        qkv = (y @ self.qkv_w + self.qkv_b).reshape(b, n, 3, nh, h // nh)
        q, k, v = qkv.unbind(2)
        attn = _xla_attention(q, k, v, causal=False).reshape(b, n, h)
        x = x + attn @ self.proj_w + self.proj_b
        y = _layer_norm(x, self.ln2_w, self.ln2_b, _EPS)
        y = F.gelu(y @ self.fc1_w + self.fc1_b, approximate="tanh")
        return x + y @ self.fc2_w + self.fc2_b


class VisionTransformer(nn.Module):
    """On ``device`` (default: the CUDA device; raises without one unless
    ``device="cpu"``), weights in ``cfg.dtype`` drawn from a generator
    seeded by ``seed``."""

    def __init__(self, cfg: ViTConfig, device=None, seed=0):
        super().__init__()
        self.config = cfg
        dev, gen = I.seeded(device, seed)
        h, p, c = cfg.hidden_size, cfg.patch_size, cfg.in_channels
        tn, one, zero = I.TruncatedNormal(std=0.02), I.Constant(1.0), \
            I.Constant(0.0)
        dtype = resolve_dtype(cfg.dtype)
        _params(self, dict(
            patch_w=([p * p * c, h], tn), patch_b=([h], zero),
            cls_token=([1, 1, h], tn),
            pos_embed=([1, cfg.num_patches + 1, h], tn)), dtype, dev, gen)
        self.blocks = nn.ModuleList([ViTBlock(cfg, dev, gen)
                                     for _ in range(cfg.num_layers)])
        _params(self, dict(
            ln_w=([h], one), ln_b=([h], zero),
            head_w=([h, cfg.num_classes], tn),
            head_b=([cfg.num_classes], zero)), dtype, dev, gen)

    def _patchify(self, img):
        """[b, c, H, W] -> [b, n_patches, p * p * c], each patch's values
        ordered (row, column, channel) as ``patch_w``'s rows."""
        b, c, H, W = img.shape
        p = self.config.patch_size
        img = img.reshape(b, c, H // p, p, W // p, p)
        img = img.permute(0, 2, 4, 3, 5, 1)   # b, hp, wp, p, p, c
        return img.reshape(b, (H // p) * (W // p), p * p * c)

    def forward(self, images):
        x = self._patchify(images) @ self.patch_w + self.patch_b
        cls = self.cls_token.expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        remat = (self.config.recompute and self.training
                 and torch.is_grad_enabled())
        for blk in self.blocks:
            x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
        x = _layer_norm(x, self.ln_w, self.ln_b, _EPS)
        return x[:, 0] @ self.head_w + self.head_b

    def loss_fn(self, images, labels):
        """Mean cross entropy of the fp32 logits."""
        logp = torch.log_softmax(self.forward(images).float(), dim=-1)
        return -logp.gather(-1, labels.long()[..., None]).mean()


def vit_b_16(device=None, seed=0, **over):
    return VisionTransformer(ViTConfig(hidden_size=768, num_layers=12,
                                       num_heads=12, **over), device, seed)


def vit_l_16(device=None, seed=0, **over):
    return VisionTransformer(ViTConfig(hidden_size=1024, num_layers=24,
                                       num_heads=16, **over), device, seed)
