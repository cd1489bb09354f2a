"""Diffusion UNet — port of ``paddle_tpu/models/unet/modeling.py`` (bench
config 5: the Stable-Diffusion-class UNet): a sinusoidal timestep
embedding, down blocks (ResBlock + cross-attention, then a 2 x 2
downsample), a middle (ResBlock, cross-attention, ResBlock), up blocks
with skip concatenations, GroupNorm and SiLU.

Names and layouts are the JAX package's (conv kernels ``[out, in, kh,
kw]``, projections ``[in, out]``), so a JAX ``state_dict`` loads as it is.
As there: activations follow the parameter dtype; GroupNorm takes fp32
statistics, casts the normalised value back and applies the affine in the
activation dtype; attention (self and cross) is the dense
``_xla_attention``, never the flash kernels; the downsample averages 2 x 2
windows (the JAX sum / 4: dividing by 4 is exact) and the upsample repeats
nearest neighbours. Convolutions are torch's (cuDNN on the card), as
the JAX package's are XLA's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_dtype
from ...nn import initializer as I
from ...nn.functional.flash_attention import _xla_attention


class UNetConfig:
    def __init__(self, in_channels=4, out_channels=4,
                 block_channels=(128, 256, 512), layers_per_block=2,
                 num_heads=8, cross_attention_dim=768, groups=32,
                 dtype="float32", recompute=False):
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.block_channels = tuple(block_channels)
        self.layers_per_block = layers_per_block
        self.num_heads = num_heads
        self.cross_attention_dim = cross_attention_dim
        self.groups = groups
        self.dtype = dtype
        self.recompute = recompute

    @classmethod
    def tiny(cls, **over):
        d = dict(in_channels=4, out_channels=4, block_channels=(32, 64),
                 layers_per_block=1, num_heads=4, cross_attention_dim=32,
                 groups=8)
        d.update(over)
        return cls(**d)


def timestep_embedding(t, dim: int):
    """Sinusoidal timestep embedding [b] -> [b, dim] in fp32 (DDPM
    convention: cosines, then sines)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _conv(x, w, b, stride=1, padding=1):
    return F.conv2d(x, w, b, stride, padding)


def _group_norm(x, w, b, groups, eps=1e-5):
    """GroupNorm over min(groups, channels) groups: fp32 statistics
    (population variance), the normalised value cast to x's dtype, then the
    affine in that dtype."""
    g = min(groups, x.shape[1])
    xn = F.group_norm(x.float(), g, eps=eps).to(x.dtype)
    return xn * w[None, :, None, None] + b[None, :, None, None]


def _params(module, specs, cfg, device, gen):
    for name, (shape, init) in specs.items():
        setattr(module, name, I.create_parameter(
            shape, init, device, gen, resolve_dtype(cfg.dtype)))


_ONE, _ZERO = I.Constant(1.0), I.Constant(0.0)


class ResBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, cin: int, cout: int, temb_dim: int,
                 device, generator):
        super().__init__()
        self.cfg = cfg
        kn = I.KaimingNormal()
        specs = dict(
            norm1_w=([cin], _ONE), norm1_b=([cin], _ZERO),
            conv1_w=([cout, cin, 3, 3], kn), conv1_b=([cout], _ZERO),
            temb_w=([temb_dim, cout], kn), temb_b=([cout], _ZERO),
            norm2_w=([cout], _ONE), norm2_b=([cout], _ZERO),
            conv2_w=([cout, cout, 3, 3], kn), conv2_b=([cout], _ZERO))
        if cin != cout:
            specs["skip_w"] = ([cout, cin, 1, 1], kn)   # no bias
        _params(self, specs, cfg, device, generator)
        self.has_skip = cin != cout

    def forward(self, x, temb):
        groups = self.cfg.groups
        h = _group_norm(x, self.norm1_w, self.norm1_b, groups)
        h = _conv(F.silu(h), self.conv1_w, self.conv1_b)
        t = F.silu(temb) @ self.temb_w + self.temb_b
        h = h + t[:, :, None, None]
        h = _group_norm(h, self.norm2_w, self.norm2_b, groups)
        h = _conv(F.silu(h), self.conv2_w, self.conv2_b)
        if self.has_skip:
            x = F.conv2d(x, self.skip_w)
        return x + h


class CrossAttnBlock(nn.Module):
    """Spatial self-attention, then cross-attention to the text context."""

    def __init__(self, cfg: UNetConfig, channels: int, device, generator):
        super().__init__()
        self.cfg = cfg
        self.channels = channels
        xu, c, cd = I.XavierUniform(), channels, cfg.cross_attention_dim
        _params(self, dict(
            norm_w=([c], _ONE), norm_b=([c], _ZERO),
            q_self=([c, c], xu), kv_self=([c, 2 * c], xu),
            proj_self=([c, c], xu), q_cross=([c, c], xu),
            k_cross=([cd, c], xu), v_cross=([cd, c], xu),
            proj_cross=([c, c], xu)), cfg, device, generator)

    def _attn(self, q, k, v):
        nh = self.cfg.num_heads
        b, nq, c = q.shape
        hd = c // nh
        q = q.reshape(b, nq, nh, hd)
        k = k.reshape(b, k.shape[1], nh, hd)
        v = v.reshape(b, v.shape[1], nh, hd)
        return _xla_attention(q, k, v, causal=False).reshape(b, nq, c)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = _group_norm(x, self.norm_w, self.norm_b, self.cfg.groups)
        y = y.reshape(b, c, h * w).transpose(1, 2)   # [b, hw, c]
        q = y @ self.q_self
        k, v = (y @ self.kv_self).chunk(2, dim=-1)
        y = y + self._attn(q, k, v) @ self.proj_self
        q = y @ self.q_cross
        k = context @ self.k_cross
        v = context @ self.v_cross
        y = y + self._attn(q, k, v) @ self.proj_cross
        y = y.transpose(1, 2).reshape(b, c, h, w)
        return x + y


class UNet2DConditionModel(nn.Module):
    """On ``device`` (default: the CUDA device; raises without one unless
    ``device="cpu"``), weights in ``cfg.dtype`` drawn from a generator
    seeded by ``seed``."""

    def __init__(self, cfg: UNetConfig, device=None, seed=0):
        super().__init__()
        self.config = cfg
        dev, gen = I.seeded(device, seed)
        chs = cfg.block_channels
        temb_dim = chs[0] * 4
        self.temb_dim0 = chs[0]
        kn = I.KaimingNormal()
        _params(self, dict(
            temb_w1=([chs[0], temb_dim], kn), temb_b1=([temb_dim], _ZERO),
            temb_w2=([temb_dim, temb_dim], kn), temb_b2=([temb_dim], _ZERO),
            conv_in_w=([chs[0], cfg.in_channels, 3, 3], kn),
            conv_in_b=([chs[0]], _ZERO)), cfg, dev, gen)

        self.down_res = nn.ModuleList()
        self.down_attn = nn.ModuleList()
        self.downsamplers = []
        cin = chs[0]
        for i, ch in enumerate(chs):
            for _ in range(cfg.layers_per_block):
                self.down_res.append(ResBlock(cfg, cin, ch, temb_dim, dev,
                                              gen))
                self.down_attn.append(CrossAttnBlock(cfg, ch, dev, gen))
                cin = ch
            self.downsamplers.append(i < len(chs) - 1)

        self.mid1 = ResBlock(cfg, chs[-1], chs[-1], temb_dim, dev, gen)
        self.mid_attn = CrossAttnBlock(cfg, chs[-1], dev, gen)
        self.mid2 = ResBlock(cfg, chs[-1], chs[-1], temb_dim, dev, gen)

        self.up_res = nn.ModuleList()
        self.up_attn = nn.ModuleList()
        for ch in reversed(chs):
            for _ in range(cfg.layers_per_block):
                self.up_res.append(ResBlock(cfg, cin + ch, ch, temb_dim, dev,
                                            gen))
                self.up_attn.append(CrossAttnBlock(cfg, ch, dev, gen))
                cin = ch

        _params(self, dict(
            norm_out_w=([chs[0]], _ONE), norm_out_b=([chs[0]], _ZERO),
            conv_out_w=([cfg.out_channels, chs[0], 3, 3], kn),
            conv_out_b=([cfg.out_channels], _ZERO)), cfg, dev, gen)

    def forward(self, sample, timesteps, encoder_hidden_states):
        cfg = self.config
        dt = self.conv_in_w.dtype
        x = sample.to(dt)
        ctx = encoder_hidden_states.to(dt)
        temb = timestep_embedding(timesteps, self.temb_dim0).to(dt)
        temb = F.silu(temb @ self.temb_w1 + self.temb_b1) @ self.temb_w2 \
            + self.temb_b2

        x = _conv(x, self.conv_in_w, self.conv_in_b)
        skips = []
        li = 0
        for i in range(len(cfg.block_channels)):
            for _ in range(cfg.layers_per_block):
                x = self.down_res[li](x, temb)
                x = self.down_attn[li](x, ctx)
                skips.append(x)
                li += 1
            if self.downsamplers[i]:
                x = F.avg_pool2d(x, 2)

        x = self.mid1(x, temb)
        x = self.mid_attn(x, ctx)
        x = self.mid2(x, temb)

        li = 0
        for _ in cfg.block_channels:
            for _ in range(cfg.layers_per_block):
                skip = skips.pop()
                if skip.shape[2] != x.shape[2]:
                    x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = torch.cat([x, skip], dim=1)
                x = self.up_res[li](x, temb)
                x = self.up_attn[li](x, ctx)
                li += 1

        x = F.silu(_group_norm(x, self.norm_out_w, self.norm_out_b,
                               cfg.groups))
        return _conv(x, self.conv_out_w, self.conv_out_b)

    def loss_fn(self, batch, labels=None):
        """epsilon-prediction MSE (the DDPM objective) in fp32; ``batch``
        maps sample, timesteps, context and noise to tensors."""
        eps = self.forward(batch["sample"], batch["timesteps"],
                           batch["context"])
        return ((eps.float() - batch["noise"].float()) ** 2).mean()
