"""Sampling and paged-cache set-up shared by the serving engine — port of
``paddle_tpu/models/generation_utils.py``.

Sampling keeps the JAX package's filter exactly (temperature, then top-p
over the sorted distribution, then top-k) and its keying contract: every
row draws from randomness fixed by ``(request seed, token position)``
alone, so a request's stream never depends on batching or arrival order.
The bits differ from JAX's threefry ``fold_in``: the port seeds one
``torch.Generator`` per sampled row from a 64-bit mix of the pair. Greedy
rows (temperature 0) and ``top_k=1`` rows equal the argmax in both
packages.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..device import resolve_device

_M64 = (1 << 64) - 1


def validate_sampling(temperature, top_p, top_k=0):
    """Range checks for sampling params (serving ``Request``): out-of-range
    values fail loudly instead of degenerating in :func:`sample_rows`."""
    # `not (x >= 0)` (vs `x < 0`) also rejects NaN
    if temperature is not None and not float(temperature) >= 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_p is not None and not 0.0 < float(top_p) <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k is not None and int(top_k) < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_keys(seeds: Sequence[int], positions: Sequence[int]):
    """Stateless per-row generator seeds: the token position folded into
    the request seed (the JAX package's ``fold_in(key(seed), position)``
    contract, with splitmix64 in place of threefry)."""
    return [_splitmix64(_splitmix64(int(s) & _M64) ^ (int(p) & _M64))
            for s, p in zip(seeds, positions)]


def sample_rows(logits, keys: Sequence[Optional[int]], temps, top_ps,
                top_ks):
    """Row-vectorized sampling: per-row temperature/top-p/top-k/key.

    logits [b, V] fp32; keys: one generator seed per row (from
    :func:`fold_keys`), or None for a row that takes the argmax;
    temps/top_ps [b] fp32 and top_ks [b] int (0 = disabled) on the logits'
    device. Rows with temperature <= 0 take the argmax."""
    b, V = logits.shape
    dev = logits.device
    greedy = logits.argmax(-1)
    lg = logits / temps.clamp_min(1e-6)[:, None]
    sort_idx = torch.argsort(-lg, dim=-1, stable=True)
    sorted_lg = lg.gather(-1, sort_idx)
    p = torch.softmax(sorted_lg, dim=-1)
    cum = torch.cumsum(p, dim=-1)
    keep = (cum - p) <= top_ps[:, None]
    kk = torch.where(top_ks > 0, top_ks.long(), V)
    keep = keep & (torch.arange(V, device=dev)[None, :] < kk[:, None])
    masked = torch.where(keep, sorted_lg, -1e9)
    # categorical draw as argmax(logits + Gumbel noise), one generator per
    # row seeded from its key
    noise = torch.zeros(b, V, dtype=torch.float32, device=dev)
    for i, key in enumerate(keys):
        if key is None:
            continue
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(key))
        u = torch.rand(V, generator=gen, device=dev)
        noise[i] = -torch.log(-torch.log(u))
    choice = (masked + noise).argmax(-1)
    sampled = sort_idx.gather(-1, choice[:, None])[:, 0]
    return torch.where(temps <= 0.0, greedy, sampled)


class GenerationMixin:
    def _init_paged_caches(self, b, max_len, page_size=64, num_blocks=None,
                           kv_dtype=None, device=None):
        """Paged-KV pools (serving layout, ops/paged_attention.py): per-layer
        page pools + a block table with pages statically assigned per
        sequence, on ``device`` (default: the CUDA device; raises without
        one unless ``device="cpu"``). ``num_blocks`` overrides the pool
        size (>= b * pages_per_seq). Pools take the parameters' dtype; the
        int8 block format is not ported yet."""
        dev = resolve_device(device)
        cfg = self.config
        kvh = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
        hd = cfg.head_dim
        dtype = next(self.parameters()).dtype
        maxp = -(-max_len // page_size)
        npages = b * maxp if num_blocks is None else int(num_blocks)
        if npages < b * maxp:
            raise ValueError(f"num_blocks {npages} < {b * maxp} — the pool "
                             "cannot back every slot's table")
        if kv_dtype == "int8":
            raise NotImplementedError(
                "int8 paged-KV pools (QuantizedKVPool) are not ported yet: "
                "they arrive with the int8-KV serving slice (ROADMAP Queue 1)")
        if kv_dtype not in (None, "param"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} "
                             "(supported: None/'param')")
        tables = torch.arange(b * maxp, dtype=torch.int32,
                              device=dev).reshape(b, maxp)
        kv = [(torch.zeros((npages, kvh, page_size, hd), dtype=dtype,
                           device=dev),
               torch.zeros((npages, kvh, page_size, hd), dtype=dtype,
                           device=dev))
              for _ in range(cfg.num_hidden_layers)]
        return {"kv": kv, "tables": tables}
