"""KV-cache generation, sampling and the cache set-up shared by the
serving engine — port of ``paddle_tpu/models/generation_utils.py``.

A model provides ``_decode_chunk(ids, caches, pos, pad_bias, pos_offset)
-> (last logits [b, vocab] fp32, caches)``; the mixin supplies the caches
(dense ``_init_caches``, paged ``_init_paged_caches``) and ``generate()``.

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

import numpy as np
import torch

from ..device import resolve_device
from ..ops.paged_attention import QuantizedKVPool

_M64 = (1 << 64) - 1
#: tokens a decode block of ``generate`` runs between eos checks (:23)
DECODE_BLOCK = 16


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


def causal_cache_bias(k_cache, pos: int, s: int, pad_bias=None):
    """[1, 1, s, max_len] fp32 additive bias over a dense cache [b,
    max_len, ...] (:263-272): chunk row i (absolute position pos + i) sees
    the cache columns <= pos + i, the others get -1e9; composes with the
    left-pad bias [b, 1, 1, max_len]."""
    max_len = k_cache.shape[1]
    dev = k_cache.device
    cols = torch.arange(max_len, device=dev)[None, :]
    rows = pos + torch.arange(s, device=dev)[:, None]
    bias = torch.where(cols <= rows, 0.0, -1e9)[None, None]
    return bias if pad_bias is None else bias + pad_bias


def _as_tensor(x, device, dtype):
    """A torch tensor, a numpy array or a nested list, on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=dtype)


class GenerationMixin:
    def _init_caches(self, b, max_len):
        """Dense KV caches: per layer a (k, v) pair of zeros [b, max_len,
        kv_heads, head_dim] in the parameters' dtype, on their device
        (:76-85). ``generate`` writes them in place."""
        cfg = self.config
        kvh = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
        p = next(self.parameters())

        def cache():
            return torch.zeros((b, max_len, kvh, cfg.head_dim),
                               dtype=p.dtype, device=p.device)

        return [(cache(), cache()) for _ in range(cfg.num_hidden_layers)]

    def _validate_generate(self, prompt_len, max_len):
        """Hook for a family's own length limits (a learned position table);
        the default (rotary positions) has none (:87-89)."""

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_p: Optional[float] = None,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 attention_mask=None, max_length: Optional[int] = None,
                 cache_impl: str = "dense", page_size: int = 64):
        """KV-cache autoregressive generation (:182-260): the prompt in one
        chunk, then blocks of ``DECODE_BLOCK`` tokens, each token one
        ``_decode_chunk`` call (eagerly; the JAX package scans a block).

        ``input_ids`` [b, prompt_len] (a tensor, array or list).
        Batches of unequal prompt lengths use LEFT padding and
        ``attention_mask`` [b, prompt_len] (1 = real): pad columns are
        masked out of attention by a -1e9 bias and each row's positions
        shift so that its prompt starts at position 0. Always returns
        [b, max_new_tokens] int32 on the model's device; a row that emits
        ``eos_token_id`` emits only eos after it, and the output is padded
        with eos when every row finished early. ``max_length`` sizes the
        cache (at least prompt_len + max_new_tokens).
        ``cache_impl="paged"`` runs the serving layout instead (pools of
        ``page_size`` pages, the prompt through the flash kernel K1, each
        token through the paged-decode kernel K4); it takes no
        ``attention_mask``. Errors are the JAX package's ``ValueError``s.

        Sampling contract. ``temperature=0`` is greedy: the argmax, which
        equals the JAX package's tokens. Otherwise each row draws from
        ``sample_rows`` (temperature, top-p; no top-k) with the key
        ``fold_keys(seed, position)``, where position is the token's
        index in its row's real (unpadded) sequence, so:
        - the same seed gives the same stream for the same prompt,
          whatever the batching, the padding or the cache layout, and the
          serving engine's stream for ``Request(prompt, seed=seed)``;
        - ``top_p`` -> 0 keeps only the most likely token: greedy;
        - ``validate_sampling``'s errors are the JAX package's.
        The draws are not ``jax.random``'s: sampled tokens differ from the
        JAX package's."""
        validate_sampling(temperature, top_p)
        dev = next(self.parameters()).device
        ids = _as_tensor(input_ids, dev, torch.long)
        b, prompt_len = ids.shape
        max_len = (max_length if max_length is not None
                   else prompt_len + max_new_tokens)
        if max_len < prompt_len + max_new_tokens:
            raise ValueError(
                f"max_length {max_len} < prompt {prompt_len} + "
                f"max_new_tokens {max_new_tokens}")
        self._validate_generate(prompt_len, prompt_len + max_new_tokens)
        if cache_impl == "paged":
            if attention_mask is not None:
                raise ValueError(
                    "cache_impl='paged' does not support attention_mask "
                    "(left padding) yet — use equal-length prompts")
            caches = self._init_paged_caches(b, max_len, page_size,
                                             device=dev)
        else:
            caches = self._init_caches(b, max_len)
        real_len = np.full(b, prompt_len, np.int64)
        pad_bias = pos_offset = None
        if attention_mask is not None:
            m = _as_tensor(attention_mask, dev, torch.int32)
            if bool((m[:, -1] == 0).any()) or bool(
                    (torch.diff(m, dim=1) < 0).any()):
                raise ValueError(
                    "generate() expects LEFT-padded prompts: attention_mask "
                    "must be 0...01...1 per row (pads strictly before tokens)")
            pad_cols = torch.cat([m == 0, torch.zeros(
                (b, max_len - prompt_len), dtype=torch.bool, device=dev)], 1)
            pad_bias = torch.where(pad_cols, -1e9, 0.0)[:, None, None, :]
            real = m.sum(-1)
            pos_offset = (prompt_len - real).to(torch.int32)
            real_len = real.cpu().numpy().astype(np.int64)
        if temperature == 0.0:
            def sample(logits, t):
                return logits.argmax(-1)
        else:
            temps = torch.full((b,), float(temperature), device=dev)
            tops = torch.full((b,), 1.0 if top_p is None else float(top_p),
                              device=dev)
            topks = torch.zeros(b, dtype=torch.int32, device=dev)

            def sample(logits, t):
                # the t-th new token sits at position real_len + t
                keys = fold_keys([seed] * b, real_len + t)
                return sample_rows(logits, keys, temps, tops, topks)

        logits, caches = self._decode_chunk(ids, caches, 0, pad_bias,
                                            pos_offset)
        tok = sample(logits, 0)
        chunks = [tok[:, None]]
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        if eos_token_id is not None:
            finished = finished | (tok == eos_token_id)
        done = 1
        while done < max_new_tokens:
            if eos_token_id is not None and bool(finished.all()):
                break
            n = min(DECODE_BLOCK, max_new_tokens - done)
            block = []
            for i in range(n):
                logits, caches = self._decode_chunk(
                    tok[:, None], caches, prompt_len + done - 1 + i,
                    pad_bias, pos_offset)
                tok = sample(logits, done + i)
                if eos_token_id is not None:
                    tok = torch.where(finished, eos_token_id, tok)
                    finished = finished | (tok == eos_token_id)
                block.append(tok)
            chunks.append(torch.stack(block, dim=1))
            done += n
        out = torch.cat(chunks, dim=1)
        if out.shape[1] < max_new_tokens:
            out = torch.cat([out, torch.full(
                (b, max_new_tokens - out.shape[1]), eos_token_id,
                dtype=out.dtype, device=dev)], dim=1)
        return out.to(torch.int32)

    def _init_paged_caches(self, b, max_len, page_size=64, num_blocks=None,
                           kv_dtype=None, device=None):
        """Paged-KV pools (serving layout, ops/paged_attention.py): per-layer
        page pools + a block table with pages statically assigned per
        sequence, on ``device`` (default: the CUDA device; raises without
        one unless ``device="cpu"``). ``num_blocks`` overrides the pool
        size (>= b * pages_per_seq). Pools take the parameters' dtype, or
        with ``kv_dtype="int8"`` the int8 block format
        (``ops.paged_attention.QuantizedKVPool``: int8 pages and one fp32
        absmax scale per (page, kv head), quantize-on-append and
        dequantize-on-read)."""
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
            def pool():
                return QuantizedKVPool(
                    torch.zeros((npages, kvh, page_size, hd),
                                dtype=torch.int8, device=dev),
                    torch.zeros((npages, kvh), dtype=torch.float32,
                                device=dev))
        elif kv_dtype in (None, "param"):
            def pool():
                return torch.zeros((npages, kvh, page_size, hd), dtype=dtype,
                                   device=dev)
        else:
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} "
                             "(supported: None/'param', 'int8')")
        tables = torch.arange(b * maxp, dtype=torch.int32,
                              device=dev).reshape(b, maxp)
        kv = [(pool(), pool()) for _ in range(cfg.num_hidden_layers)]
        return {"kv": kv, "tables": tables}
