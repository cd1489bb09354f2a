"""Text — port of ``paddle_tpu/text/__init__.py``: CRF Viterbi decoding
on tensors, and the synthetic datasets.

:func:`viterbi_decode` runs the JAX scan as a loop over time steps where
the tensors lie: the forward pass keeps each step's backpointers
(``argmax`` over the previous tag, the first maximum on a tie), a row's
alpha stops changing past its length, and the backtrack follows the
pointers from the best last tag. The datasets draw each item from
``numpy.random.default_rng((seed, idx))`` exactly as the JAX package's do,
so their items are byte-equal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.op_registry import apply_fn
from ..io.dataset import Dataset

__all__ = ["viterbi_decode", "ViterbiDecoder", "Imdb", "Imikolov",
           "UCIHousing", "Conll05st", "Movielens", "WMT14", "WMT16"]


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag: bool = True, name=None):
    """potentials [B, T, N] emissions, transition_params [N, N], lengths
    [B]; returns (scores [B], paths [B, T] int64, 0 past each length).
    With ``include_bos_eos_tag`` the last two tags are BOS and EOS: paths
    start from BOS's transitions and end with EOS's."""

    def fn(emit, trans, lens):
        B, T, N = emit.shape
        lens = lens.to(emit.device)
        alpha = emit[:, 0] + trans[N - 2][None] if include_bos_eos_tag \
            else emit[:, 0]
        back = []
        for t in range(1, T):
            scores = alpha[:, :, None] + trans[None]      # [B, from, to]
            best, best_prev = scores.max(dim=1)
            keep = (t < lens)[:, None]
            alpha = torch.where(keep, best + emit[:, t], alpha)
            back.append(best_prev)
        if include_bos_eos_tag:
            alpha = alpha + trans[:, N - 1][None]
        score, tag = alpha.max(dim=-1)
        tags = [tag]
        for t in range(T - 2, -1, -1):
            prev = back[t].gather(1, tag[:, None])[:, 0]
            tag = torch.where(t + 1 < lens, prev, tag)
            tags.append(tag)
        path = torch.stack(tags[::-1], dim=1)
        mask = torch.arange(T, device=emit.device)[None] < lens[:, None]
        return score, torch.where(mask, path, 0).to(torch.int64)

    return apply_fn("viterbi_decode", fn, potentials, transition_params,
                    lengths)


class ViterbiDecoder:
    """Layer-style wrapper of :func:`viterbi_decode`."""

    def __init__(self, transitions, include_bos_eos_tag: bool = True,
                 name=None):
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


# ---------------------------------------------------------------------------
# datasets (synthetic, deterministic)
# ---------------------------------------------------------------------------

class _SyntheticText(Dataset):
    vocab_size = 1000

    def __init__(self, mode: str = "train", size: int = 500, **kwargs):
        self.mode = mode
        self.size = size
        self._rng_seed = 0 if mode == "train" else 1

    def __len__(self):
        return self.size


class Imdb(_SyntheticText):
    """Sentiment classification: (word_ids [T], label 0/1)."""

    def __getitem__(self, idx):
        rng = np.random.default_rng((self._rng_seed, idx))
        label = int(rng.integers(0, 2))
        length = int(rng.integers(20, 100))
        # class-conditional token distribution so models can actually learn
        lo, hi = (0, self.vocab_size // 2) if label == 0 else (
            self.vocab_size // 2, self.vocab_size)
        doc = rng.integers(lo, hi, length).astype(np.int64)
        return doc, label


class Imikolov(_SyntheticText):
    """N-gram LM dataset: (context [N-1], next_word)."""

    def __init__(self, mode="train", data_type="NGRAM", window_size=5, **kw):
        super().__init__(mode, **kw)
        self.window_size = window_size

    def __getitem__(self, idx):
        rng = np.random.default_rng((self._rng_seed, idx))
        seq = rng.integers(0, self.vocab_size,
                           self.window_size).astype(np.int64)
        return tuple(seq[:-1]) + (seq[-1],)


class UCIHousing(_SyntheticText):
    """Regression: (features [13], price [1]) with a learnable linear map."""

    _w = np.linspace(-1, 1, 13).astype(np.float32)

    def __getitem__(self, idx):
        rng = np.random.default_rng((self._rng_seed, idx))
        x = rng.standard_normal(13).astype(np.float32)
        y = np.array([x @ self._w + 0.1 * rng.standard_normal()], np.float32)
        return x, y


class Conll05st(_SyntheticText):
    """SRL simplified to (words [T], labels [T])."""

    n_labels = 20

    def __getitem__(self, idx):
        rng = np.random.default_rng((self._rng_seed, idx))
        length = int(rng.integers(5, 30))
        words = rng.integers(0, self.vocab_size, length).astype(np.int64)
        labels = rng.integers(0, self.n_labels, length).astype(np.int64)
        return words, labels


class Movielens(_SyntheticText):
    """Rating prediction: (user_id, movie_id, rating)."""

    def __getitem__(self, idx):
        rng = np.random.default_rng((self._rng_seed, idx))
        return (int(rng.integers(0, 6000)), int(rng.integers(0, 4000)),
                float(rng.integers(1, 6)))


class WMT14(_SyntheticText):
    """Translation: (src_ids [S], trg_ids [T], trg_next [T])."""

    def __getitem__(self, idx):
        rng = np.random.default_rng((self._rng_seed, idx))
        s, t = int(rng.integers(5, 30)), int(rng.integers(5, 30))
        src = rng.integers(0, self.vocab_size, s).astype(np.int64)
        trg = rng.integers(0, self.vocab_size, t).astype(np.int64)
        return src, trg, np.roll(trg, -1)


class WMT16(WMT14):
    pass
