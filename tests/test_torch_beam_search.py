"""Beam search (``BeamSearchDecoder``, ``dynamic_decode``, ``gather_tree``)
against the JAX package, CPU, fp32.

The JAX ``dynamic_decode`` stacks each step's tokens and never follows the
beam indices back (paddle_tpu/nn/layer/extras.py:608-622), so its ids are
not hypotheses; the port backtracks through each step's parent beams with
``gather_tree``, as Paddle does. So the port is held to JAX's decoder
step by step (the same cell, embedding and output weights; tokens and
finished flags exact, scores and cell states within 1e-5, the parent
beams exact, read from the ``top_k`` indices JAX's step computes), and its
final ids to JAX's ``gather_tree`` of those steps' tokens and parents.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer
from torch_nn_parity import F, as_np, compare

torch.set_num_threads(1)

BATCH, BEAM, VOCAB, HID, EMB = 2, 3, 7, 8, 5
START, END, STEPS = 0, 1, 6


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def _parts(P):
    return (P.nn.GRUCell(EMB, HID), P.nn.Embedding(VOCAB, EMB),
            P.nn.Linear(HID, VOCAB))


def _decoders(seed):
    """JAX's and the port's decoders over the same weights (the output
    layer scaled up so some beams end early)."""
    jparts, tparts = _parts(jp), _parts(pt)
    for j, t in zip(jparts, tparts):
        load_jax_state(t, state_from_jax_layer(j))
    w = F(HID, VOCAB, scale=3.0)
    w[:, END] += np.random.default_rng(seed).uniform(0, 1.5)
    jparts[2].weight.set_value(jp.to_tensor(w))
    tparts[2].weight.set_value(pt.to_tensor(w))
    return tuple(P.nn.BeamSearchDecoder(c, START, END, BEAM, embedding_fn=e,
                                        output_fn=o)
                 for P, (c, e, o) in ((jp, jparts), (pt, tparts)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_steps_parents_and_backtracked_ids_match_jax(seed, monkeypatch):
    jdec, tdec = _decoders(seed)
    h0 = F(BATCH, HID)
    jin, jst = jdec.initialize(jp.to_tensor(h0))
    tin, tst = tdec.initialize(pt.to_tensor(h0))
    compare([as_np(t) for t in tin], [np.asarray(a) for a in jin], 0)
    captured = []
    top_k = jax.lax.top_k

    def spy(x, k):
        out = top_k(x, k)
        captured.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy)
    j_toks, j_parents = [], []
    for t in range(STEPS):
        jin, jst, jtok, jfin = jdec.step(t, jin, jst)
        tin, tst, (ttok, tpar), tfin = tdec.step(t, tin, tst)
        j_parent = captured[-1] // VOCAB
        np.testing.assert_array_equal(as_np(ttok), np.asarray(jtok))
        np.testing.assert_array_equal(as_np(tpar), j_parent)
        np.testing.assert_array_equal(as_np(tfin), np.asarray(jfin))
        compare(as_np(tin[1]), np.asarray(jin[1]), 1e-5)
        compare(as_np(tst), as_np(jst), 1e-5)
        j_toks.append(np.asarray(jtok))
        j_parents.append(j_parent)
        if bool(np.asarray(jfin).all()):
            break
    monkeypatch.undo()
    ref = as_np(jp.nn.functional.gather_tree(
        jp.to_tensor(np.stack(j_toks)), jp.to_tensor(np.stack(j_parents))))
    ids, scores = pt.nn.dynamic_decode(tdec, pt.to_tensor(h0),
                                       max_step_num=STEPS)
    np.testing.assert_array_equal(as_np(ids), ref.transpose(1, 2, 0))
    j_ids, j_scores = jp.nn.dynamic_decode(jdec, jp.to_tensor(h0),
                                           max_step_num=STEPS)
    compare(scores, j_scores, 1e-5)
    assert as_np(ids).shape == as_np(j_ids).shape


def test_dynamic_decode_time_major_and_lengths():
    _, tdec = _decoders(3)
    h0 = pt.to_tensor(F(BATCH, HID))
    ids, scores, lens = pt.nn.dynamic_decode(tdec, h0, max_step_num=STEPS,
                                             return_length=True)
    ids_tm, _ = pt.nn.dynamic_decode(tdec, h0, max_step_num=STEPS,
                                     output_time_major=True)
    assert torch.equal(ids_tm, ids.permute(2, 0, 1))
    T = ids.shape[-1]
    for b in range(BATCH):
        for k in range(BEAM):
            row = ids[b, k].tolist()
            want = row.index(END) + 1 if END in row else T
            assert int(lens[b, k]) == want
    with pytest.raises(TypeError, match="unexpected"):
        pt.nn.dynamic_decode(tdec, h0, max_step_num=2, bogus=True)


def test_gather_tree_follows_parents():
    ids = np.array([[[2, 3]], [[4, 5]], [[6, 7]]])       # [T, batch, beam]
    parents = np.array([[[0, 0]], [[1, 0]], [[1, 1]]])
    out = as_np(pt.nn.functional.gather_tree(pt.to_tensor(ids),
                                             pt.to_tensor(parents)))
    # beam 0 ends at 6, came from beam 1 (5), which came from beam 0 (2)
    np.testing.assert_array_equal(out[:, 0, 0], [2, 5, 6])
    np.testing.assert_array_equal(out[:, 0, 1], [2, 5, 7])
