"""The DeepSpeech2-class CTC model of ``chip_smoke.py`` phase 45 at a small
width (channels 4, GRUs of 32, 30 classes, batch 4, the full 161-bin
input) in the port against the same model of the JAX package's layers,
CPU, fp32, the JAX weights carried across by name.

(a) Every length equal to the frames (the JAX GRU ignores
``sequence_length``; the frame masks are all ones): BatchNorm in training,
the loss within 1e-5 relative, every parameter's gradient within 1e-4 of
its largest JAX value (see ``_grads_close``), the running statistics
after the step within 1e-5.
(b) Lengths that differ: BatchNorm in eval (batch statistics would mix the
padded frames in), the port's batched per-row CTC losses against the JAX
model run on each row alone, cut to its length (1e-5 relative), and the
gradients of their sum against the per-row JAX gradients summed (1e-4).
"""

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer
from torch_nn_parity import as_np

torch.set_num_threads(1)
CFG = dict(chip_smoke.DS2_PARITY, frames=(40, 70))


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def _pair(train):
    jm = chip_smoke.deepspeech2(jp, CFG)
    tm = chip_smoke.deepspeech2(pt, CFG)
    assert [(n, tuple(p.shape)) for n, p in tm.named_parameters()] == \
        [(n, tuple(p.shape)) for n, p in jm.named_parameters()]
    load_jax_state(tm, state_from_jax_layer(jm))
    for m in (jm, tm):
        m.train() if train else m.eval()
    return jm, tm


def _grads_close(tm, jgrads, tol):
    """Each gradient within ``tol`` of its largest JAX value, or of
    2^-8 of the largest of all where that is smaller (as
    ``chip_smoke.amp_grad_errors``): a conv bias before a batch
    norm in training has a zero gradient in exact arithmetic, so both sides
    hold only rounding there (~1e-7)."""
    top = max(float(np.abs(g).max()) for g in jgrads.values())
    for n, p in tm.named_parameters():
        ref = jgrads[n]
        err = float(np.abs(as_np(p.grad) - ref).max())
        assert err <= tol * max(float(np.abs(ref).max()), top / 256), \
            (n, err)


def test_full_lengths_match_jax_in_training():
    jm, tm = _pair(True)
    feats, lens, labels, lab_lens = chip_smoke.ds2_batch(np, CFG, 0)
    lens = np.full_like(lens, feats.shape[1])
    losses = []
    for P, m in ((jp, jm), (pt, tm)):
        loss = chip_smoke.ds2_loss(P, m, P.to_tensor(feats), lens,
                                   P.to_tensor(labels), P.to_tensor(lab_lens))
        loss.backward()
        losses.append(float(loss))
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    _grads_close(tm, {n: as_np(p.grad) for n, p in jm.named_parameters()},
                 1e-4)
    for (n, a), b in zip(tm.state_dict().items(), jm.state_dict().values()):
        np.testing.assert_allclose(as_np(a), as_np(b), rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def test_differing_lengths_match_per_row_jax_runs():
    jm, tm = _pair(False)
    feats, lens, labels, lab_lens = chip_smoke.ds2_batch(np, CFG, 1)
    assert len(set(lens.tolist())) > 1
    loss = chip_smoke.ds2_loss(pt, tm, pt.to_tensor(feats), lens,
                               pt.to_tensor(labels), pt.to_tensor(lab_lens),
                               reduction="none")
    loss.sum().backward()
    jgrads = {n: 0.0 for n, _ in jm.named_parameters()}
    for b, n in enumerate(lens):
        for p in jm.parameters():
            p.clear_gradient()
        jl = chip_smoke.ds2_loss(jp, jm, jp.to_tensor(feats[b:b + 1, :n]),
                                 lens[b:b + 1],
                                 jp.to_tensor(labels[b:b + 1, :lab_lens[b]]),
                                 jp.to_tensor(lab_lens[b:b + 1]),
                                 reduction="none")
        ref = float(as_np(jl)[0])
        assert abs(float(loss[b]) - ref) <= 1e-5 * abs(ref), (b, ref)
        jl.sum().backward()
        for name, p in jm.named_parameters():
            jgrads[name] = jgrads[name] + as_np(p.grad)
    _grads_close(tm, jgrads, 1e-4)
