"""Port metrics (paddle_tpu_torch.metric) against the JAX package's over
several ``update``s on random, tie-free predictions (CPU). ``compute`` runs
in torch, ``update`` / ``accumulate`` in numpy in both: every result must
be equal (the counts are integers; the ratios come from the same float
arithmetic); ``accuracy()`` within 1e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.metric as JM
import paddle_tpu_torch.metric as TM


def _logits(rng, n, c):
    # a permutation per row: no two predictions of a row tie
    return np.stack([rng.permutation(c) for _ in range(n)]).astype(
        np.float32) + rng.uniform(0, 0.5, (n, 1)).astype(np.float32)


@pytest.mark.parametrize("topk", [(1,), (1, 5), 3])
@pytest.mark.parametrize("label_shape", ["flat", "column"])
def test_accuracy_over_several_updates(topk, label_shape):
    rng = np.random.default_rng(0)
    jm, tm = JM.Accuracy(topk=topk), TM.Accuracy(topk=topk)
    assert tm.name() == jm.name() == "acc"
    for _ in range(4):
        pred = _logits(rng, 16, 10)
        label = rng.integers(0, 10, 16)
        if label_shape == "column":
            label = label[:, None]
        jc = jm.compute(paddle.to_tensor(pred), paddle.to_tensor(label))
        tc = tm.compute(torch.from_numpy(pred), torch.from_numpy(label))
        assert tc.dtype == torch.float32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc._data))
        assert tm.update(tc.numpy()) == jm.update(np.asarray(jc._data))
    assert tm.accumulate() == jm.accumulate()
    assert tm.total == jm.total and tm.count == jm.count
    tm.reset()
    assert tm.total == [0.0] * len(tm.topk)


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_and_recall_over_several_updates(cls):
    rng = np.random.default_rng(1)
    jm, tm = getattr(JM, cls)(), getattr(TM, cls)()
    assert tm.name() == jm.name()
    for _ in range(5):
        preds = rng.uniform(0, 1, 32).astype(np.float32)
        labels = rng.integers(0, 2, 32)
        jm.update(preds, labels)
        tm.update(torch.from_numpy(preds), torch.from_numpy(labels))
    assert tm.accumulate() == jm.accumulate()
    assert 0 < tm.accumulate() < 1


@pytest.mark.parametrize("num_thresholds", [4095, 200])
def test_auc_over_several_updates(num_thresholds):
    rng = np.random.default_rng(2)
    jm = JM.Auc(num_thresholds=num_thresholds)
    tm = TM.Auc(num_thresholds=num_thresholds)
    for i in range(4):
        p = rng.uniform(0, 1, 40).astype(np.float32)
        preds = np.stack([1 - p, p], 1) if i % 2 else p
        labels = (rng.uniform(0, 1, 40) < p).astype(np.int64)
        jm.update(preds, labels)
        tm.update(torch.from_numpy(preds), torch.from_numpy(labels))
    assert tm.accumulate() == jm.accumulate()
    assert 0.5 < tm.accumulate() <= 1


@pytest.mark.parametrize("k", [1, 2, 5])
def test_accuracy_function(k):
    rng = np.random.default_rng(3)
    pred = _logits(rng, 24, 7)
    label = rng.integers(0, 7, (24, 1))
    ref = float(JM.accuracy(paddle.to_tensor(pred),
                            paddle.to_tensor(jnp.asarray(label)), k=k)._data)
    got = TM.accuracy(torch.from_numpy(pred), torch.from_numpy(label), k=k)
    assert got.ndim == 0 and got.dtype == torch.float32
    assert abs(got.item() - ref) <= 1e-7


def test_tied_predictions_rank_by_index():
    """Ties rank by index, the same on every call: the functional
    ``accuracy`` equals the JAX one (``jnp.argsort`` is stable), and
    ``Accuracy.compute`` keeps the lowest-index tied classes in its top k
    (the JAX class sorts with numpy's quicksort, whose tie order is its
    own: the port does not follow it)."""
    pred = np.array([[1.0, 3.0, 3.0, 3.0, 0.5, 3.0, 3.0, 3.0]] * 2,
                    np.float32)
    label = np.array([6, 7])
    for k in (1, 5):
        np.testing.assert_allclose(
            float(TM.accuracy(torch.from_numpy(pred),
                              torch.from_numpy(label), k=k)),
            float(np.asarray(JM.accuracy(paddle.to_tensor(pred),
                                         paddle.to_tensor(label),
                                         k=k)._data)), rtol=1e-7)
    got = TM.Accuracy(topk=(1, 5)).compute(torch.from_numpy(pred),
                                           torch.from_numpy(label))
    np.testing.assert_array_equal(got.numpy(), [[0, 0, 0, 0, 1],
                                                [0, 0, 0, 0, 0]])
