"""The port's ``incubate.asp`` against the JAX package's, on the CPU: the
n:m masks of every algorithm byte-equal on the same seeded weights (1-D,
2-D, 4-D conv weights, ragged widths), the checks, ``create_mask`` /
``check_sparsity`` by name, ``prune_model`` on the same model (masks and
pruned weights byte-equal, exclusions, the supported-layer registry) and
``decorate``: after optimizer steps every pruned weight still satisfies
2:4 and keeps density 0.5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.incubate.asp as JA
import paddle_tpu_torch as pt
import paddle_tpu_torch.incubate.asp as TA
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer


@pytest.fixture(autouse=True)
def _cpu():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev
    JA.reset_excluded_layers()
    TA.reset_excluded_layers()


SHAPES = [(8, 16), (7, 10), (16,), (4, 3, 3, 4)]


@pytest.mark.parametrize("algo", ["mask_1d", "mask_2d_greedy",
                                  "mask_2d_best"])
@pytest.mark.parametrize("shape", SHAPES)
def test_masks_byte_equal(algo, shape):
    w = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    got = TA.create_mask(torch.from_numpy(w), algo)
    ref = JA.create_mask(w, algo)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    check = "1d" if algo == "mask_1d" else "2d"
    assert TA.check_sparsity(got * w, check) == JA.check_sparsity(
        ref * w, check) is True


@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (4, 8)])
def test_raw_algorithms_and_checks(n, m):
    w = np.random.default_rng(n * m).standard_normal((16, 24)).astype(
        np.float32)
    for name in ("get_mask_1d", "get_mask_2d_greedy"):
        got, ref = getattr(TA, name)(w, n, m), getattr(JA, name)(w, n, m)
        np.testing.assert_array_equal(got, ref)
    assert TA.check_mask_1d(w, n, m) == JA.check_mask_1d(w, n, m)
    assert TA.check_mask_2d(w, n, m) == JA.check_mask_2d(w, n, m)
    assert TA.calculate_density(torch.from_numpy(w)) == \
        JA.calculate_density(w)


def test_enums():
    assert [a.value for a in TA.MaskAlgo] == [a.value for a in JA.MaskAlgo]
    assert TA.CheckMethod.get_checking_method(TA.MaskAlgo.MASK_2D_BEST) \
        == TA.CheckMethod.CHECK_2D


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(16, 32), P.nn.ReLU(),
                           P.nn.Linear(32, 8), P.nn.ReLU(),
                           P.nn.Linear(8, 4))


def test_prune_model_equals_jax_and_excludes():
    jp.seed(7)
    jm, tm = _mlp(jp), _mlp(pt)
    load_jax_state(tm, state_from_jax_layer(jm))
    JA.set_excluded_layers(["4"])
    TA.set_excluded_layers(["4"])
    jmasks = JA.prune_model(jm, 2, 4, "mask_1d")
    tmasks = TA.prune_model(tm, 2, 4, "mask_1d")
    assert sorted(tmasks) == sorted(jmasks) == ["0.weight", "2.weight"]
    for k in jmasks:
        np.testing.assert_array_equal(tmasks[k], jmasks[k])
    for (kj, vj), (kt, vt) in zip(jm.state_dict().items(),
                                  tm.state_dict().items()):
        assert kj == kt
        np.testing.assert_array_equal(vt.detach().numpy(),
                                      np.asarray(vj._data))


def test_add_supported_layer():
    TA.add_supported_layer("Bilinear")
    assert "Bilinear" in TA._SUPPORTED_TYPES
    TA._SUPPORTED_TYPES.discard("Bilinear")
    with pytest.raises(NotImplementedError, match="pruning_func"):
        TA.add_supported_layer("Linear", pruning_func=lambda *a: None)


def test_decorate_keeps_two_four_through_steps():
    pt.seed(0)
    tm = _mlp(pt)
    TA.prune_model(tm, 2, 4, "mask_1d")
    opt = TA.decorate(pt.optimizer.AdamW(
        learning_rate=1e-2, parameters=tm.parameters()))
    x = torch.randn(8, 16)
    for _ in range(3):
        loss = (tm(x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    for name in ("0.weight", "2.weight", "4.weight"):
        w = dict(tm.named_parameters())[name]
        assert TA.check_sparsity(w.detach().t(), "1d"), name
        assert TA.calculate_density(w) == 0.5, name
    assert opt.get_lr() == 1e-2
