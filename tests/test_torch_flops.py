"""``paddle.flops`` / ``Model.flops`` of the port against the JAX
package's (XLA's cost model over the jitted forward), on the CPU.

Exact on JAX's own cases (a Linear is 2 M N K + M N: tests/test_models.py)
and wherever the program is products, unpadded convolutions, biases and
ReLUs. Within 5% on LeNet and a 2-layer Transformer encoder: the products
and convolutions are counted exactly (XLA's rule counts no kernel tap on
the padding, and neither does the port), while elementwise work is
lowered differently on the two sides — XLA's fusion and algebraic
simplifier against torch's decompositions of layer norm and attention —
and that work is a few percent of these small models' total (the
encoder, 32 wide, has the largest share).
"""

import pytest

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from torch_slice_encoder import encoder as _encoder


@pytest.fixture(autouse=True)
def _cpu():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def test_linear_exact_as_in_jax():
    assert pt.flops(pt.nn.Linear(64, 32), [8, 64]) == \
        2 * 8 * 64 * 32 + 8 * 32 == jp.flops(jp.nn.Linear(64, 32), [8, 64])
    assert pt.Model(pt.nn.Linear(16, 4)).flops([2, 16]) == \
        2 * 2 * 16 * 4 + 2 * 4


def test_products_convs_and_relus_exact():
    def net(P):
        return P.nn.Sequential(P.nn.Conv2D(3, 8, 3), P.nn.ReLU(),
                               P.nn.Conv2D(8, 4, 3, stride=2), P.nn.Flatten(),
                               P.nn.Linear(4 * 5 * 5, 10))

    size = [2, 3, 14, 14]
    assert pt.flops(net(pt), size) == jp.flops(net(jp), size)


def test_padded_conv_counts_no_tap_on_the_padding():
    size = [1, 3, 8, 8]
    got = pt.flops(pt.nn.Conv2D(3, 4, 3, padding=1, bias_attr=False), size)
    assert got == jp.flops(jp.nn.Conv2D(3, 4, 3, padding=1,
                                        bias_attr=False), size)
    assert got == 2 * 4 * 3 * 22 * 22   # 22 valid (output, tap) pairs/axis


def _on_float_ids(P, model, cast):
    """The encoder behind a cast of its input to ids (``flops`` feeds a
    float32 zero input)."""
    class OnFloatIds(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.m = model

        def forward(self, x):
            return self.m(cast(x))

    return OnFloatIds()


CASES = {
    "lenet": (lambda P: __import__(
        f"{P.__name__}.vision.models", fromlist=["LeNet"]).LeNet(),
        [4, 1, 28, 28]),
    "encoder": (lambda P: _on_float_ids(
        P, _encoder(P), (lambda x: x.astype("int32")) if P is jp
        else (lambda x: x.long())), [4, 16]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_models_within_five_percent_of_xla(name):
    build, size = CASES[name]
    ref = jp.flops(build(jp), size)
    got = pt.flops(build(pt), size)
    assert abs(got - ref) <= 0.05 * ref, (got, ref)
