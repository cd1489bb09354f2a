"""Port CNN zoo (paddle_tpu_torch.vision.models: VGG with and without
BatchNorm, MobileNetV1/V2, AlexNet, SqueezeNet) against the JAX package's:
every factory's eval-mode forward on carried weights (fp32, CPU), at the
JAX package's own zoo-test sizes (tests/test_audio_text_vision.py:123-139:
64 px; 96 px for AlexNet and SqueezeNet). The JAX models' initial weights
are drawn from numpy (``torch_nn_parity.numpy_draws``), then carried to
the port.

Tolerance: max abs error of the logits <= 1e-5 x max(1, max |jax|) (fp32,
only summation orders differ).
"""

import pytest
import torch

import paddle_tpu as paddle
from test_torch_vision import JV, TV, _close, _images, _jax_forward
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer
from torch_nn_parity import numpy_draws

torch.set_num_threads(1)


def _pair(name, **kw):
    paddle.seed(7)
    with numpy_draws(7):
        jm = getattr(JV, name)(**kw)
    tm = getattr(TV, name)(device="cpu", seed=7, **kw)
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm

ZOO = [("vgg11", 64, {}), ("vgg13", 64, {}), ("vgg16", 64, {}),
       ("vgg19", 64, {}), ("vgg11", 64, dict(batch_norm=True)),
       ("vgg13", 64, dict(batch_norm=True)),
       ("vgg16", 64, dict(batch_norm=True)),
       ("vgg19", 64, dict(batch_norm=True)), ("mobilenet_v1", 64, {}),
       ("mobilenet_v2", 64, {}), ("alexnet", 96, {}),
       ("squeezenet1_0", 96, {}), ("squeezenet1_1", 96, {})]


@pytest.mark.parametrize("name,size,kw", ZOO,
                         ids=[f"{n}{'_bn' if k else ''}" for n, _, k in ZOO])
def test_zoo_factory_eval_forward_matches_jax(name, size, kw):
    """VGG's adaptive pool upsamples 2 x 2 to 7 x 7 at 64 px."""
    jm, tm = _pair(name, num_classes=7, **kw)
    x = _images(3, size, 3, n=1)
    ref, _ = _jax_forward(jm, x)
    tm.eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert tuple(out.shape) == (1, 7)
    _close(out, ref)
