"""``paddle_tpu_torch.inference``'s deployment API (``Config``,
``create_predictor``, ``Predictor``, ``PredictorTensor``) over the port's
``jit.save`` artifact against the JAX package's Predictor over its own
artifact from the same weights: every case of tests/test_inference.py has a
counterpart. CPU, fp32.

Tolerances: the Predictor's outputs within 1e-5 relative of the eager
layer's and of JAX's Predictor (fp32, matmuls summed in other orders);
with ``enable_bf16`` within 3e-2 (bf16 weights: ~8 bits of mantissa).
The ``.pdiparams`` file is one format in both packages (each loads the
other's); a ``.pdmodel`` is read only by the package that wrote it (a
``torch.export`` program here, a ``jax.export`` artifact in JAX).
"""

import subprocess
import sys

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch import inference
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer
from torch_slice_encoder import ENC_BATCH, ENC_SEQ, encoder_pair

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                           P.nn.Linear(16, 4))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The MLP saved by both packages from the same weights: (port net,
    port path, JAX path)."""
    prev = pt_device._PLACE
    pt.set_device("cpu")
    try:
        jnet, net = _mlp(jp), _mlp(pt)
        load_jax_state(net, state_from_jax_layer(jnet))
        d = tmp_path_factory.mktemp("infer")
        jp.jit.save(jnet, str(d / "jax"),
                    input_spec=[jp.static.InputSpec([2, 8], "float32")])
        pt.jit.save(net, str(d / "port"),
                    input_spec=[pt.static.InputSpec([2, 8], "float32")])
    finally:
        pt_device._PLACE = prev
    return net, str(d / "port"), str(d / "jax")


def _x(*shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_predictor_handle_api(saved):
    net, path, jpath = saved
    pred = inference.create_predictor(inference.Config(path))
    assert pred.get_input_names() == ["x0"]
    assert pred.get_input_handle("x0").shape() == [2, 8]
    x = _x(2, 8)
    h = pred.get_input_handle("x0")
    h.copy_from_cpu(x)
    assert pred.run() is None
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_allclose(out, net(pt.to_tensor(x)).numpy(), rtol=1e-5)
    jpred = jp.inference.create_predictor(jp.inference.Config(jpath))
    (jout,) = jpred.run([x])
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-6)


def test_predictor_direct_run(saved):
    net, path, _ = saved
    pred = inference.create_predictor(inference.Config(path + ".pdmodel"))
    x = _x(2, 8, seed=1)
    (out,) = pred.run([x])
    np.testing.assert_allclose(out, net(pt.to_tensor(x)).numpy(), rtol=1e-5)


def test_predictor_shape_mismatch_raises(saved):
    pred = inference.create_predictor(inference.Config(saved[1]))
    with pytest.raises(ValueError, match="exported"):
        pred.run([np.zeros((3, 8), np.float32)])


def test_predictor_place_from_config(saved):
    """``disable_gpu`` runs on the CPU whatever the current place;
    ``enable_use_gpu`` names a card, which this CPU machine lacks."""
    pt_device._PLACE = None   # the default place: the card
    cfg = inference.Config(saved[1])
    cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    assert pred._state[0].device.type == "cpu"
    pred.run([_x(2, 8)])
    cfg.enable_use_gpu(100, 0)
    assert cfg._device == "cuda:0"


def test_predictor_unset_input_raises(saved):
    pred = inference.create_predictor(inference.Config(saved[1]))
    with pytest.raises(RuntimeError, match="inputs not set"):
        pred.run()


def test_predictor_with_non_persistable_buffer(tmp_path):
    class Net(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = pt.nn.Linear(4, 2)
            self.register_buffer("offset",
                                 pt.to_tensor(np.ones(2, np.float32)),
                                 persistable=False)

        def forward(self, x):
            return self.lin(x) + self.offset

    net = Net()
    path = str(tmp_path / "buf")
    pt.jit.save(net, path,
                input_spec=[pt.static.InputSpec([2, 4], "float32")])
    pred = inference.create_predictor(inference.Config(path))
    assert len(pred.get_input_names()) == 1  # the buffer is state
    x = _x(2, 4)
    (out,) = pred.run([x])
    np.testing.assert_allclose(out, net(pt.to_tensor(x)).numpy(), rtol=1e-5)


def test_predictor_arity_check(saved):
    pred = inference.create_predictor(inference.Config(saved[1]))
    with pytest.raises(ValueError, match="expected 1 inputs"):
        pred.run([np.zeros((2, 8), np.float32)] * 2)


def test_predictor_bf16(saved):
    net, path, _ = saved
    config = inference.Config(path)
    config.enable_bf16()
    pred = inference.create_predictor(config)
    assert all(s.dtype == torch.bfloat16 for s in pred._state)
    x = _x(2, 8, seed=2)
    (out,) = pred.run([x])
    np.testing.assert_allclose(out, net(pt.to_tensor(x)).numpy(),
                               rtol=3e-2, atol=3e-2)


def test_predictor_donate_inputs(saved):
    """The knob is kept; the weights survive every run and the outputs
    equal the plain predictor's bit for bit, bf16 composed too."""
    net, path, _ = saved
    config = inference.Config(path)
    config.enable_donate_inputs()
    assert config._donate_inputs is True
    pred = inference.create_predictor(config)
    ref = inference.create_predictor(inference.Config(path))
    x = _x(2, 8, seed=3)
    (out1,) = pred.run([x])
    (out2,) = pred.run([x])
    (want,) = ref.run([x])
    np.testing.assert_array_equal(out1, want)
    np.testing.assert_array_equal(out2, want)
    cfg2 = inference.Config(path)
    cfg2.enable_bf16()
    cfg2.enable_donate_inputs()
    (out3,) = inference.create_predictor(cfg2).run([x])
    np.testing.assert_allclose(out3, net(pt.to_tensor(x)).numpy(),
                               rtol=3e-2, atol=3e-2)


def test_pdiparams_cross_load(saved, tmp_path):
    """A JAX ``.pdiparams`` read by the port's ``framework.load``, and the
    reverse: the same names and values."""
    _, path, jpath = saved
    a = pt.load(jpath + ".pdiparams")
    b = jp.load(path + ".pdiparams")
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k].numpy()))


def test_encoder_predictor_matches_jax(tmp_path):
    """The slice as a whole: the 2-layer encoder saved by each package
    from the same weights, each Predictor's logits on the same ids."""
    jm, tm, ids, _ = encoder_pair()
    spec = [ENC_BATCH, ENC_SEQ]
    jm.eval()
    tm.eval()
    jp.jit.save(jm, str(tmp_path / "jax"),
                input_spec=[jp.static.InputSpec(spec, "int32")])
    pt.jit.save(tm, str(tmp_path / "port"),
                input_spec=[pt.static.InputSpec(spec, "int64")])
    (jout,) = jp.inference.create_predictor(
        jp.inference.Config(str(tmp_path / "jax"))).run(
            [ids.astype(np.int32)])
    pred = inference.create_predictor(inference.Config(str(tmp_path /
                                                           "port")))
    (out,) = pred.run([ids])
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)
    loaded = pt.jit.load(str(tmp_path / "port"))
    np.testing.assert_allclose(loaded(pt.to_tensor(ids)).numpy(), out,
                               rtol=1e-6)
    with pytest.raises(RuntimeError, match="ONNX"):
        pt.onnx.export(tm, str(tmp_path / "m.onnx"),
                       input_spec=[pt.static.InputSpec(spec, "int64")])
    assert (tmp_path / "m.pdmodel").exists()


def test_load_in_a_fresh_process_importing_only_inference(saved):
    """A ``.pdmodel`` runs in a process that imports only
    ``paddle_tpu_torch.inference`` (the custom ops register on load)."""
    net, path, _ = saved
    x = _x(2, 8, seed=4)
    code = (
        "import sys, numpy as np\n"
        "import paddle_tpu_torch.inference as inf\n"
        "x = np.random.default_rng(4).random((2, 8)).astype(np.float32)\n"
        f"cfg = inf.Config({path!r})\n"
        "cfg.disable_gpu()\n"
        "(o,) = inf.create_predictor(cfg).run([x])\n"
        "sys.stdout.write(' '.join(repr(float(v)) for v in o.ravel()))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    got = np.array([float(v) for v in res.stdout.split()]).reshape(2, 4)
    np.testing.assert_allclose(got, net(pt.to_tensor(x)).numpy(), rtol=1e-5)
