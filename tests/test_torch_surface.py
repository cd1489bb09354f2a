"""The eager top level is whole: every public name of ``paddle_tpu``'s top
level is on ``paddle_tpu_torch`` or raises ``later_slice`` naming its
ROADMAP item (only ``DataParallel``, item 6, is left); ``jit``,
``static``, ``to_static``, ``enable_static`` and ``onnx`` are ported (item
8.5) and work. Left out are the JAX package's internals, which the port
(importing no JAX) has not: ``jax``, ``jnp``, ``next_key``, ``native`` and
``wrap``; ``extras`` / ``toplevel_extras`` are the modules' names and
exist on both.

The packages of item 8.6-8.8 (``incubate.nn.functional``,
``quantization``, ``incubate.asp``, ``sparse``, ``distribution``,
``geometric``, ``text``, ``dataset``, ``hub``, ``utils``, ``version`` and
the transforms) are whole too: each public name that the JAX module
defines or lists in ``__all__`` (not the names it imports, such as
``jax``, ``jnp`` or ``Tensor``) resolves in the port's module of the same
path.
"""

import re

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt

INTERNAL = {"jax", "jnp", "next_key", "native", "wrap"}
NAMES = sorted(n for n in dir(jp) if not n.startswith("_")
               and n not in INTERNAL)


def test_the_jax_top_level_is_large():
    assert len(NAMES) > 500


@pytest.mark.parametrize("name", NAMES)
def test_name_is_ported_or_names_its_item(name):
    try:
        getattr(pt, name)
    except NotImplementedError as e:
        assert re.search(r"item (8\.[5-8]|6)\b", str(e)), str(e)
        return
    assert hasattr(pt, name)


def test_refusals_are_the_listed_ones():
    refused = []
    for name in NAMES:
        try:
            getattr(pt, name)
        except NotImplementedError:
            refused.append(name)
    assert sorted(refused) == ["DataParallel"]


PACKAGES = ("incubate.nn.functional", "quantization", "incubate.asp",
            "sparse", "distribution", "distribution.extras", "geometric",
            "text", "dataset", "dataset.common", "dataset.uci_housing",
            "dataset.mnist", "dataset.cifar", "hub", "utils",
            "utils.custom_op", "utils.cpp_extension", "version",
            "vision.transforms")


def _defined_names(mod):
    """The public names ``mod`` defines (or lists in ``__all__``), not the
    ones it imports from elsewhere."""
    import types

    names = set(getattr(mod, "__all__", ()))
    for n in dir(mod):
        if n.startswith("_"):
            continue
        obj = getattr(mod, n)
        owner = getattr(obj, "__module__", None)
        if isinstance(obj, types.ModuleType):
            owner = obj.__name__
        if owner is not None and owner.startswith(mod.__name__):
            names.add(n)
    return sorted(names)


PACKAGE_NAMES = []
for _pkg in PACKAGES:
    import importlib

    _jm = importlib.import_module(f"paddle_tpu.{_pkg}")
    PACKAGE_NAMES += [(_pkg, n) for n in _defined_names(_jm)]


def test_the_packages_have_their_names():
    assert len(PACKAGE_NAMES) > 200
    assert ("incubate.nn.functional", "fused_multi_transformer") \
        in PACKAGE_NAMES


@pytest.mark.parametrize("pkg,name", PACKAGE_NAMES)
def test_package_name_is_ported(pkg, name):
    import importlib

    mod = importlib.import_module(f"paddle_tpu_torch.{pkg}")
    getattr(mod, name)


def test_flops_and_model_flops():
    net = pt.nn.Linear(64, 32, device="cpu")
    assert pt.flops(net, [8, 64]) == 2 * 8 * 64 * 32 + 8 * 32
    assert pt.Model(net).flops([2, 64]) == 2 * 2 * 64 * 32 + 2 * 32


def _jit_works():
    import numpy as np

    sf = pt.to_static(lambda x: x * 3.0)
    out = sf(pt.to_tensor(np.ones(2, np.float32)))
    assert sf is not None and float(out.sum()) == 6.0
    assert pt.jit.to_static is pt.to_static


def _static_works():
    import numpy as np

    pt.enable_static()
    try:
        assert pt.in_static_mode()
        main = pt.static.Program()
        with pt.static.program_guard(main):
            y = pt.static.data("x", [2], "float32") + 1.0
        (o,) = pt.static.Executor().run(
            main, feed={"x": np.ones(2, np.float32)}, fetch_list=[y])
        assert o.tolist() == [2.0, 2.0]
    finally:
        pt.disable_static()
    assert pt.in_dynamic_mode()


def _onnx_works():
    assert callable(pt.onnx.export)


@pytest.mark.parametrize("name,check", [
    ("jit", _jit_works), ("to_static", _jit_works),
    ("static", _static_works), ("enable_static", _static_works),
    ("onnx", _onnx_works)])
def test_the_jit_and_static_names_work(name, check):
    from paddle_tpu_torch import device as pt_device

    assert getattr(pt, name) is not None
    prev = pt_device._PLACE
    pt.set_device("cpu")
    try:
        check()
    finally:
        pt_device._PLACE = prev


def test_top_level_odds_and_ends():
    pt.set_device("cpu")
    try:
        p = pt.create_parameter([3, 4], "float32")
        assert isinstance(p, pt.Parameter) and not p.stop_gradient
        b = pt.create_parameter([4], is_bias=True)
        assert float(b.abs().sum()) == 0.0
        t = pt.create_tensor("int32")
        assert t.dtype == torch.int32 and t.shape == ()
        assert pt.in_dynamic_mode() and not pt.in_static_mode()
        assert pt.disable_static() is None
        assert pt.is_compiled_with_cuda() and not pt.is_compiled_with_rocm()
        assert not pt.is_compiled_with_xpu() and \
            not pt.is_compiled_with_cinn()
        assert pt.is_compiled_with_distribute()
        assert pt.device_count() == torch.cuda.device_count()
        pt.set_printoptions(precision=3)
        assert torch._tensor_str.PRINT_OPTS.precision == 3
        pt.set_printoptions(precision=4)
        assert repr(pt.CPUPlace()) == "Place(cpu)"
        assert pt.to_tensor([1.0], place=pt.CPUPlace()).device.type == "cpu"
        with pytest.raises(ValueError, match="TPUPlace"):
            pt.to_tensor([1.0], place=pt.TPUPlace())
        assert pt.Model is pt.hapi.Model
        net = pt.nn.Linear(3, 2)
        info = pt.summary(net, (1, 3))
        assert info["total_params"] == 8
        for pkg in ("hapi", "vision", "inference", "incubate",
                    "observability", "distributed", "audio", "fft", "signal",
                    "profiler"):
            assert getattr(pt, pkg).__name__ == f"paddle_tpu_torch.{pkg}"
    finally:
        from paddle_tpu_torch import device as pt_device

        pt_device._PLACE = None
