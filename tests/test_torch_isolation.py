"""The port stands alone: nothing under paddle_tpu_torch/ (the serving
recovery, fleet and disagg modules and the fault plan included), and none of
chip_smoke.py, profile_serving.py and profile_training.py, imports JAX or
the JAX package;
importing the whole port loads no JAX; and entry points never fall back to
the CPU silently."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                     BertForSequenceClassification,
                                     GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.ops import _build

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "profile_serving.py",
              ROOT / "profile_training.py"]
    return files


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 8 and all(f.exists() for f in files)
    # the functional surfaces and the flags module are scanned too
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"paddle_tpu_torch/flags.py",
            "paddle_tpu_torch/nn/functional/flash_attention.py",
            "paddle_tpu_torch/nn/functional/extras.py",
            "paddle_tpu_torch/incubate/nn/functional/__init__.py",
            "paddle_tpu_torch/distributed/resilience/__init__.py",
            "paddle_tpu_torch/distributed/resilience/faults.py",
            "paddle_tpu_torch/distributed/resilience/watchdog.py",
            "paddle_tpu_torch/inference/recovery.py",
            "paddle_tpu_torch/inference/fleet.py",
            "paddle_tpu_torch/inference/disagg.py",
            "paddle_tpu_torch/models/gpt/modeling.py",
            "paddle_tpu_torch/models/gpt/__init__.py",
            "paddle_tpu_torch/models/bert/modeling.py",
            "paddle_tpu_torch/models/bert/__init__.py",
            "paddle_tpu_torch/models/_common.py",
            "paddle_tpu_torch/models/unet/modeling.py",
            "paddle_tpu_torch/nn/initializer.py",
            "paddle_tpu_torch/nn/clip.py",
            "paddle_tpu_torch/nn/functional/conv.py",
            "paddle_tpu_torch/nn/functional/pooling.py",
            "paddle_tpu_torch/nn/functional/norm.py",
            "paddle_tpu_torch/nn/functional/loss.py",
            "paddle_tpu_torch/nn/layer/norm.py",
            "paddle_tpu_torch/optimizer/optimizer.py",
            "paddle_tpu_torch/hapi/model.py",
            "paddle_tpu_torch/vision/models/lenet.py",
            "paddle_tpu_torch/vision/models/resnet.py",
            "paddle_tpu_torch/vision/models/vit.py",
            "paddle_tpu_torch/vision/models/zoo.py"} <= scanned
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import pkgutil, sys, paddle_tpu_torch\n"
        "from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,"
        " BertConfig, BertForMaskedLM, BertForSequenceClassification)\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,"
        " 'paddle_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules"
        " if k.startswith('paddle_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_entry_points_raise_without_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model._init_paged_caches(2, 32, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(model, max_batch=2, max_len=32, page_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(cfg, device="cuda")


def test_gpt_and_bert_raise_without_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    builds = [lambda dev: GPTForCausalLM(GPTConfig.tiny(), device=dev)]
    builds += [lambda dev, c=cls: c(BertConfig.tiny(), device=dev)
               for cls in (BertForMaskedLM, BertForSequenceClassification)]
    for build in builds:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(None)
        assert next(build("cpu").parameters()).device.type == "cpu"


def test_vision_and_diffusion_entry_points_raise_without_a_card():
    """Every model constructor and factory of the vision slice, and each
    layer with parameters, refuses a missing card unless ``device="cpu"``
    is asked for, and then builds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig
    from paddle_tpu_torch.vision import models as V

    builds = [lambda dev: V.LeNet(device=dev),
              lambda dev: V.VisionTransformer(V.ViTConfig.tiny(), device=dev),
              lambda dev: UNet2DConditionModel(UNetConfig.tiny(), device=dev),
              lambda dev: nn.Linear(2, 3, device=dev),
              lambda dev: nn.Conv2D(2, 3, 1, device=dev)]
    builds += [lambda dev, f=f: getattr(V, f)(device=dev, num_classes=4)
               for f in ("resnet18", "resnet34", "resnet50", "resnet101",
                         "resnet152", "squeezenet1_0", "squeezenet1_1",
                         "mobilenet_v1", "mobilenet_v2", "alexnet")]
    builds += [lambda dev, f=f: getattr(V, f)(device=dev, num_classes=0)
               for f in ("vgg11", "vgg13", "vgg16", "vgg19")]
    for build in builds:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(None)
    for i in (0, 1, 2, 3, 4, 5, 10, 15):   # the cheap ones, one a family
        assert next(iter(builds[i]("cpu").parameters())).device.type \
            == "cpu"
    for cls in (V.ResNet, V.MobileNetV1, V.MobileNetV2, V.AlexNet,
                V.SqueezeNet):
        args = (V.resnet.BasicBlock, 18) if cls is V.ResNet else ()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(*args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        V.VGG(nn.Sequential())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nn.BatchNorm2D(3)
    for factory in (V.vit_b_16, V.vit_l_16):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factory()


def test_kernel_build_raises_without_nvcc():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present: the kernels build here")
    if all(p.exists() for p in map(_build._library_path, _build.KERNELS)):
        pytest.skip("kernel libraries already built in this checkout")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
