"""Utilities — port of ``paddle_tpu/utils``: ``try_import``,
``run_check``, ``custom_op`` and ``cpp_extension``."""

from . import cpp_extension  # noqa: F401
from .custom_op import custom_op  # noqa: F401

__all__ = ["cpp_extension", "custom_op", "run_check", "try_import"]


def try_import(name: str):
    """The module ``name``, or None when it cannot be imported."""
    import importlib

    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def run_check() -> None:
    """Check the installation end to end on the current place: five SGD
    steps of a small linear model must lower its loss, and on a CUDA
    device one forward of the flash attention kernel (K1) must match its
    plain version. The process's random state is restored after."""
    import numpy as np
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.ops import flash_attention, flash_attention_reference

    print("Running verify paddle_tpu_torch program ... ")
    dev = resolve_device()
    rng_state = paddle.get_rng_state()
    paddle.seed(0)
    try:
        lin = paddle.nn.Linear(4, 1)
        opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=lin.parameters())
        rng = np.random.default_rng(0)
        x = paddle.to_tensor(rng.standard_normal((16, 4)).astype(np.float32))
        y = paddle.to_tensor(rng.standard_normal((16, 1)).astype(np.float32))
        first = last = None
        for _ in range(5):
            loss = ((lin(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            last = float(loss)
            first = first if first is not None else last
        if not (np.isfinite(last) and last < first):
            raise RuntimeError(f"verification train loop failed to "
                               f"improve: {first} -> {last}")
        if dev.type == "cuda":
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn((1, 128, 2, 64), generator=g, device=dev,
                                   dtype=torch.bfloat16) for _ in range(3))
            with torch.no_grad():
                out = flash_attention(q, k, v, causal=True)
            ref = flash_attention_reference(q, k, v, causal=True)
            err = float((out.float() - ref.float()).abs().max())
            if not err <= 2e-2:
                raise RuntimeError(f"the flash attention kernel is off its "
                                   f"plain version by {err}")
    finally:
        paddle.set_rng_state(rng_state)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "CPU")
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    extra = "" if n == 1 else f" ({n} devices visible; exercised {dev})"
    print(f"paddle_tpu_torch works well on 1 {kind}{extra}.")
    print("paddle_tpu_torch is installed successfully! Let's start deep "
          "learning with paddle_tpu_torch now.")
