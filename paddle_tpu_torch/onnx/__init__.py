"""paddle.onnx — port of ``paddle_tpu/onnx/__init__.py``.

Parity anchor: python/paddle/onnx/export.py:33 (``paddle.onnx.export``),
which delegates ONNX serialization to the external paddle2onnx package
(the reference itself raises without it).

:func:`export` traces the layer as ``jit.save`` does (``input_spec``
shapes) and writes that artifact at the requested path (``path.pdmodel``,
a ``torch.export`` program, and ``path.pdiparams``); ``inference.Predictor``
loads it. The ONNX serialization itself is not in the repository, so
``export`` always raises after writing the artifact, naming what exists.
"""

from __future__ import annotations

__all__ = ["export"]


def export(layer, path: str, input_spec=None, opset_version: int = 9,
           **configs):
    """Write the ``jit.save`` artifact of ``layer`` at ``path`` (a trailing
    ``.onnx`` dropped), then raise: ONNX serialization is not
    implemented in the repository (the reference hard-depends on the
    external paddle2onnx converter for this step)."""
    from ..jit.api import save as jit_save

    if path.endswith(".onnx"):
        path = path[:-5]
    jit_save(layer, path, input_spec=input_spec)
    raise RuntimeError(
        f"paddle_tpu_torch.onnx.export: traced artifact saved at {path!r} "
        "(path.pdmodel, a torch.export program, and path.pdiparams; "
        "loadable by paddle_tpu_torch.inference.Predictor and jit.load). "
        "ONNX serialization is not implemented in the repository (the "
        "reference likewise hard-depends on the external paddle2onnx "
        "converter for this step)")
