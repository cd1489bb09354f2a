"""paddle.jit — port of ``paddle_tpu/jit`` (reference: python/paddle/jit):
``to_static`` on ``torch.compile``, ``save``/``load`` on ``torch.export``
(see ``api.py``). The JAX package's AST splitter (``partial_graph.py``)
has no file here: Dynamo's graph breaks resume compiled execution."""

from .api import (  # noqa: F401
    StaticFunction,
    TranslatedLayer,
    functional_call,
    ignore_module,
    load,
    not_to_static,
    save,
    to_static,
)


def set_code_level(level=100, also_to_stdout=False):
    """Dy2static debug logging (reference: jit/set_code_level): kept for
    the API; Dynamo's own logs (``TORCH_LOGS``) show the captured graphs."""


def set_verbosity(level=0, also_to_stdout=False):
    pass


def enable_to_static(enable_to_static_bool=True):
    from . import api

    api._to_static_enabled[0] = bool(enable_to_static_bool)
