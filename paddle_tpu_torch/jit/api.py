"""paddle.jit — ``to_static`` / ``save`` / ``load``; port of
``paddle_tpu/jit/api.py`` (reference: python/paddle/jit/api.py:195).

``to_static(fn)`` functionalizes the layer (its parameters and buffers,
in ``_collect_state``'s ``P:``/``B:`` order, become inputs of the region
through ``torch.nn.utils.stateless._reparametrize_module``) and compiles
it with ``torch.compile(fullgraph=full_graph, dynamic=False)``: Dynamo
captures the forward once per input signature (a new shape or AMP state
recompiles, a seen one is cached), and AOTAutograd gives the compiled
backward as one node of torch's tape, where the JAX package records one
``jax.jit`` of the forward and one of its vjp. Paddle tensors are unwrapped
at the region's boundary and its outputs wrapped after the call (the
dispatcher returns plain tensors inside a traced region), as JAX's
``_tree_unwrap`` / ``_tree_wrap`` do.

The backend follows the tensors' device: Inductor on CUDA tensors,
``aot_eager`` (the same Dynamo capture and joint graph, no code
generation) on CPU tensors. There is no quiet eager path: Dynamo's errors
are not suppressed, and a function that reaches the recompile limit
(``RECOMPILE_LIMIT`` signatures) raises instead of running eagerly.

Graph breaks: ``full_graph=True`` raises on value-dependent control flow,
as JAX raises its tracer errors. ``full_graph=False`` resumes compiled
execution after the break with Dynamo's own graph breaks (where the JAX
package splits the AST, ``jit/partial_graph.py``) and warns once
("graph break ... split into compiled subgraphs"); a function of which
Dynamo compiled no graph at all runs eagerly from then on, with the JAX
package's "falling back to eager" warning.

``save`` writes ``path.pdiparams``, the ``P:``/``B:`` state through
``framework.io.save`` (JAX's layout: either package loads it), and, with
an ``input_spec``, ``path.pdmodel``: ``torch.export.save`` of the
exported forward over ``(state, inputs)`` at the spec's shapes, traced
without gradients, so the primal flash attention is the custom op
``paddle_tpu_torch::flash_fwd``. A ``.pdmodel`` is read only by the
package that wrote it (the JAX package's is a ``jax.export`` StableHLO
artifact). ``load`` registers the port's custom ops first and returns a
``Layer`` that runs the program on the current place.
"""

from __future__ import annotations

import functools
import types
import warnings
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils import _pytree as pytree

from ..core.tensor import Tensor, unwrap
from ..nn.layer.layers import Layer

#: signatures one compiled function may hold before a new one raises
#: (JAX retraces without limit; Dynamo's default of 8 would run eagerly)
RECOMPILE_LIMIT = 64

# global to_static switch (paddle.jit.enable_to_static): False -> every
# StaticFunction runs its original eager body
_to_static_enabled = [True]


def _collect_state(layer):
    """Ordered (names, tensors) for params + buffers."""
    names, tensors = [], []
    for n, p in layer.named_parameters():
        names.append("P:" + n)
        tensors.append(p)
    for n, b in layer.named_buffers():
        names.append("B:" + n)
        tensors.append(b)
    return names, tensors


def _swap(layer, names, state):
    """The context that puts ``state`` (a flat list in ``names``' order)
    into the layer's parameters and buffers."""
    return _reparametrize_module(
        layer, {n[2:]: t for n, t in zip(names, state)})


def functional_call(layer, fn: Callable, state_arrays, *args, **kwargs):
    """Run ``fn`` with layer state replaced by ``state_arrays`` (a flat
    list in ``_collect_state``'s order)."""
    names, _ = _collect_state(layer)
    with _swap(layer, names, state_arrays):
        return fn(*args, **kwargs)


def _tree_unwrap(x):
    return pytree.tree_map(unwrap, x)


def _tree_wrap(x):
    return pytree.tree_map(
        lambda v: v.as_subclass(Tensor) if isinstance(v, torch.Tensor)
        and not isinstance(v, Tensor) else v, x)


def _backend_for(tensors) -> str:
    """Inductor on CUDA tensors, aot_eager on CPU ones."""
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return "inductor" if t.device.type == "cuda" else "aot_eager"
    from ..device import resolve_device

    return "inductor" if resolve_device().type == "cuda" else "aot_eager"


def _graph_breaks() -> Dict[str, int]:
    return dict(torch._dynamo.utils.counters["graph_break"])


def _config():
    """Dynamo's settings for a compiled call: errors raise, and the
    recompile limit raises instead of running the frame eagerly."""
    return torch._dynamo.config.patch(
        suppress_errors=False, recompile_limit=RECOMPILE_LIMIT,
        fail_on_recompile_limit_hit=True)


def _region(sf, state, args, kwargs):
    """The traced region: the function, the layer's state swapped in.
    Each StaticFunction runs its own copy of this code object, so Dynamo's
    cache and recompile count are its own."""
    if sf._layer is None:
        return sf._orig_fn(*args, **kwargs)
    with _swap(sf._layer, sf._names, state):
        return sf._orig_fn(*args, **kwargs)


class StaticFunction:
    """A compiled callable with Paddle's ``to_static`` UX."""

    def __init__(self, function, input_spec=None, build_strategy=None,
                 backend=None, full_graph=True, property=False):
        self._orig_fn = function
        self._layer: Optional[Layer] = None
        if hasattr(function, "__self__") and isinstance(function.__self__,
                                                         torch.nn.Module):
            self._layer = function.__self__
        elif isinstance(function, torch.nn.Module):
            self._layer = function
            self._orig_fn = function.forward
        self._names: List[str] = []
        self._input_spec = input_spec
        self._full_graph = full_graph
        self._fallback_eager = False
        self._compiled: Dict[str, Callable] = {}
        self._keys: List[Any] = []   # one per compiled graph
        self._graphs = 0
        self._warned = False
        functools.update_wrapper(self, self._orig_fn)

    @property
    def forward(self):
        return self

    def _state(self):
        if self._layer is None:
            return [], []
        names, tensors = _collect_state(self._layer)
        self._names = names
        return names, tensors

    def _backend(self, name):
        """The backend ``name`` behind a counter of compiled graphs."""
        real = torch._dynamo.lookup_backend(name)

        def backend(gm, example_inputs):
            self._graphs += 1
            self._keys.append((name, tuple(
                (tuple(t.shape), str(t.dtype)) for t in example_inputs
                if isinstance(t, torch.Tensor))))
            return real(gm, example_inputs)

        return backend

    def _compiled_fn(self, backend):
        fn = self._compiled.get(backend)
        if fn is None:
            code = _region.__code__.replace()   # a code object of its own
            name = getattr(self._orig_fn, "__name__", "fn")
            region = types.FunctionType(code, _region.__globals__,
                                        f"to_static_{name}")
            fn = torch.compile(region, backend=self._backend(backend),
                               fullgraph=self._full_graph, dynamic=False)
            self._compiled[backend] = fn
        return fn

    def __call__(self, *args, **kwargs):
        if self._fallback_eager or not _to_static_enabled[0]:
            return self._orig_fn(*args, **kwargs)
        return self._compiled_call(args, kwargs)

    def _compiled_call(self, args, kwargs):
        _, tensors = self._state()
        state = [unwrap(t) for t in tensors]
        in_args, in_kwargs = _tree_unwrap(args), _tree_unwrap(kwargs)
        fn = self._compiled_fn(_backend_for(
            state + pytree.tree_leaves((in_args, in_kwargs))))
        watch = not (self._full_graph or self._warned)
        breaks, graphs = _graph_breaks() if watch else None, self._graphs
        with _config():
            out = fn(self, state, in_args, in_kwargs)
        if watch:
            after = _graph_breaks()
            new = [r for r, n in after.items() if n > breaks.get(r, 0)]
            if new or self._graphs - graphs > 1:
                self._warn_break(graphs, new)
        return _tree_wrap(out)

    def _warn_break(self, graphs_before, reasons):
        """The JAX package's warnings: Dynamo resumed compiled execution
        after the break, or compiled nothing of this function (it then
        runs eagerly from here on)."""
        self._warned = True
        name = getattr(self._orig_fn, "__name__", "?")
        reasons = "; ".join(sorted(r.splitlines()[0][:120] for r in reasons)
                            ) or "Dynamo split the function"
        if self._graphs > graphs_before:
            warnings.warn(
                f"to_static: graph break in {name} ({reasons}) — split into "
                f"compiled subgraphs with an eager bridge at the breaking "
                f"statement (Dynamo's graph breaks).")
            return
        warnings.warn(
            f"to_static: graph break in {name} ({reasons}) — falling back "
            f"to eager execution. Use paddle.where-style control flow to "
            f"stay compiled.")
        self._fallback_eager = True

    def cache_keys(self):
        """One ``(backend, graph input signature)`` key per compiled graph
        (a function recompiled for every call shows many)."""
        return list(self._keys)

    @property
    def traces(self) -> int:
        """Graphs Dynamo captured for this function so far."""
        return self._graphs

    def concrete_program(self):
        return None

    @property
    def code(self):
        import inspect

        try:
            return inspect.getsource(self._orig_fn)
        except Exception:
            return "<source unavailable>"


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, **kwargs):
    """Decorator / wrapper turning a dygraph callable into a compiled
    one; a ``Layer`` gets its ``forward`` replaced and is returned."""

    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            sf = StaticFunction(fn, input_spec, build_strategy, backend,
                                full_graph)
            fn.forward = sf
            return fn
        return StaticFunction(fn, input_spec, build_strategy, backend,
                              full_graph)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    pass


class _Exported(torch.nn.Module):
    """The exported forward over ``(state, *inputs)``; the layer is held
    outside torch's registries, so its own tensors are not the program's
    parameters."""

    def __init__(self, sf):
        super().__init__()
        object.__setattr__(self, "_sf", sf)

    def forward(self, state, *inputs):
        return _region(self._sf, state, inputs, {})


def _spec_tensor(spec, device):
    from ..core.dtype import convert_dtype

    shape = list(spec.shape or [])
    if any(s is None or int(s) < 0 for s in shape):
        raise ValueError(f"jit.save: input_spec {spec} needs concrete dims "
                         f"(the exported program serves one shape)")
    return torch.zeros(shape, dtype=convert_dtype(spec.dtype) if isinstance(
        spec.dtype, str) else spec.dtype, device=device)


def save(layer, path, input_spec=None, **configs):
    """jit.save (reference: jit/api.py). Writes ``path + '.pdiparams'`` (the
    state dict, ``framework.io``'s format) and, with ``input_spec``,
    ``path + '.pdmodel'`` (``torch.export.save`` of the forward)."""
    from ..framework import io as fio

    if isinstance(layer, StaticFunction):
        sf = layer
        target = sf._layer
    elif isinstance(layer, torch.nn.Module):
        target = layer
        sf = layer.forward if isinstance(layer.forward, StaticFunction) \
            else StaticFunction(layer)
    else:
        raise TypeError("jit.save expects a Layer or @to_static function")

    # save exactly the state list the export takes (params + every buffer,
    # non-persistable ones too): state_dict() skips non-persistable buffers
    # and would desync the Predictor's state/input split
    names, tensors = sf._state() if target is not None else ([], [])
    fio.save(dict(zip(names, tensors)), path + ".pdiparams")
    if not input_spec:
        return
    from ..device import resolve_device

    state = [unwrap(t).detach() for t in tensors]
    device = state[0].device if state else resolve_device()
    inputs = [_spec_tensor(s, device) for s in input_spec]
    with torch.no_grad():
        ep = torch.export.export(_Exported(sf), (state, *inputs))
    torch.export.save(ep, path + ".pdmodel")


def load_program(path, device=None, params_file=None):
    """``(exported program module, state list, input metadata, output
    metadata)`` of a ``jit.save`` artifact (the state from
    ``params_file`` when given), on ``device`` (default: the current
    place). Imports the port's ops first, so their custom ops are
    registered."""
    from .. import ops  # noqa: F401  (registers paddle_tpu_torch::*)
    from ..device import resolve_device
    from ..framework import io as fio

    dev = torch.device(device) if device is not None else resolve_device()
    try:
        ep = torch.export.load(path + ".pdmodel")
    except FileNotFoundError:
        raise FileNotFoundError(
            f"{path}.pdmodel not found — jit.save with input_spec produces "
            f"the serving artifact") from None
    state = [t.to(dev) for t in fio.load(
        params_file or path + ".pdiparams").values()]
    placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"]
    n_user = len(ep.graph_signature.user_inputs)
    saved = next((v.device for v in (n.meta.get("val") for n in placeholders)
                  if isinstance(v, torch.Tensor)), dev)
    if saved != dev:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, dev)
    metas = [n.meta["val"] for n in placeholders[-n_user:]]
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    outs = [a.meta["val"] for a in pytree.tree_leaves(out_node.args)
            if hasattr(a, "meta")]
    return ep.module(), state, metas[len(state):], outs


class TranslatedLayer(Layer):
    """Result of jit.load: a Layer driving an exported program on the
    current place."""

    def __init__(self, module, state):
        super().__init__()
        object.__setattr__(self, "_program", module)
        self._state = state

    def forward(self, *args):
        with torch.no_grad():
            out = self._program(self._state, *_tree_unwrap(args))
        return _tree_wrap(out)


def load(path, **configs):
    """jit.load — a TranslatedLayer over the saved program and state."""
    module, state, _, _ = load_program(path)
    return TranslatedLayer(module, state)
