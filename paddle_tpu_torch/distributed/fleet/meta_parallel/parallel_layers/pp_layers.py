"""Pipeline layer descriptions — port of ``paddle_tpu/distributed/fleet/
meta_parallel/parallel_layers/pp_layers.py`` (``LayerDesc``,
``SharedLayerDesc``, ``SegmentLayers``, ``PipelineLayer``).

As in the JAX package the stage partition is logical: ``PipelineLayer``
builds every layer, ``segment_parts`` says which stage runs which, and
``forward`` runs them all in order (the single-process form; the SPMD
pipeline over a ``pp`` mesh dim is ``auto_parallel.pipeline``). A
``SharedLayerDesc`` key builds its layer once; a later desc with the same
key runs that layer (through its ``forward_func``), so the weights are one
tensor.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from torch import nn

from .....nn.layer.layers import Layer, LayerList


class LayerDesc:
    def __init__(self, layer_class, *inputs, **kwargs):
        self.layer_class = layer_class
        self.inputs = inputs
        self.kwargs = kwargs
        if not issubclass(layer_class, nn.Module):
            raise TypeError("LayerDesc expects an nn.Layer subclass")

    def build_layer(self):
        return self.layer_class(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_class.__name__})"


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_class, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_class, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    def __init__(self, layers_desc, num_parts, method="uniform",
                 num_virtual_pipeline_stage=None):
        self.layers_desc = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self) -> List[int]:
        n = len(self.layers_desc)
        if self.method == "uniform":
            base = n // self.num_parts
            extra = n % self.num_parts
            bounds = [0]
            for i in range(self.num_parts):
                bounds.append(bounds[-1] + base + (1 if i < extra else 0))
            return bounds
        if self.method.startswith("layer:"):
            # every layer whose class name matches, evenly; the others
            # attach to the stages around them
            name = self.method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self.layers_desc)
                     if (isinstance(d, LayerDesc)
                         and d.layer_class.__name__ == name)]
            per = len(marks) // self.num_parts
            bounds = [0]
            for i in range(1, self.num_parts):
                bounds.append(marks[i * per])
            bounds.append(len(self.layers_desc))
            return bounds
        raise ValueError(f"unknown segment method {self.method}")


class PipelineLayer(Layer):
    """A stage-partitioned model from layer descriptions. ``num_stages``
    defaults to ``topology.get_pipe_parallel_world_size()`` when a
    topology is given (the JAX package reads fleet's hybrid group, which
    the port's ``fleet.init`` does not make yet), else 1."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None, **kwargs):
        super().__init__()
        self._layers_desc = list(layers)
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        if num_stages is None and topology is not None:
            num_stages = topology.get_pipe_parallel_world_size()
        self._num_stages = num_stages or 1
        seg = SegmentLayers(self._layers_desc, self._num_stages, seg_method)
        self.segment_parts = seg.do_segment()
        self._shared = {}
        built = []
        for d in self._layers_desc:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name in self._shared:
                    layer = _SharedForward(self._shared[d.layer_name],
                                           d.forward_func)
                else:
                    layer = d.build_layer()
                    self._shared[d.layer_name] = layer
                built.append(layer)
            elif isinstance(d, LayerDesc):
                built.append(d.build_layer())
            elif isinstance(d, nn.Module):
                built.append(d)
            elif callable(d):
                built.append(_FnLayer(d))
            else:
                raise TypeError(f"bad layer desc: {d}")
        self.layers_holder = LayerList([m for m in built
                                        if isinstance(m, nn.Module)])
        self.run_function = built

    def get_stage_layers(self, stage_id: int):
        lo, hi = self.segment_parts[stage_id], self.segment_parts[stage_id + 1]
        return self.run_function[lo:hi]

    def forward(self, x):
        for fn in self.run_function:
            x = fn(x)
        return x

    def loss(self, output, label):
        return self._loss_fn(output, label) if self._loss_fn else output

    @property
    def parameters_in_stage(self):
        return {s: [p for m in self.get_stage_layers(s)
                    if isinstance(m, nn.Module) for p in m.parameters()]
                for s in range(self._num_stages)}


class _FnLayer(Layer):
    def __init__(self, fn: Callable):
        super().__init__()
        self._fn = fn

    def forward(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


class _SharedForward(Layer):
    def __init__(self, base: nn.Module, fwd: Optional[Callable]):
        super().__init__()
        # registered as a sublayer: the weights are shared by identity
        self._base = base
        self._fwd = fwd

    def forward(self, x):
        if self._fwd is not None:
            return self._fwd(self._base, x)
        return self._base(x)
