"""``SegmentParallel`` — port of ``paddle_tpu/distributed/fleet/
meta_parallel/segment_parallel.py``: the wrapper of a model whose
activations are sharded over the ``sep`` mesh dim along the sequence.

The sharding itself is the model's (its logical axes put "seq" on "sep",
and attention over such a sequence is ring attention, ``ops.
ring_attention``); the wrapper passes ``forward``, ``state_dict`` and
``set_state_dict`` through. Its parameters need no broadcast over sep:
every rank builds the model from the same seed (the JAX package's single
controller has one copy)."""

from ....nn.layer.layers import Layer


class SegmentParallel(Layer):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, sd, *args, **kwargs):
        fn = getattr(self._layers, "set_state_dict", None)
        if fn is None:
            return self._layers.load_state_dict(sd, *args, **kwargs)
        return fn(sd, *args, **kwargs)
