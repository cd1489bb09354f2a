"""``PipelineParallel`` — port of ``paddle_tpu/distributed/fleet/
meta_parallel/pipeline_parallel.py``.

``train_batch`` is the JAX package's single-process form: the batch's
microbatches run forward and backward one after another with their
gradients accumulated, then one optimizer step (the reference's 1F1B is a
schedule of the same arithmetic). The SPMD pipeline over a ``pp`` mesh dim,
each rank running its stage, is ``auto_parallel.pipeline``;
``gpipe_spmd`` builds its GPipe schedule.
"""

from __future__ import annotations

from typing import Callable

import torch

from ....nn.layer.layers import Layer
from .parallel_layers.pp_layers import PipelineLayer


class PipelineParallel(Layer):
    """``hcg``: any object with ``get_pipe_parallel_world_size()`` (fleet's
    hybrid group in the reference; ``fleet.init`` is a later part of item
    6 in the port)."""

    def __init__(self, layers: PipelineLayer, hcg, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        pc = (strategy.pipeline_configs if strategy is not None else {}) or {}
        self._micro_batch_size = pc.get("micro_batch_size", 1)
        self._accumulate_steps = pc.get("accumulate_steps", 1)
        self.num_stages = hcg.get_pipe_parallel_world_size()

    def forward(self, x):
        return self._layers(x)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """Microbatched forward and backward with the gradients accumulated
        (each microbatch's loss over ``accumulate_steps``), one optimizer
        step; returns the mean of the microbatches' losses."""
        x, y = data
        n_micro = self._accumulate_steps
        micro = max(x.shape[0] // n_micro, 1)
        total = None
        optimizer.clear_grad()
        for i in range(n_micro):
            xb = x[i * micro:(i + 1) * micro]
            yb = y[i * micro:(i + 1) * micro]
            loss = self._layers.loss(self._layers(xb), yb)
            scaled = loss / n_micro if n_micro > 1 else loss
            if scaler is not None:
                scaler.scale(scaled).backward()
            else:
                scaled.backward()
            total = (loss.detach() if total is None
                     else total + loss.detach())
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total / n_micro

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        x, y = data
        out = self._layers(x)
        return self._layers.loss(out, y) if compute_loss else out


def gpipe_spmd(stage_fn: Callable, n_stages: int, axis_name: str = "pp"):
    """The GPipe executor over a mesh dim (``auto_parallel.pipeline.
    gpipe_schedule``): ``pipeline(params, micro_in, *bargs)``, run on every
    rank of the dim."""
    from ...auto_parallel.pipeline import gpipe_schedule

    return gpipe_schedule(stage_fn, n_stages, axis_name)
