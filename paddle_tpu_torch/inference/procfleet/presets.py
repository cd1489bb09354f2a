"""Picklable engine factories for process-replica workers — port of
``paddle_tpu/inference/procfleet/presets.py``.

A :class:`~paddle_tpu_torch.inference.procfleet.worker.WorkerSpec` must
name a factory the SPAWNED process can import and call — a module-level
function, referenced by pickling or by ``"module:qualname"`` string. Test,
drill and smoke factories live here so every harness spawns workers
through one path.

Determinism contract: a factory builds its model's weights from a seed
(``LlamaForCausalLM(cfg, device=..., seed=...)``), or loads them from a
state file, so N worker processes hold bit-identical weights — the
foundation of byte-identical failover across processes. ``state_path``
names an ``.npz`` of parameter arrays by name (the JAX model's, written
with ``numpy.savez`` from ``weights.state_from_jax_layer``): CPU workers
then compute what the JAX model computes.

Engines build on the CUDA device unless ``device="cpu"`` is passed; a
worker without a card raises (no factory moves to the CPU on its own).
"""

from __future__ import annotations

from typing import Optional

from ..._later import later_slice

__all__ = ["llama_engine", "tiny_llama_engine", "tiny_llama_mesh_engine",
           "tiny_llama_prefix_engine"]


def _prefix(prefix_cache):
    """``prefix_cache`` as the engine takes it: a ``PrefixCacheConfig``,
    a dict of its fields, or a bool."""
    if isinstance(prefix_cache, dict):
        from ..serving import PrefixCacheConfig

        return PrefixCacheConfig(**prefix_cache)
    return prefix_cache


def llama_engine(config: dict, seed: int = 0, device=None,
                 state_path: Optional[str] = None, prefix_cache=False,
                 **engine_kw):
    """A Llama serving engine of ``LlamaConfig(**config)``: weights from
    ``seed`` (or ``state_path``), then ``ContinuousBatchingEngine(model,
    prefix_cache=..., device=device, **engine_kw)``. At a full-width
    config (``chip_smoke.py`` passes its ``SERVE_CONFIG`` and seed 0)
    every worker builds the weights the driver's in-process model holds,
    bit for bit."""
    from ...models import LlamaConfig, LlamaForCausalLM
    from ..serving import ContinuousBatchingEngine

    model = LlamaForCausalLM(LlamaConfig(**config), device=device,
                             seed=seed)
    if state_path is not None:
        import numpy as np

        from ...weights import load_jax_state

        with np.load(state_path) as npz:
            load_jax_state(model, {k: npz[k] for k in npz.files})
    return ContinuousBatchingEngine(model, prefix_cache=_prefix(prefix_cache),
                                    device=device, **engine_kw)


def tiny_llama_engine(seed: int = 13, num_hidden_layers: int = 1,
                      max_batch: int = 2, max_len: int = 32,
                      page_size: int = 8, block_size: int = 2,
                      max_queue=None, prefix_cache=False, device=None,
                      state_path: Optional[str] = None, **kw):
    """``LlamaConfig.tiny`` Llama serving engine, weights from ``seed`` or
    ``state_path`` — the worker-side twin of the engines the fleet tests
    build."""
    from ...models import LlamaConfig

    cfg = LlamaConfig.tiny(num_hidden_layers=num_hidden_layers)
    return llama_engine(vars(cfg).copy(), seed=seed, device=device,
                        state_path=state_path, prefix_cache=prefix_cache,
                        max_batch=max_batch, max_len=max_len,
                        page_size=page_size, block_size=block_size,
                        max_queue=max_queue, **kw)


def tiny_llama_prefix_engine(**kw):
    """The prefix-cache variant (KV-chain migration needs dynamic block
    tables on both tiers — ``inference/disagg.py``)."""
    kw.setdefault("prefix_cache", True)
    return tiny_llama_engine(**kw)


def tiny_llama_mesh_engine(**kw):
    """The mesh-sharded worker's engine: waits for tp-sharded serving."""
    raise later_slice("tiny_llama_mesh_engine (a mesh-sharded procfleet "
                      "worker)", "tp-sharded serving", "7")
