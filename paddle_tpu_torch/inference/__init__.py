"""The serving and deployment path of the port.

Deployment (``Config``, ``create_predictor``, ``Predictor``,
``PredictorTensor``; port of ``paddle_tpu/inference/__init__.py:32-231``,
reference: AnalysisPredictor and python/paddle/inference): a ``Predictor``
loads the artifact ``jit.save(layer, path, input_spec=...)`` writes
(``path.pdmodel``, a ``torch.export`` program over ``(state, inputs)``,
and ``path.pdiparams``) once and runs it on the current place; its input
signature is the program's inputs past the state. ``Config.enable_bf16``
keeps the fp32 weights in bf16 and casts them up at the call (half the
weight memory); ``enable_donate_inputs`` is kept for the API: each run's
inputs are fresh tensors that die with the call, and the state is never
donated.

Serving: the continuous-batching engine with its prefix
cache and fused mega-step, the crash-recoverable supervisor over it, the
fleet router over supervisors, the disaggregated prefill/decode tiers with
KV-chain migration and the SLO autoscaler over the fleet
(``AutoscaleConfig``, ``SLOAutoscaler``: loaded on first use, so importing
the serving modules never pulls the control loop in). Every layer takes
``tracer=`` (a ``paddle_tpu_torch.observability.TraceRecorder``). The
process-per-replica fleet lives in ``inference.procfleet`` (not
re-exported here, as in the JAX package)."""

from typing import List, Optional, Sequence

import numpy as np
import torch

from .disagg import KVChainCodec, KVChainCorrupt, TieredRouter  # noqa: F401
from .fleet import FleetConfig, FleetRouter, ReplicaState  # noqa: F401
from .recovery import (JournalCorrupt, RequestJournal,  # noqa: F401
                       ServingSupervisor)
from .serving import (ContinuousBatchingEngine, EngineSaturated,  # noqa: F401
                      MeshDegraded, PrefixCacheConfig, Request, RequestShed)

__all__ = ["AutoscaleConfig", "Config", "ContinuousBatchingEngine",
           "EngineSaturated", "Predictor", "PredictorTensor",
           "create_predictor",
           "FleetConfig", "FleetRouter", "JournalCorrupt", "KVChainCodec",
           "KVChainCorrupt", "MeshDegraded", "PrefixCacheConfig",
           "ReplicaState", "Request", "RequestJournal", "RequestShed",
           "SLOAutoscaler", "ServingSupervisor", "TieredRouter"]


def __getattr__(name):
    if name in ("AutoscaleConfig", "SLOAutoscaler"):
        from . import autoscale

        return getattr(autoscale, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Config:
    """Inference config (reference: paddle_analysis_config.h). The program
    runs on the current place unless ``enable_use_gpu(device_id=)`` or
    ``disable_gpu()`` names one; the TensorRT and MKLDNN switches are
    accepted for the API and change nothing; ``enable_bf16`` is the
    mixed-precision switch."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self.model_path = prog_file
        self.params_file = params_file
        self._bf16 = False
        self._memory_optim = True
        self._ir_optim = True
        self._donate_inputs = False
        self._device = None

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def enable_memory_optim(self, x: bool = True):
        self._memory_optim = x

    def switch_ir_optim(self, x: bool = True):
        self._ir_optim = x

    def enable_bf16(self, x: bool = True):
        """Serve with bfloat16 weights, cast up at the call (reference:
        convert_to_mixed_precision / enable_mkldnn_bfloat16)."""
        self._bf16 = x

    def enable_donate_inputs(self, x: bool = True):
        """Kept for the API: each ``run``'s inputs are fresh tensors freed
        after the call; the weights are never donated (every ``run``
        reuses them)."""
        self._donate_inputs = x

    def set_cpu_math_library_num_threads(self, n: int):
        pass

    def enable_tensorrt_engine(self, *a, **k):
        pass

    def summary(self) -> str:
        return (f"Config(model={self.model_path}, bf16={self._bf16}, "
                f"memory_optim={self._memory_optim})")


class PredictorTensor:
    """Input/output handle (reference: ZeroCopyTensor). ``copy_from_cpu``
    / ``copy_to_cpu`` keep the zero-copy API; the transfer happens at
    ``run()``."""

    def __init__(self, name: str, shape=None, dtype=None):
        self.name = name
        self._shape = list(shape) if shape else None
        self._dtype = dtype
        self._value: Optional[np.ndarray] = None

    def reshape(self, shape):
        self._shape = list(shape)

    def copy_from_cpu(self, arr: np.ndarray):
        self._value = np.asarray(arr)
        self._shape = list(self._value.shape)

    def copy_to_cpu(self) -> np.ndarray:
        if self._value is None:
            raise RuntimeError(f"output '{self.name}' not computed — call "
                               f"run()")
        return np.asarray(self._value)

    def shape(self):
        return self._shape

    def type(self):
        return self._dtype


def _host(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class Predictor:
    """A ``jit.save`` artifact loaded once and run on the current place."""

    def __init__(self, config: Config):
        from ..core.dtype import dtype_name
        from ..jit.api import load_program

        self._config = config
        if config.model_path is None:
            raise ValueError("Config needs a model path prefix (jit.save "
                             "output)")
        module, state, ins, outs = load_program(
            config.model_path, device=config._device,
            params_file=config.params_file)
        self._device = state[0].device if state else None
        if config._bf16:
            # weights stored bf16, cast up at the call boundary
            dtypes = [s.dtype for s in state]
            state = [s.to(torch.bfloat16) if s.dtype == torch.float32 else s
                     for s in state]

            def call(st, args):
                return module([s.to(d) for s, d in zip(st, dtypes)], *args)
        else:
            def call(st, args):
                return module(st, *args)
        self._state = state
        self._call = call
        self._n_state = len(state)
        self._input_avals = ins
        self._inputs = [PredictorTensor(f"x{i}", list(a.shape),
                                        dtype_name(a.dtype))
                        for i, a in enumerate(ins)]
        self._outputs: List[PredictorTensor] = [
            PredictorTensor(f"out{i}", list(a.shape), dtype_name(a.dtype))
            for i, a in enumerate(outs)]

    def get_input_names(self) -> List[str]:
        return [t.name for t in self._inputs]

    def get_output_names(self) -> List[str]:
        return [t.name for t in self._outputs]

    def get_input_handle(self, name: str) -> PredictorTensor:
        return next(t for t in self._inputs if t.name == name)

    def get_output_handle(self, name: str) -> PredictorTensor:
        return next(t for t in self._outputs if t.name == name)

    def run(self, inputs: Optional[Sequence[np.ndarray]] = None):
        """Execute. With ``inputs`` given, returns the outputs (numpy
        arrays); otherwise reads the handles set by ``copy_from_cpu``."""
        from ..device import resolve_device

        if inputs is not None:
            arrs = [np.asarray(a) for a in inputs]
        else:
            missing = [t.name for t in self._inputs if t._value is None]
            if missing:
                raise RuntimeError(f"inputs not set: {missing}")
            arrs = [t._value for t in self._inputs]
        if len(arrs) != len(self._input_avals):
            raise ValueError(f"expected {len(self._input_avals)} inputs, "
                             f"got {len(arrs)}")
        for a, aval in zip(arrs, self._input_avals):
            if tuple(a.shape) != tuple(aval.shape):
                raise ValueError(
                    f"input shape {a.shape} != exported {tuple(aval.shape)}"
                    f" — export with the serving shape")
        dev = self._device or resolve_device()
        args = [torch.as_tensor(a).to(device=dev, dtype=aval.dtype)
                for a, aval in zip(arrs, self._input_avals)]
        with torch.no_grad():
            outs = self._call(self._state, args)
        out_list = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        vals = [_host(o) for o in out_list]
        for t, v in zip(self._outputs, vals):
            t._value = v
        return vals if inputs is not None else None

    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        pass


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
