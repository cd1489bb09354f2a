"""paddle.static — port of ``paddle_tpu/static/__init__.py``, the
static-graph layer.

Parity anchors: python/paddle/static/__init__.py (Program / Executor /
program_guard / data / nn), python/paddle/base/executor.py:1285
(Executor.run).

A Program is a lazily recorded op list over the one op dispatcher
(``core/static_graph.py``); the Executor replays it inside one compiled
function (``executor.py``), and ``passes.py`` holds DCE, constant folding
and CSE. The JAX package's ``analysis``, ``concurrency``, ``cost`` and
``comm`` gates are not ported yet: reaching them raises ``later_slice``.
"""

from __future__ import annotations

from ..core import static_graph as _sg
from ..core.static_graph import (  # noqa: F401
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .executor import Executor, Scope, global_scope  # noqa: F401
from .passes import (  # noqa: F401
    CommonSubexpressionEliminationPass,
    ConstantFoldingPass,
    DeadCodeEliminationPass,
    Pass,
    PassManager,
    apply_default_passes,
)
from . import nn  # noqa: F401

# the JAX package's lazy gates: name -> (what, ROADMAP Queue 1 item)
_GATES = {
    "analysis": ("paddle_tpu_torch.static.analysis", "9"),
    "concurrency": ("paddle_tpu_torch.static.concurrency", "9"),
    "cost": ("paddle_tpu_torch.static.cost (and its FLOPs, item 8.6)", "9"),
    "comm": ("paddle_tpu_torch.static.comm", "9"),
}


def __getattr__(name):
    if name in _GATES:
        from .._later import later_slice

        what, item = _GATES[name]
        raise later_slice(what, "static analysis gates", item)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "InputSpec", "Program", "Variable", "Executor", "Scope", "global_scope",
    "program_guard", "default_main_program", "default_startup_program",
    "data", "CompiledProgram", "BuildStrategy", "ExecutionStrategy",
    "append_backward", "name_scope", "PassManager", "apply_default_passes",
    "nn",
]


class InputSpec:
    def __init__(self, shape=None, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = list(shape) if shape is not None else None
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        from ..core.dtype import dtype_name

        return cls(list(tensor.shape), dtype_name(tensor.dtype), name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def data(name: str, shape, dtype="float32", lod_level=0) -> Variable:
    """Declare a feed variable in the current program
    (reference: python/paddle/static/input.py data)."""
    from ..core import dtype as dtype_mod

    prog = _sg.current_program()
    return prog.global_block().create_var(
        shape, dtype_mod.convert_dtype(dtype), name=name, is_feed=True)


class BuildStrategy:
    """Pass-selection knobs (reference: BuildStrategy pybind), mapped onto
    ``passes.py``."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_elewise_add_act_ops = True  # the compiler fuses; kept
        self.constant_folding = True
        self.cse = True
        self.dead_code_elimination = True


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10


class CompiledProgram:
    """Program + optimization pipeline (reference: python/paddle/static/
    compiler.py CompiledProgram). Passes run once, lazily, on first
    use."""

    def __init__(self, program: Program, build_strategy: BuildStrategy = None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._optimized = False

    def _ensure_optimized(self, targets=None):
        """Run the strategy-selected passes once (Executor.run calls it).
        DCE is skipped without explicit targets: the Executor prunes per
        fetch set anyway."""
        if self._optimized:
            return
        bs = self._build_strategy
        pm = PassManager()
        if bs.cse:
            pm.add_pass(CommonSubexpressionEliminationPass())
        if bs.constant_folding:
            pm.add_pass(ConstantFoldingPass())
        if bs.dead_code_elimination and targets:
            pm.add_pass(DeadCodeEliminationPass(targets))
        pm.run(self._program)
        self._optimized = True


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None):
    """Static-mode backward marker (reference: python/paddle/base/
    backward.py append_backward). The Executor computes the gradients over
    the replay; this records which parameters take them and returns
    (param, None) pairs whose grads appear as ``param.grad`` after each
    ``Executor.run``."""
    prog = loss.block.program
    prog._loss = loss
    params = list(parameter_list or prog.all_parameters())
    skip = set(map(id, no_grad_set or []))
    params = [p for p in params if getattr(p, "trainable", True)
              and id(p) not in skip]
    if prog._optimizer is None:
        class _GradOnly:
            """Sentinel optimizer: compute grads, apply no update."""

            _static_params = params

            @staticmethod
            def step():
                pass

            @staticmethod
            def clear_grad():
                pass

        prog._optimizer = _GradOnly()
    return [(p, None) for p in params]


class name_scope:
    """API-parity no-op scoping."""

    def __init__(self, prefix=""):
        self.prefix = prefix

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
