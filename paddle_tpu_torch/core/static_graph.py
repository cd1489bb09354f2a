"""The static-graph IR — port of ``paddle_tpu/core/static_graph.py``.

A ``Program`` is a lazily recorded op list over the one op dispatcher
(``core/op_registry.apply_fn``): calling any Paddle function on a symbolic
``Variable`` appends an ``Operation`` holding the op's plain torch function
and its arguments. Shape and dtype inference (the reference's InferMeta)
runs that same function on ``meta`` tensors, so one source of truth serves
both; the custom ops' fakes serve there for the kernels. The Executor
(``static/executor.py``) replays the recorded ops inside one compiled
function (``torch.compile``, as ``jit.to_static``), and ``static/passes.py``
keeps the graph-level passes (DCE, constant folding, CSE).

``Variable`` is a Paddle ``Tensor`` over a meta tensor of the advisory
shape (-1 dims as 1). Its ``__torch_function__`` answers metadata reads
(dtype, ndim, device ...) and refuses every other torch function: a torch
op that does not come through the dispatcher would compute a meta result
silently, where the JAX package's ``ShapeDtypeStruct`` fails. ``__bool__``,
``numpy()`` and ``item()`` raise with the JAX package's messages.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import torch

from .tensor import Tensor

__all__ = [
    "Variable", "Operation", "Block", "Program", "program_guard",
    "default_main_program", "default_startup_program", "building",
    "record_op", "enable_static_mode", "disable_static_mode",
    "static_mode_enabled",
]


# op-type keywords marking nondeterministic ops (never folded/CSEd; each
# Executor run of a program holding one is seeded afresh)
STOCHASTIC_KEYWORDS = ("rand", "normal", "uniform", "dropout", "bernoulli",
                       "poisson", "multinomial", "exponential", "randint",
                       "randperm", "shuffle")

#: True once static mode was enabled or a Variable made: until then the
#: dispatcher's interception is this one check an op
active = [False]

_T = torch.Tensor
# the torch functions that read a Variable's metadata (nothing else runs
# on one outside the dispatcher)
_META_READS = {
    _T.dtype.__get__, _T.ndim.__get__, _T.device.__get__,
    _T.requires_grad.__get__, _T.is_leaf.__get__, _T.grad_fn.__get__,
    _T.layout.__get__, _T.is_cuda.__get__, _T.is_meta.__get__,
    _T.dim, _T.ndimension, _T.is_floating_point, _T.is_complex, _T.numel,
    _T.element_size, _T.__hash__, _T.__len__, _T.size, _T.stride,
    _T.is_contiguous,
}


class Variable(Tensor):
    """A symbolic tensor inside a Program: a meta tensor of the advisory
    shape (-1/None dims read 1; they are inferred at run time from the
    feeds)."""

    def __new__(cls, *args, **kwargs):  # pragma: no cover - use create
        raise TypeError("use Variable.create()")

    @classmethod
    def create(cls, shape, dtype, name: str, block: "Block",
               op: Optional["Operation"] = None, out_idx: int = 0,
               is_feed: bool = False):
        shape = tuple(-1 if s is None else int(s) for s in shape)
        adv = tuple(1 if s == -1 else s for s in shape)
        meta = torch.empty(adv, dtype=dtype, device="meta")
        v = torch.Tensor._make_subclass(cls, meta, False)
        v.__dict__.update(_meta=meta, _vname=name, _stop_gradient=True,
                          _out_idx=out_idx, persistable=False, block=block,
                          op=op, is_feed=is_feed, decl_shape=shape)
        active[0] = True
        return v

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in _META_READS:
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", repr(func))
        raise RuntimeError(
            f"torch function '{name}' on a symbolic Variable: a static "
            f"program records only the Paddle API's ops (paddle_tpu_torch "
            f"functions and Tensor methods), which go through the op "
            f"dispatcher")

    @property
    def name(self):
        return self.__dict__["_vname"]

    @name.setter
    def name(self, value):
        self.__dict__["_vname"] = value

    @property
    def stop_gradient(self):
        return self.__dict__["_stop_gradient"]

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.__dict__["_stop_gradient"] = bool(value)

    @property
    def shape(self):
        return list(self.decl_shape)

    def numpy(self):
        raise RuntimeError(
            f"Variable '{self.name}' is symbolic — fetch it through "
            f"Executor.run()")

    item = numpy
    tolist = numpy

    def __bool__(self):
        raise RuntimeError(
            "cannot branch on a symbolic Variable; static graphs require "
            "value-free Python control flow (use paddle.where-style ops)")

    def __repr__(self, *, tensor_contents=None):
        return (f"Variable(name={self.name}, shape={self.decl_shape}, "
                f"dtype={self.dtype})")

    __str__ = __repr__

    def __deepcopy__(self, memo):
        return self

    def __reduce_ex__(self, proto):
        raise TypeError(f"Variable '{self.name}' is symbolic and cannot be "
                        f"pickled")


class Operation:
    """One recorded op: a plain torch function + its argument template.

    ``args`` entries may be Variable (symbolic input), a captured eager
    tensor (late-bound at replay, so parameter updates are visible), or
    plain Python literals. Cf. pir::Operation — the "opcode" is the Python
    callable itself.
    """

    __slots__ = ("idx", "type", "fn", "args", "kwargs", "inputs", "captured",
                 "outputs", "src")

    def __init__(self, idx, type, fn, args, kwargs, src=None):
        self.idx = idx
        self.type = type
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.src = src  # "file:line" of the recording call site
        self.inputs: List[Variable] = [a for a in args
                                       if isinstance(a, Variable)]
        self.captured: List[torch.Tensor] = [
            a for a in args if isinstance(a, torch.Tensor)
            and not isinstance(a, Variable)]
        self.outputs: List[Variable] = []

    def _with_fn(self, type: str, fn) -> "Operation":
        """A copy of this op with a substituted kernel (same args, kwargs
        and outputs): ``Program.clone(for_test=True)`` swaps train-mode
        kernels for their eval counterparts with it."""
        op = Operation.__new__(Operation)
        op.idx = self.idx
        op.type = type
        op.fn = fn
        op.args = self.args
        op.kwargs = self.kwargs
        op.src = self.src
        op.inputs = self.inputs
        op.captured = self.captured
        op.outputs = self.outputs
        return op

    def to_string(self):
        ins = ", ".join(v.name for v in self.inputs)
        caps = ", ".join(_tensor_name(t) for t in self.captured)
        outs = ", ".join(f"{v.name}:{_dtype_str(v.dtype)}{list(v.decl_shape)}"
                         for v in self.outputs)
        extra = f" captured=[{caps}]" if caps else ""
        return f"  ({outs}) = {self.type}({ins}){extra}"


def _dtype_str(dt):
    return str(dt).replace("torch.", "")


def _tensor_name(t):
    return getattr(t, "param_name", None) or f"tensor{list(t.shape)}"


class Block:
    """A straight-line list of operations + declared variables (control
    flow stays inside ops, so nested blocks are not needed)."""

    def __init__(self, program: "Program", idx: int = 0):
        self.program = program
        self.idx = idx
        self.ops: List[Operation] = []
        self.vars: Dict[str, Variable] = {}

    def var(self, name: str) -> Variable:
        return self.vars[name]

    def create_var(self, shape, dtype, name=None, is_feed=False, op=None,
                   out_idx=0):
        if name is None:
            name = self.program._next_name("tmp")
        v = Variable.create(shape, dtype, name, self, op=op, out_idx=out_idx,
                            is_feed=is_feed)
        self.vars[name] = v
        return v


class Program:
    """A recorded computation graph (cf. the reference's PIR program and
    the legacy ProgramDesc)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.random_seed = 0
        self._name_counter = 0
        self._version = 0
        self._loss: Optional[Variable] = None
        self._optimizer = None
        self._grad_vars: Dict[int, Variable] = {}
        self._is_test = False

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[-1]

    def _next_name(self, prefix: str) -> str:
        self._name_counter += 1
        return f"{prefix}_{self._name_counter}"

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    @property
    def num_ops(self):
        return sum(len(b.ops) for b in self.blocks)

    def clone(self, for_test: bool = False) -> "Program":
        p = Program()
        p.random_seed = self.random_seed
        p._name_counter = self._name_counter
        p._is_test = for_test
        # pass state travels with the clone (aliases and folded constants
        # keep a CSE'd or folded program executable; loss and optimizer
        # keep a minimize()d program training)
        p._aliases = dict(getattr(self, "_aliases", {}))
        p._folded = dict(getattr(self, "_folded", {}))
        p._seed_stamps = dict(getattr(self, "_seed_stamps", {}))
        if getattr(self, "_outputs", None):
            p._outputs = list(self._outputs)
        if not for_test:
            # a test clone never trains: without loss and optimizer
            # Executor.run stays on the inference path
            p._loss = self._loss
            p._optimizer = self._optimizer
            p._grad_vars = dict(self._grad_vars)
        blk, src = p.global_block(), self.global_block()
        blk.vars = dict(src.vars)
        blk.ops = list(src.ops)
        if for_test:
            # train-only stochastic ops swap to their eval kernels; the ops
            # stay in place so their output Variables remain defined
            from ..nn.functional.common import dropout_eval_kernel

            eval_kernels = {
                "dropout": dropout_eval_kernel,
                "alpha_dropout": lambda a, **k: a,
            }
            blk.ops = [
                op._with_fn(op.type + "_eval", eval_kernels[op.type])
                if op.type in eval_kernels else op
                for op in blk.ops
            ]
        return p

    def to_string(self, throw_on_error=False, with_details=False) -> str:
        lines = [f"{{ // block 0 (ops={self.num_ops})"]
        feeds = [v.name for v in self.list_vars()
                 if getattr(v, "is_feed", False)]
        if feeds:
            lines.append(f"  feed: {', '.join(feeds)}")
        for op in self.global_block().ops:
            lines.append(op.to_string())
        lines.append("}")
        return "\n".join(lines)

    __str__ = to_string

    def all_parameters(self):
        seen, out = set(), []
        for op in self.global_block().ops:
            for t in op.captured:
                if getattr(t, "is_parameter", False) and id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    def diagnose(self, targets=None, parameters=None):
        """The program-level analysis suite (``static/analysis``) is not
        ported yet."""
        from .._later import later_slice

        raise later_slice("Program.diagnose (paddle_tpu_torch.static."
                          "analysis)", "static analysis gates", "9")


# ---------------------------------------------------------------------------
# program-recording state
# ---------------------------------------------------------------------------

_program_stack: List[Program] = []
_default_main = [None]
_default_startup = [None]
_static_mode = [False]


def default_main_program() -> Program:
    if _default_main[0] is None:
        _default_main[0] = Program()
    return _default_main[0]


def default_startup_program() -> Program:
    if _default_startup[0] is None:
        _default_startup[0] = Program()
    return _default_startup[0]


def enable_static_mode():
    _static_mode[0] = True
    active[0] = True


def disable_static_mode():
    _static_mode[0] = False
    _program_stack.clear()


def static_mode_enabled() -> bool:
    return _static_mode[0]


def current_program() -> Program:
    if _program_stack:
        return _program_stack[-1]
    return default_main_program()


class program_guard:
    """``with program_guard(main, startup):`` — record into ``main``
    (reference: python/paddle/static/__init__.py program_guard)."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        _program_stack.append(self.main)
        return self.main

    def __exit__(self, *exc):
        _program_stack.pop()
        return False


def building() -> bool:
    """Is at least one program open for recording?"""
    return bool(_program_stack) or _static_mode[0]


def recording_constants() -> bool:
    """Record tensor-input-free (creation) ops too? Only inside an
    explicit program_guard in static mode: library internals outside a
    guard (layer init, buffers) stay eager."""
    return _static_mode[0] and bool(_program_stack)


# ---------------------------------------------------------------------------
# op recording (called from core/op_registry.apply_fn)
# ---------------------------------------------------------------------------

def _meta_of(a):
    """Argument as the shape inference sees it."""
    if isinstance(a, Variable):
        return a.__dict__["_meta"]
    if isinstance(a, torch.Tensor):
        return torch.empty(tuple(a.shape), dtype=a.dtype, device="meta")
    return a


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) \
    + os.sep
_EXTERNAL_FILE: Dict[str, bool] = {}  # co_filename -> outside the package?


def _caller_src():
    """file:line of the first stack frame outside paddle_tpu_torch — the
    user call site that recorded the op. Runs per recorded op, so the
    verdict is cached per co_filename."""
    try:
        f = sys._getframe(2)
        depth = 0
        while f is not None and depth < 32:
            fn = f.f_code.co_filename
            ext = _EXTERNAL_FILE.get(fn)
            if ext is None:
                ext = not os.path.abspath(fn).startswith(_PKG_DIR)
                _EXTERNAL_FILE[fn] = ext
            if ext:
                return f"{fn}:{f.f_lineno}"
            f = f.f_back
            depth += 1
    except Exception:
        pass
    return None


def record_op(name: str, fn, args, kwargs):
    """Append an Operation to the current program; return symbolic
    outputs."""
    prog = None
    for a in args:
        if isinstance(a, Variable):
            prog = a.block.program
            break
    if prog is None:
        prog = current_program()
    blk = prog.current_block()
    op = Operation(len(blk.ops), name, fn, list(args), dict(kwargs),
                   src=_caller_src())
    if any(k in name for k in STOCHASTIC_KEYWORDS):
        # stamp seededness at record time, per op: a later paddle.seed()
        # must not make an unreproducible recording look reproducible
        from ..framework.random import explicitly_seeded

        if not hasattr(prog, "_seed_stamps"):
            prog._seed_stamps = {}
        prog._seed_stamps[id(op)] = not (explicitly_seeded()
                                         or prog.random_seed)

    # advisory shape/dtype inference == InferMeta, via the op's own
    # function on meta tensors (a creation op makes its real, small value)
    with torch.no_grad(), torch.device("meta"):
        out = fn(*[_meta_of(a) for a in args], **kwargs)
    single = not isinstance(out, (tuple, list))
    out_list = [out] if single else list(out)
    for o in out_list:
        if not isinstance(o, torch.Tensor):
            raise TypeError(f"static op '{name}' returned a "
                            f"{type(o).__name__}, not a tensor")
    blk.ops.append(op)
    prog._version += 1
    outs = []
    for i, o in enumerate(out_list):
        v = blk.create_var(o.shape, o.dtype, name=prog._next_name(name),
                           op=op, out_idx=i)
        op.outputs.append(v)
        outs.append(v)
    return outs[0] if single else tuple(outs)
