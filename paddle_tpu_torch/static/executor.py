"""The static-graph Executor — port of ``paddle_tpu/static/executor.py``:
replay a recorded Program inside one compiled function.

Parity anchors: the reference's StandaloneExecutor + PirInterpreter and the
Python wrapper with its plan cache (python/paddle/base/executor.py:1285
run, :847 _ExecutorCache).

The dependency-pruned op list (``passes.live_ops``, aliases resolved) is
one function, compiled with ``jit.to_static``'s compiler
(``torch.compile``, Inductor on CUDA tensors, ``aot_eager`` on CPU ones)
once per ``(program, version, feed signature, fetch set, train)``.
Captured eager tensors (parameters) are inputs of the compiled function,
so an update between runs is seen without a recompile. A training program
(``Optimizer.minimize`` on a symbolic loss, or ``append_backward``)
computes the loss's gradients over the same replay with torch's autograd
(AOTAutograd's compiled backward), sets each parameter's ``grad``, then
runs the program's eager optimizer ``step()`` and ``clear_grad()``.

Randomness: a ``torch.Generator`` cannot be a graph input, so inside the
compiled replay the random ops draw from torch's default generator
(``framework.random.generator``), which each run of a program holding a
stochastic op seeds with a fresh ``next_host_seed()`` inside
``torch.random.fork_rng``: a fresh mask every run, and the same masks
after the same ``paddle.seed``, as the JAX Executor's per-run key gives.
Feeds are cast to their Variable's dtype on the current place (int64 ids
stay int64, where JAX truncates them to int32).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import static_graph
from ..core.static_graph import Program, Variable
from ..core.tensor import Tensor, unwrap

__all__ = ["Executor", "Scope", "global_scope"]


class Scope:
    """Name → Tensor map (reference: paddle/fluid/framework/scope.h).

    ``var(name)`` keeps Paddle's lenient contract — an unknown name
    materializes a ()-shaped float32 zero — but every such lazy read is
    tracked (``_lazy_reads``); ``var(name, strict=True)`` raises
    instead."""

    def __init__(self):
        self._vars: Dict[str, Tensor] = {}
        self._written: set = set()
        self._lazy_reads: Dict[str, int] = {}

    def var(self, name, strict: bool = False):
        if name not in self._written:
            if strict:
                raise KeyError(
                    f"scope variable '{name}' was never written "
                    f"(strict lookup); known: {sorted(self._written)[:10]}")
            self._lazy_reads[name] = self._lazy_reads.get(name, 0) + 1
            self._vars.setdefault(
                name, torch.zeros((), dtype=torch.float32).as_subclass(
                    Tensor))
        return self._vars[name]

    def find_var(self, name):
        return self._vars.get(name)

    def set(self, name, t: Tensor):
        self._written.add(name)
        self._vars[name] = t


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def _is_stochastic_type(op_type) -> bool:
    return any(k in (op_type or "") for k in static_graph.STOCHASTIC_KEYWORDS)


def _seeded(seed, device):
    """torch's default generator of ``device`` seeded with ``seed`` for
    the block, restored after it."""
    devices = [device.index or 0] if device.type == "cuda" else []
    stack = contextlib.ExitStack()
    stack.enter_context(torch.random.fork_rng(
        devices=devices, device_type=device.type if devices else "cuda"))
    torch.manual_seed(seed)
    return stack


class Executor:
    """``Executor(place).run(program, feed, fetch_list)``."""

    def __init__(self, place=None):
        self.place = place
        self._cache: Dict[Any, Any] = {}

    def close(self):
        self._cache.clear()

    def cache_signatures(self):
        """One ``(program_id, version, feed_sig, fetch_ids, train)`` tuple
        per compiled plan (a program id with many feed signatures
        recompiles every step)."""
        return list(self._cache.keys())

    # -- replay construction ------------------------------------------------
    def _build(self, program: Program, feed_vars, fetch_vars, train: bool):
        from ..jit.api import StaticFunction
        from .passes import live_ops, resolve_alias

        aliases = getattr(program, "_aliases", {})
        targets = list(fetch_vars) + ([program._loss] if train else [])
        ops = live_ops(program.global_block().ops,
                       [id(v) for v in targets], aliases)

        # ordered distinct captured eager tensors
        caps: List[torch.Tensor] = []
        cap_pos: Dict[int, int] = {}
        for op in ops:
            for t in op.captured:
                if id(t) not in cap_pos:
                    cap_pos[id(t)] = len(caps)
                    caps.append(t)
        folded = getattr(program, "_folded", {})  # id(var) -> constant

        diff_params: List[torch.Tensor] = []
        if train:
            diff_params = [p for p in program._optimizer._static_params
                           if id(p) in cap_pos]
        diff_idx = [cap_pos[id(p)] for p in diff_params]

        has_stochastic = any(_is_stochastic_type(op.type) for op in ops)
        consts = [unwrap(t) for t in folded.values()]
        const_pos = {vid: i for i, vid in enumerate(folded)}

        # the replay plan: every argument as a slot, so the traced code
        # touches no Variable (a meta tensor) — ("v", value index),
        # ("c", capture index), ("k", constant index) or ("l", literal)
        slot_of: Dict[int, int] = {id(v): i for i, v in enumerate(feed_vars)}

        def slot(a):
            if isinstance(a, Variable):
                vid = resolve_alias(aliases, id(a))
                if vid in slot_of:
                    return ("v", slot_of[vid])
                if vid in const_pos:
                    return ("k", const_pos[vid])
                raise KeyError(f"Variable '{a.name}' has no value — is it "
                               f"a feed you forgot to pass?")
            if isinstance(a, torch.Tensor):
                return ("c", cap_pos[id(a)])
            return ("l", a)

        plan = []
        for op in ops:
            args = [slot(a) for a in op.args]
            outs = []
            for v in op.outputs:
                slot_of[id(v)] = len(slot_of)
                outs.append(slot_of[id(v)])
            plan.append((op.fn, args, op.kwargs, outs))
        # chain-resolve as live_ops does, so a multi-hop alias map fetches
        # the canonical producer's value
        targets = [slot(v) for v in fetch_vars]
        if train:
            targets.append(slot(program._loss))

        def replay(feed_arrs, cap_arrs):
            env = list(feed_arrs) + [None] * (len(slot_of) - len(feed_arrs))

            def value(kind, x):
                if kind == "v":
                    return env[x]
                if kind == "c":
                    return cap_arrs[x]
                if kind == "k":
                    return consts[x]
                return x

            for fn, args, kwargs, outs in plan:
                out = fn(*[value(*a) for a in args], **kwargs)
                if len(outs) == 1 and not isinstance(out, (tuple, list)):
                    out = (out,)
                for i, o in zip(outs, out):
                    env[i] = o
            return [value(*t) for t in targets]

        return (StaticFunction(replay), caps, (diff_params, diff_idx),
                has_stochastic)

    # -- public API ---------------------------------------------------------
    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict] = None,
            fetch_list: Optional[Sequence] = None, return_numpy: bool = True,
            scope: Optional[Scope] = None, **kwargs):
        from ..device import resolve_device
        from . import CompiledProgram

        if isinstance(program, CompiledProgram):
            program._ensure_optimized()
            program = program._program
        if program is None:
            program = static_graph.default_main_program()
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        if program.num_ops == 0 and not fetch_list:
            # startup program: parameter init already ran eagerly — nothing
            # to execute (with a fetch_list the normal path still serves
            # folded constants and feeds out of an op-free program)
            return []

        by_name = {v.name: v for v in program.list_vars()}
        fetch_vars = [by_name[f] if isinstance(f, str) else f
                      for f in fetch_list]
        dev = resolve_device()
        feed_vars, feed_arrs = [], []
        for k, val in feed.items():
            v = by_name.get(k)
            if v is None:
                raise KeyError(f"feed '{k}' is not a variable of this "
                               f"program")
            feed_vars.append(v)
            t = unwrap(val) if isinstance(val, torch.Tensor) \
                else torch.as_tensor(np.asarray(val))
            feed_arrs.append(t.to(device=dev, dtype=v.dtype))

        train = program._optimizer is not None and program._loss is not None
        sig = tuple((v.name, tuple(a.shape), str(a.dtype))
                    for v, a in zip(feed_vars, feed_arrs))
        key = (id(program), program._version, sig,
               tuple(id(v) for v in fetch_vars), train)
        if key not in self._cache:
            self._cache[key] = self._build(program, feed_vars, fetch_vars,
                                           train)
        fn, caps, (diff_params, diff_idx), stochastic = self._cache[key]
        cap_arrs = [unwrap(t) for t in caps]
        rng = contextlib.nullcontext()
        if stochastic:
            from ..framework.random import next_host_seed

            # fresh per run, paddle.seed-reproducible
            rng = _seeded(next_host_seed(), dev)

        with rng, torch.set_grad_enabled(train):
            outs = fn(feed_arrs, cap_arrs)
        outs = [unwrap(o) for o in outs]
        if train:
            loss = outs.pop()
            grads = torch.autograd.grad(loss, [cap_arrs[i] for i in
                                               diff_idx],
                                        allow_unused=True)
            for p, g in zip(diff_params, grads):
                p.grad = g
            opt = program._optimizer
            opt.step()
            opt.clear_grad()
        fetches = [o.detach() for o in outs]

        sc = scope or _global_scope
        for v, a in zip(fetch_vars, fetches):
            sc.set(v.name, a.as_subclass(Tensor))
        if return_numpy:
            return [(a.float() if a.dtype == torch.bfloat16 else a)
                    .cpu().numpy() for a in fetches]
        return [a.as_subclass(Tensor) for a in fetches]
