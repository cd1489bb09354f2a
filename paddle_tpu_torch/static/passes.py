"""Graph-level passes over a recorded Program — port of
``paddle_tpu/static/passes.py``.

Parity anchors: the reference's PIR pass infrastructure (pass_manager.h)
and the general transforms it ships (dead_code_elimination_pass.cc,
constant_folding_pass.cc, common_subexpression_elimination_pass.cc).

The compiler (Dynamo and Inductor, as ``jit.to_static``) fuses and
schedules after capture; the passes kept here shrink the recorded op list
before it: DCE, constant folding (feed-independent subgraphs hoisted out
of the per-step program) and CSE (duplicate recorded calls merged). They
count and rewrite the same ops as the JAX package's on the same program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.static_graph import (STOCHASTIC_KEYWORDS, Operation, Program,
                                 Variable)
from ..core.tensor import Tensor, unwrap

__all__ = ["Pass", "PassManager", "DeadCodeEliminationPass",
           "ConstantFoldingPass", "CommonSubexpressionEliminationPass",
           "apply_default_passes", "live_ops", "resolve_alias", "cse_key"]


def _is_stochastic(op: Operation) -> bool:
    return any(k in (op.type or "") for k in STOCHASTIC_KEYWORDS)


def resolve_alias(aliases, vid):
    """Follow an alias chain to its canonical id (a one-step lookup would
    drop the producing op of a multi-hop chain from the live set)."""
    hops = 0
    while vid in aliases and aliases[vid] != vid:
        vid = aliases[vid]
        hops += 1
        if hops > len(aliases):  # defensive: cyclic map
            break
    return vid


def live_ops(ops, target_ids, aliases=None):
    """Reverse liveness sweep: the subsequence of ``ops`` whose outputs
    reach ``target_ids`` (ids resolved through ``aliases``). Shared by the
    DCE pass and the Executor's replay plan."""
    aliases = aliases or {}
    needed = {resolve_alias(aliases, t) for t in target_ids}
    keep = []
    for op in reversed(ops):
        if any(id(o) in needed for o in op.outputs):
            keep.append(op)
            needed.update(resolve_alias(aliases, id(v)) for v in op.inputs)
    keep.reverse()
    return keep


class Pass:
    name = "pass"
    # transform passes mutate the program; an analysis pass would set
    # mutates=False and leave the Executor's compiled-plan cache valid
    mutates = True

    def apply(self, program: Program) -> int:
        """Mutate program; return number of changes."""
        raise NotImplementedError


class PassManager:
    """Ordered pass pipeline (cf. pir::PassManager::Run); the stat of a
    pass is its count of changes."""

    def __init__(self, passes: Optional[Sequence[Pass]] = None):
        self.passes: List[Pass] = list(passes or [])

    def add_pass(self, p: Pass):
        self.passes.append(p)
        return self

    def run(self, program: Program) -> Dict[str, int]:
        stats = {}
        for p in self.passes:
            stats[p.name] = p.apply(program)
            if p.mutates:
                program._version += 1
        return stats


class DeadCodeEliminationPass(Pass):
    """Drop ops whose outputs never reach ``targets`` (or any later op)."""

    name = "dead_code_elimination"

    def __init__(self, targets: Optional[Sequence[Variable]] = None):
        self.targets = targets

    def apply(self, program: Program) -> int:
        blk = program.global_block()
        if self.targets is None:
            return 0  # without targets every terminal op is live
        targets = [id(v) for v in self.targets]
        if program._loss is not None:
            targets.append(id(program._loss))
        keep = live_ops(blk.ops, targets, getattr(program, "_aliases", None))
        removed = len(blk.ops) - len(keep)
        blk.ops = keep
        return removed


class ConstantFoldingPass(Pass):
    """Evaluate feed-independent, non-stochastic ops once; replace their
    outputs with captured constants (reference: constant_folding_pass.cc)."""

    name = "constant_folding"

    def apply(self, program: Program) -> int:
        blk = program.global_block()
        folded: Dict[int, Tensor] = getattr(program, "_folded", {})
        kept, n = [], 0
        for op in blk.ops:
            # foldable: deterministic, every symbolic input already folded
            # (feeds never are, so feed-derived ops stay), and no captured
            # eager tensor at all: captures are late-bound by contract and
            # folding would snapshot them
            foldable = (
                not _is_stochastic(op)
                and all(id(v) in folded for v in op.inputs)
                and not op.captured
            )
            if foldable:
                def resolve(a):
                    if isinstance(a, Variable):
                        return unwrap(folded[id(a)])
                    return a

                with torch.no_grad():
                    out = op.fn(*[resolve(a) for a in op.args], **op.kwargs)
                outs = out if isinstance(out, (tuple, list)) else [out]
                for v, o in zip(op.outputs, outs):
                    folded[id(v)] = o.as_subclass(Tensor)
                n += 1
            else:
                kept.append(op)
        blk.ops = kept
        program._folded = folded
        return n


_SIMPLE = (int, float, bool, str, bytes, tuple, type(None))


def _closure_fingerprint(fn):
    """Hashable description of a Python closure, or None if it cannot be
    fingerprinted. Two recordings of the same source op merge only when
    their captured cells hold equal simple values (numpy dtypes by name)
    or fingerprinted callables (the port's wrappers close over torch's
    functions, where JAX's ops are ``jnp`` functions themselves); a cell
    holding a tensor (a literal) or a torch dtype or device makes the op
    unmergeable, as a ``jnp`` dtype does in the JAX package."""
    code = getattr(fn, "__code__", None)
    if code is None:
        # closure-free shared callable (a torch builtin): identity is the
        # fingerprint — same object + same inputs => same value
        return ("id", id(fn))
    cells = ()
    if fn.__closure__:
        vals = []
        for c in fn.__closure__:
            v = c.cell_contents
            if isinstance(v, _SIMPLE):
                vals.append(v)
            elif isinstance(v, np.dtype):
                vals.append(str(v))
            elif callable(v) and not isinstance(v, (type, torch.nn.Module)):
                inner = _closure_fingerprint(v)
                if inner is None:
                    return None
                vals.append(inner)
            else:
                return None
        cells = tuple(vals)
    return (code.co_code, code.co_consts if all(
        isinstance(c, _SIMPLE) for c in code.co_consts) else None, cells)


def cse_key(op: Operation, aliases: Dict[int, int]):
    """Hashable merge key for an op, or None when the op must never merge
    (stochastic, unfingerprintable closure, array-literal args)."""
    if _is_stochastic(op):
        return None
    fp = _closure_fingerprint(op.fn)
    if fp is None:
        return None
    try:
        kw = tuple(sorted((k, repr(v)) for k, v in op.kwargs.items()))
    except Exception:
        return None
    in_key = []
    for a in op.args:
        if isinstance(a, Variable):
            in_key.append(("v", resolve_alias(aliases, id(a))))
        elif isinstance(a, torch.Tensor):
            in_key.append(("c", id(a)))
        elif isinstance(a, (int, float, bool, str, bytes, type(None))):
            # key the type too: True == 1 == 1.0 under dict equality, but
            # merging ops whose scalar differs only in type changes dtypes
            in_key.append(("l", type(a).__name__, a))
        else:
            # repr() of arrays and objects can truncate and collide
            return None
    return (op.type, fp, tuple(in_key), kw)


class CommonSubexpressionEliminationPass(Pass):
    """Merge duplicate recorded ops (same fn fingerprint, same inputs, same
    kwargs); duplicate outputs become aliases the Executor resolves."""

    name = "cse"

    def apply(self, program: Program) -> int:
        blk = program.global_block()
        aliases: Dict[int, int] = getattr(program, "_aliases", {})
        seen: Dict[tuple, Operation] = {}
        kept, n = [], 0
        for op in blk.ops:
            key = cse_key(op, aliases)
            if key is None:
                kept.append(op)
                continue
            prev = seen.get(key)
            if prev is not None and len(prev.outputs) == len(op.outputs):
                for dup, canon in zip(op.outputs, prev.outputs):
                    aliases[id(dup)] = resolve_alias(aliases, id(canon))
                n += 1
            else:
                seen[key] = op
                kept.append(op)
        blk.ops = kept
        program._aliases = aliases
        return n


def apply_default_passes(program: Program, targets=None) -> Dict[str, int]:
    pm = PassManager([
        CommonSubexpressionEliminationPass(),
        ConstantFoldingPass(),
        DeadCodeEliminationPass(targets),
    ])
    return pm.run(program)
