"""AMP debugging tools — port of ``paddle_tpu/amp/debugging.py``
(reference: python/paddle/amp/debugging.py).

``check_numerics`` reports into the numeric health word
(``framework/numeric_guard.report_nan_inf``) and raises or warns per its
debug mode; ``enable_tensor_checker`` arms the dispatcher's nan/inf check
(``FLAGS_check_nan_inf``) and ``disable_tensor_checker`` restores the level
that was set before; ``enable_operator_stats_collection`` /
``collect_operator_stats`` count the ops AMP ran in low precision.

``dump_tensor_stats`` plugs a :class:`_StatsRecorder` into the dispatcher
(``core/op_registry.stats_recorder``): every op's floating outputs get the
JAX dump's statistics — the op name, ``out`` (the output's index),
``dtype`` as JAX writes it ("bfloat16"), ``shape``, ``mean_abs`` over the
finite values, ``max_abs``, ``num_nan`` and ``num_inf``. JAX reads four
host scalars an output; the port keeps each record's statistics on the
device and reads them all in one copy when the scope closes (or when
``records`` is read), so a dumped step pays one host sync, not one an op.
The JSON lines are the JAX package's, so a JAX dump and a port dump go
into the same :func:`compare_accuracy`.
"""

from __future__ import annotations

import contextlib
import json
import warnings

import torch

from .. import flags
from ..core import op_registry
from ..core.dtype import dtype_name
from ..core.tensor import Tensor, unwrap


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """Count the nan / inf of ``tensor`` (one host read). Detections report
    into the numeric health word (NAN_GRAD / INF_GRAD bits) and then raise
    ``FloatingPointError`` naming the op and var (CHECK_NAN_INF_AND_ABORT,
    the default where the ``check_nan_inf_level`` flag is 0) or warn
    (CHECK_NAN_INF). Returns (num_nan, num_inf) as tensors on the input's
    device."""
    a = unwrap(tensor)
    counts = torch.stack([torch.isnan(a).sum(), torch.isinf(a).sum()])
    num_nan, num_inf = (int(v) for v in counts.tolist())
    if num_nan or num_inf:
        from ..framework import numeric_guard

        numeric_guard.report_nan_inf(num_nan, num_inf,
                                     source=f"{op_type}:{var_name}")
        msg = (f"[check_numerics] op={op_type} var={var_name}: {num_nan} "
               f"nan, {num_inf} inf")
        mode = debug_mode
        if mode is None:
            mode = (DebugMode.CHECK_NAN_INF_AND_ABORT
                    if flags.get_flag("check_nan_inf_level") == 0
                    else DebugMode.CHECK_NAN_INF)
        if mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
            raise FloatingPointError(msg)
        warnings.warn(msg)
    return (counts[0].as_subclass(Tensor), counts[1].as_subclass(Tensor))


@contextlib.contextmanager
def enable_operator_stats_collection():
    """Collect per-op low-precision execution counts under AMP."""
    flags.set_flags({"low_precision_op_list": 1})
    st = op_registry.amp_state
    try:
        yield
    finally:
        flags.set_flags({"low_precision_op_list": 0})
        if st is not None and st.low_precision_ops:
            print("<------------------------------ op list "
                  "------------------------------->")
            for name, count in sorted(st.low_precision_ops.items()):
                print(f"  {name:<40} low-precision calls: {count}")


def collect_operator_stats():
    st = op_registry.amp_state
    return dict(st.low_precision_ops) if st else {}


_checker_config = None
_saved_level = None


def enable_tensor_checker(checker_config=None):
    """Arm the dispatcher's nan/inf check per the config's debug mode:
    CHECK_NAN_INF_AND_ABORT raises on the first op output holding nan or
    inf (the error names the op), CHECK_NAN_INF warns and goes on; both
    report into the numeric health word."""
    global _checker_config, _saved_level
    cfg = checker_config if checker_config is not None \
        else TensorCheckerConfig()
    if not cfg.enable:
        disable_tensor_checker()
        return
    if _checker_config is None:     # stash the pre-checker level once
        _saved_level = flags.get_flag("check_nan_inf_level")
    _checker_config = cfg
    level = 0 if cfg.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT else 1
    flags.set_flags({"check_nan_inf": True, "check_nan_inf_level": level})


def disable_tensor_checker():
    """Disarm the checker and restore the pre-enable
    ``check_nan_inf_level`` (a warn-mode checker must not leave later
    ``check_numerics`` calls warning where they raised)."""
    global _checker_config, _saved_level
    _checker_config = None
    restore = {"check_nan_inf": False}
    if _saved_level is not None:
        restore["check_nan_inf_level"] = _saved_level
        _saved_level = None
    flags.set_flags(restore)


def tensor_checker_config():
    """The active TensorCheckerConfig (None when the checker is off)."""
    return _checker_config


class TensorCheckerConfig:
    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT, **kw):
        self.enable = enable
        self.debug_mode = debug_mode


class _StatsRecorder:
    """Per-op output statistics collected by the dispatcher
    (core/op_registry.stats_recorder). Each floating output's five device
    scalars (finite |x| sum, finite count, max |x|, nan and inf counts)
    wait in ``_pending`` until :meth:`flush` reads them all in one copy."""

    def __init__(self):
        self._done = []
        self._pending = []      # (op, out index, dtype, shape, stats)

    def record(self, op_name, outs):
        for out_idx, o in enumerate(outs):
            a = unwrap(o)
            if not (isinstance(a, torch.Tensor) and a.is_floating_point()):
                continue
            a32 = a.detach().float()
            finite = torch.isfinite(a32)
            masked = torch.where(finite, a32.abs(), 0.0)
            peak = masked.max() if a32.numel() else masked.sum()
            stats = torch.stack([masked.sum().double(),
                                 finite.sum().double(), peak.double(),
                                 torch.isnan(a32).sum().double(),
                                 torch.isinf(a32).sum().double()])
            self._pending.append((op_name, out_idx, dtype_name(a.dtype),
                                  list(a.shape), stats))

    def flush(self):
        """Read the pending statistics to the host (one copy) as the JAX
        recorder's dicts."""
        if not self._pending:
            return
        vals = torch.stack([p[4] for p in self._pending]).cpu().tolist()
        for (op, idx, dt, shape, _), (s, n, mx, nan, inf) in zip(
                self._pending, vals):
            self._done.append({
                "op": op, "out": idx, "dtype": dt, "shape": shape,
                "mean_abs": float(s / max(n, 1.0)), "max_abs": float(mx),
                "num_nan": int(nan), "num_inf": int(inf)})
        self._pending = []

    @property
    def records(self):
        self.flush()
        return self._done


@contextlib.contextmanager
def dump_tensor_stats(dump_path):
    """Record per-op output stats for every op the dispatcher runs in the
    scope and write them as JSON lines to ``dump_path`` when it closes, the
    format :func:`compare_accuracy` reads. Torch code outside the
    dispatcher (the port's models' direct torch calls, autograd's backward)
    is not seen, as JAX's jitted regions are not."""
    rec = _StatsRecorder()
    prev = op_registry.stats_recorder
    op_registry.stats_recorder = rec
    try:
        yield rec
    finally:
        op_registry.stats_recorder = prev
        with open(dump_path, "w") as f:
            for r in rec.records:
                f.write(json.dumps(r) + "\n")


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False,
                     rtol=1e-2, atol=1e-6):
    """Compare two :func:`dump_tensor_stats` dumps op by op (reference:
    ``paddle.amp.debugging.compare_accuracy``, debugging.py:595): records
    are aligned by (op, output, occurrence), the table is written as CSV
    to ``output_filename``, and the rows returned are those whose mean or
    max |x| differ beyond ``atol + rtol * |first|`` (the second run's
    divided by ``loss_scale``), that bring nan/inf the first run did not
    have, or that are missing in either run (status ``MISSING_IN_A`` /
    ``MISSING_IN_B``)."""
    import csv
    from collections import defaultdict

    if dump_all_tensors:
        warnings.warn("dump_all_tensors is not supported; comparing op "
                      "stats")

    def load(p):
        with open(p) as f:
            return [json.loads(line) for line in f if line.strip()]

    def keyed(recs):
        seen = defaultdict(int)
        out = {}
        for r in recs:
            k = (r["op"], r["out"], seen[(r["op"], r["out"])])
            seen[(r["op"], r["out"])] += 1
            out[k] = r
        return out

    a_by, b_by = keyed(load(dump_path)), keyed(load(another_dump_path))
    rows, flagged = [], []
    for k in sorted(set(a_by) | set(b_by), key=str):
        ra, rb = a_by.get(k), b_by.get(k)
        row = {"op": k[0], "out": k[1], "call": k[2]}
        if ra is None or rb is None:
            row.update(status="MISSING_IN_" + ("A" if ra is None else "B"))
            rows.append(row)
            flagged.append(row)
            continue
        scale = float(loss_scale) or 1.0
        mean_b, max_b = rb["mean_abs"] / scale, rb["max_abs"] / scale
        mean_err = abs(ra["mean_abs"] - mean_b)
        max_err = abs(ra["max_abs"] - max_b)
        denom_mean = max(abs(ra["mean_abs"]), atol)
        denom_max = max(abs(ra["max_abs"]), atol)
        new_nonfinite = (rb["num_nan"] + rb["num_inf"]) > (
            ra["num_nan"] + ra["num_inf"])
        bad = (mean_err > atol + rtol * denom_mean
               or max_err > atol + rtol * denom_max
               or new_nonfinite)
        row.update(dtype_a=ra["dtype"], dtype_b=rb["dtype"],
                   mean_abs_a=ra["mean_abs"], mean_abs_b=mean_b,
                   max_abs_a=ra["max_abs"], max_abs_b=max_b,
                   mean_abs_err=mean_err, max_abs_err=max_err,
                   nan_inf_a=ra["num_nan"] + ra["num_inf"],
                   nan_inf_b=rb["num_nan"] + rb["num_inf"],
                   status="EXCESS_ERROR" if bad else "OK")
        rows.append(row)
        if bad:
            flagged.append(row)

    fields = ["op", "out", "call", "status", "dtype_a", "dtype_b",
              "mean_abs_a", "mean_abs_b", "mean_abs_err",
              "max_abs_a", "max_abs_b", "max_abs_err",
              "nan_inf_a", "nan_inf_b"]
    with open(output_filename, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
        wr.writeheader()
        wr.writerows(rows)
    return flagged
