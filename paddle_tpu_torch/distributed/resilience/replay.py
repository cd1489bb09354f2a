"""Replay a captured bad batch in isolation — the library half of the JAX
package's ``tools/replay_batch.py``.

``BadBatchRecorder`` (``framework/numeric_guard.py``) dumps the offending
batch, step, rng seed and health word to ``<ckpt_dir>/badbatch/
step_<n>/`` when the guarded train step flags it. :func:`replay` re-runs
that batch through a freshly built guarded engine (optionally restored to
the checkpoint at or before the captured step) and reports whether the
anomaly reproduces, which separates data-dependent anomalies (a poisoned
batch NaNs any state) from state-dependent ones. A capture of either
package replays here: the files are the same format.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ...framework.numeric_guard import describe_health

__all__ = ["load_capture", "restore_ring_state", "replay"]


def load_capture(capture_dir: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """``(meta, arrays)`` of one ``step_<n>`` capture directory."""
    with open(os.path.join(capture_dir, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(capture_dir, "batch.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return meta, arrays


def restore_ring_state(engine, ckpt_dir: str, step: int) -> Optional[int]:
    """Load the newest checkpoint at or before ``step`` into ``engine``
    (the state the guarded step saw); the restored step, or None when the
    ring holds none."""
    from ..checkpoint import load_state_dict
    from .trainer import ResilientTrainer

    ring = ResilientTrainer(lambda alive: engine, ckpt_dir,
                            save_every=10 ** 9)
    candidates = [s for s in ring._recorded_steps() if s <= step]
    if not candidates:
        return None
    sd = engine.state_dict()
    load_state_dict(sd, ring._step_dir(candidates[-1]))
    engine.set_state_dict(sd)
    return candidates[-1]


def replay(capture_dir: str, builder: Callable,
           ckpt_dir: Optional[str] = None) -> dict:
    """Re-run a capture through ``builder()`` (an Engine built with
    ``guard=``). Returns ``{"captured", "replayed", "restored_step",
    "reproduced", "report"}``: the two health words, the checkpoint step
    restored (None: fresh init), whether the replay flagged an anomaly,
    and the lines ``tools/replay_batch.py`` prints."""
    meta, arrays = load_capture(capture_dir)
    engine = builder()
    if getattr(engine, "guard", None) is None:
        raise ValueError("the builder returned an Engine without guard=: "
                         "the replay needs the health word")
    restored = (restore_ring_state(engine, ckpt_dir, meta["step"])
                if ckpt_dir else None)
    keys = meta.get("arrays") or sorted(arrays)
    engine.step(*[arrays[k] for k in keys])
    word = int(engine.last_health)
    reproduced = bool(word)
    report = [
        f"capture:  step {meta['step']} health {meta['health_word']} "
        f"({'|'.join(meta['bits'])}, {', '.join(meta['codes'])})",
        f"replayed: health {word} ({describe_health(word)})"
        + (f" from ring step {restored}" if restored is not None
           else " from fresh init"),
        "REPRODUCED" if reproduced else
        "NOT REPRODUCED (state-dependent anomaly — replay with the run's "
        "checkpoint ring)"]
    return {"captured": int(meta["health_word"]), "replayed": word,
            "restored_step": restored, "reproduced": reproduced,
            "report": report}
