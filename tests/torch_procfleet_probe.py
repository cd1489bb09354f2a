"""A worker engine factory that records the worker's imports
(tests/test_torch_procfleet.py): it writes the spawned process's pid and
``sys.modules`` to ``modules_path``, then builds the preset's engine. It
imports nothing of the JAX package, so a spawned worker's modules are the
port's own."""

import json
import os
import sys


def probed_engine(modules_path, **kw):
    with open(modules_path, "w") as f:
        json.dump({"pid": os.getpid(), "modules": sorted(sys.modules)}, f)
    from paddle_tpu_torch.inference.procfleet.presets import \
        tiny_llama_engine

    return tiny_llama_engine(**kw)
