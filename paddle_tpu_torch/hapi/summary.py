"""Model summary — port of ``paddle_tpu/hapi/summary.py``: the same table
text and returned dict. A row is each named sublayer (``named_modules()``)
that holds parameters of its own or has no sublayers."""

from __future__ import annotations

import numpy as np


def summary(net, input_size=None, dtypes=None, input=None):
    rows = []
    total_params = 0
    trainable = 0
    for name, layer in net.named_modules():
        n_params = 0
        for p in layer._parameters.values():
            if p is None:
                continue
            n = int(np.prod(p.shape)) if p.shape else 1
            n_params += n
        if n_params or not layer._modules:
            rows.append((name or layer.__class__.__name__, layer.__class__.__name__, n_params))
    seen = set()
    for p in net.parameters():
        if id(p) in seen:
            continue
        seen.add(id(p))
        n = int(np.prod(p.shape)) if p.shape else 1
        total_params += n
        if p.requires_grad:
            trainable += n
    width = max((len(r[0]) for r in rows), default=20) + 2
    print(f"{'Layer':<{width}}{'Type':<28}{'Params':>12}")
    print("-" * (width + 40))
    for name, typ, n in rows:
        print(f"{name:<{width}}{typ:<28}{n:>12,}")
    print("-" * (width + 40))
    print(f"Total params: {total_params:,}")
    print(f"Trainable params: {trainable:,}")
    return {"total_params": total_params, "trainable_params": trainable}
