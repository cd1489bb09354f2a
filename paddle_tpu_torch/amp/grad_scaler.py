"""Dynamic loss scaling — port of ``paddle_tpu/amp/grad_scaler.py``
(reference: python/paddle/amp/grad_scaler.py:62 AmpScaler, :645
GradScaler).

fp16 training needs it (bf16 does not; a disabled scaler passes through).
``scale`` multiplies the loss by the scale; ``step`` unscales every
gradient (cast to fp32, divided by the scale, cast back to the gradient's
dtype), checks them all for inf/NaN with ONE host read, and runs the
optimizer only when every gradient is finite (the step is skipped on the
host); ``update`` adjusts the scale: halved (``decr_ratio``) after
``decr_every_n_nan_or_inf`` bad steps, doubled (``incr_ratio``) after
``incr_every_n_steps`` good ones. An overflow records ``OVERFLOW``
(PT-NUM-005) in the numeric health word.

``minimize(optimizer, loss)`` calls ``loss.backward()`` itself, then
``step`` and ``update`` (the JAX package's form, :54-57; the reference's
docs pass a loss whose backward the caller already ran): pass the scaled
loss and do not call ``backward`` first.
"""

from __future__ import annotations

import torch

from ..core.tensor import unwrap
from ..framework import numeric_guard


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0**15, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def _unscale_and_check(self, optimizer):
        """Unscale every gradient and set ``_found_inf`` with one host read
        for the whole parameter list."""
        flags = []
        # plain torch ops on the Paddle Parameters (no Python dispatch)
        with torch._C.DisableTorchFunctionSubclass():
            for p in optimizer._parameter_list or []:
                if p.grad is None:
                    continue
                g = unwrap(p.grad).float() / self._scale
                flags.append(torch.isfinite(g).all())
                p.grad = g.to(p.grad.dtype)
        found = bool(torch.stack(flags).logical_not().any()) if flags \
            else False
        self._found_inf = found
        if found:
            numeric_guard.record_health(numeric_guard.OVERFLOW,
                                        source="amp.grad_scaler")

    def minimize(self, optimizer, loss):
        loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self._unscale_and_check(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


class GradScaler(AmpScaler):
    """Reference: grad_scaler.py:645 — public API over AmpScaler."""

    def unscale_(self, optimizer):
        self._unscale_and_check(optimizer)
        # after an explicit unscale, step() must not divide again
        self._already_unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if getattr(self, "_already_unscaled", False):
            self._already_unscaled = False
            if not self._found_inf:
                optimizer.step()
            return
        super().step(optimizer)
