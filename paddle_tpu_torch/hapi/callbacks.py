"""hapi callbacks — port of ``paddle_tpu/hapi/callbacks.py``: host-side
hooks around ``Model.fit``; ``VisualDL`` writes JSONL scalars and
``WandbCallback`` is a no-op without the ``wandb`` package, as in the JAX
package."""

from __future__ import annotations

import numbers
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None, model=None, verbose=2, metrics=None, log_freq=10):
        cbs = list(callbacks) if callbacks else []
        if verbose and not any(isinstance(c, ProgBarLogger) for c in cbs):
            cbs.insert(0, ProgBarLogger(log_freq, verbose=verbose))
        self.callbacks = cbs
        for c in self.callbacks:
            c.set_model(model)
            c.set_params({"verbose": verbose, "metrics": metrics or []})

    def on_begin(self, mode, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_begin")(logs)

    def on_end(self, mode, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_end")(logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_batch_begin")(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_batch_end")(step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = (logs or {}).get("steps")
        self._start = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            msg = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, numbers.Number) else f"{k}: {v}"
                for k, v in (logs or {}).items()
            )
            total = f"/{self.steps}" if self.steps else ""
            print(f"step {step}{total} - {msg}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            msg = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, numbers.Number) else f"{k}: {v}"
                for k, v in (logs or {}).items()
            )
            print(f"Epoch {epoch + 1} done in {dt:.1f}s - {msg}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(f"{self.save_dir}/final")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            self.model._optimizer._lr_step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            self.model._optimizer._lr_step()


class VisualDL(Callback):
    """Reference logs to VisualDL; here: CSV/JSONL scalars for TensorBoard-free envs."""

    def __init__(self, log_dir="./vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        self._f = None

    def on_train_begin(self, logs=None):
        import os

        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(f"{self.log_dir}/scalars.jsonl", "a")

    def on_train_batch_end(self, step, logs=None):
        import json

        if self._f:
            self._f.write(json.dumps({"step": step, **{k: float(v) if isinstance(v, numbers.Number) else str(v) for k, v in (logs or {}).items()}}) + "\n")

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()


class ReduceLROnPlateau(Callback):
    """Reduce LR when a monitored metric plateaus (reference:
    hapi/callbacks.py ReduceLROnPlateau)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.greater = mode == "max" or (mode == "auto" and "acc" in monitor)
        self._best = None
        self._wait = 0
        self._cool = 0

    def _better(self, cur):
        if self._best is None:
            return True
        if self.greater:
            return cur > self._best + self.min_delta
        return cur < self._best - self.min_delta

    def on_eval_end(self, logs=None):
        self._check(logs or {})

    def on_epoch_end(self, epoch, logs=None):
        self._check(logs or {})

    def _check(self, logs):
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self._better(cur):
            self._best = cur
            self._wait = 0
            return
        if self._cool > 0:
            # cooling down: hold the LR, don't accumulate patience
            self._cool -= 1
            self._wait = 0
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                from ..optimizer.lr import LRScheduler

                if isinstance(opt._lr, LRScheduler):
                    import warnings

                    warnings.warn(
                        "ReduceLROnPlateau: optimizer uses an LRScheduler — "
                        "set_lr would replace the schedule; skipping the "
                        "reduction (reference paddle raises here)")
                else:
                    old = opt.get_lr()
                    new = max(old * self.factor, self.min_lr)
                    if new < old:
                        opt.set_lr(new)
                        if self.verbose:
                            print(f"ReduceLROnPlateau: lr {old:.3g} -> {new:.3g}")
            self._cool = self.cooldown
            self._wait = 0


class WandbCallback(Callback):
    """Weights & Biases logging (reference: hapi/callbacks.py WandbCallback).
    Gated on the wandb package being importable; otherwise a no-op logger."""

    def __init__(self, project=None, name=None, dir=None, mode=None, **kwargs):
        super().__init__()
        self._kw = dict(project=project, name=name, dir=dir, mode=mode,
                        **kwargs)
        try:
            import wandb  # noqa: F401

            self._wandb = wandb
        except ImportError:
            self._wandb = None

    def on_train_begin(self, logs=None):
        if self._wandb is not None:
            self._run = self._wandb.init(**{k: v for k, v in self._kw.items()
                                            if v is not None})

    def on_epoch_end(self, epoch, logs=None):
        if self._wandb is not None and logs:
            self._wandb.log({f"train/{k}": v for k, v in logs.items()},
                            step=epoch)

    def on_train_end(self, logs=None):
        if self._wandb is not None:
            self._wandb.finish()
