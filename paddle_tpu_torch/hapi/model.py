"""``hapi.Model`` — port of ``paddle_tpu/hapi/model.py``: ``prepare``, the
batch steps, ``fit`` / ``evaluate`` / ``predict``, ``save`` / ``load`` and
``summary``.

``train_batch`` is the JAX package's jitted step (``_build_train_step``
:49-128) run eagerly: the network in training mode, the loss, the
gradients of every trainable parameter (``torch.autograd``; a parameter
the loss never reads gets a zero gradient, as under ``jax.grad``), the
gradients in fp32, the optimizer's clip on them (hapi's formulas :80-95,
which are the clip classes' own; not the Engine's clip), then the
optimizer's ``_functional_update`` with ``lr`` and the step count as fp32
device scalars. BatchNorm layers update their
running statistics in place during the forward, as the JAX step's carried
buffer updates do. The optimizer's accumulators stay in the optimizer (the
JAX step carries them in the Model), so ``save`` writes them to the
``.pdopt``. It returns ``[float(loss)]`` and each metric's ``update``
(``compute`` on the device, ``update`` on the host copy). The JAX
package's eager step computes the same update, so ``prepare(jit=...)`` is
accepted either way and there is one path.

The batch steps take inputs already on the network's device. ``fit``,
``evaluate`` and ``predict`` move each loader batch there (pinned memory,
``non_blocking``).
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from ..framework import io as fio
from ..io import DataLoader
from ..io.dataset import Dataset
from ..optimizer import name_parameters
from .callbacks import CallbackList


def _refuse(what):
    """The refusal of an argument that the JAX package takes and ignores
    (ROADMAP Queue 1, item 8.7: refused, not ported, since accepting it
    would ignore it and honouring it would add what the JAX package
    lacks)."""
    return NotImplementedError(
        f"{what} is not supported: the JAX package takes it and ignores it "
        f"(ROADMAP Queue 1, item 8.7)")


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


class Model:
    def __init__(self, network, inputs=None, labels=None):
        if inputs is not None or labels is not None:
            raise _refuse("Model(inputs=..., labels=...) input specs")
        self.network = name_parameters(network)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    # ---- configuration ----
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=True):
        if amp_configs is not None:
            raise _refuse("Model.prepare(amp_configs=...) (paddle.amp)")
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = (list(metrics) if isinstance(metrics,
                                                         (list, tuple))
                             else [metrics])

    # ---- batch steps ----
    def _loss_of(self, outs, ys):
        loss = self._loss(*outs, *ys)
        return loss[0] if isinstance(loss, (list, tuple)) else loss

    @torch.no_grad()
    def _apply(self, params, grads):
        """The optimizer's update of ``params`` in place from ``grads``."""
        opt = self._optimizer
        opt._step_count += 1
        # plain torch ops on the Paddle Parameters (no Python dispatch)
        with torch._C.DisableTorchFunctionSubclass():
            grads = [g.float() for g in grads]
            if opt._grad_clip is not None:
                grads = [g for _, g in opt._grad_clip(list(zip(params,
                                                               grads)))]
            dev = params[0].device
            lr = torch.full((), opt.get_lr(), dtype=torch.float32, device=dev)
            step = torch.full((), float(opt._step_count), dtype=torch.float32,
                              device=dev)
            new_vals, opt._accumulators = opt._functional_update(
                grads, [p.detach() for p in params], params,
                opt._accumulators, lr, step)
            for p, v in zip(params, new_vals):
                p.copy_(v)

    def train_batch(self, inputs, labels=None, update=True):
        if not update:
            raise _refuse("Model.train_batch(update=False) (gradient "
                         "accumulation)")
        self.network.train()
        ys = _as_list(labels)
        out = self.network(*_as_list(inputs))
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        loss = self._loss_of(outs, ys)
        with torch._C.DisableTorchFunctionSubclass():   # see _apply
            params = [p for p in self.network.parameters()
                      if p.requires_grad]
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        self._apply(params, grads)
        metrics = self._update_metrics([o.detach() for o in outs], ys)
        return [loss.item()], metrics

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        ys = _as_list(labels)
        out = self.network(*_as_list(inputs))
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        loss = None
        if self._loss is not None and ys:
            loss = self._loss_of(outs, ys)
        metrics = self._update_metrics(outs, ys)
        return ([loss.item()] if loss is not None else []), metrics

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        return self.network(*_as_list(inputs))

    def _update_metrics(self, preds, ys):
        results = []
        for m in self._metrics:
            inp = m.compute(preds[0], *ys)
            if isinstance(inp, tuple):
                results.append(m.update(*[_host(x) for x in inp]))
            else:
                results.append(m.update(_host(inp)))
        return results

    # ---- high level ----
    def _device(self):
        for t in itertools.chain(self.network.parameters(),
                                 self.network.buffers()):
            return t.device
        return torch.device("cpu")

    def _to_net(self, data):
        """A split loader batch on the network's device (pinned and
        copied without blocking to a card)."""
        dev = self._device()

        def move(t):
            if not isinstance(t, torch.Tensor):
                t = torch.as_tensor(np.asarray(t))
            if dev.type == "cuda":
                return t.pin_memory().to(dev, non_blocking=True)
            return t.to(dev)

        return [[move(t) for t in part] for part in data]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        if accumulate_grad_batches != 1:
            raise _refuse("Model.fit(accumulate_grad_batches=...) (gradient "
                         "accumulation)")
        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        eval_loader = self._loader(eval_data, batch_size, num_workers)

        cbks = CallbackList(callbacks, model=self, verbose=verbose,
                            metrics=["loss"] + [m.name()
                                                for m in self._metrics],
                            log_freq=log_freq)
        cbks.on_begin("train")
        steps = None
        try:
            steps = len(train_loader)
        except TypeError:
            pass
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch, {"steps": steps})
            for m in self._metrics:
                m.reset()
            it = 0
            for batch in train_loader:
                data = self._to_net(self._split_batch(batch))
                cbks.on_batch_begin("train", it, {})
                losses, metrics = self.train_batch(*data)
                logs = {"loss": losses[0]}
                for m, r in zip(self._metrics, metrics):
                    logs[m.name()] = r
                cbks.on_batch_end("train", it, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    break
            self._optimizer._lr_step()
            epoch_logs = {"loss": losses[0]}
            for m in self._metrics:
                epoch_logs[m.name()] = m.accumulate()
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                epoch_logs.update({"eval_" + k: v
                                   for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, epoch_logs)
            if save_dir is not None and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
        cbks.on_end("train")
        if save_dir is not None:
            self.save(f"{save_dir}/final")

    def _loader(self, data, batch_size, num_workers):
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size,
                              num_workers=num_workers)
        return data

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = self._loader(eval_data, batch_size, num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        it = 0
        for batch in loader:
            loss, _ = self.eval_batch(*self._to_net(self._split_batch(batch)))
            if loss:
                losses.append(loss[0])
            it += 1
            if num_iters is not None and it >= num_iters:
                break
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs[m.name()] = m.accumulate()
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._loader(test_data, batch_size, num_workers)
        return [self.predict_batch(self._to_net(self._split_batch(b))[0])
                for b in loader]

    def _split_batch(self, batch):
        """A loader batch as (inputs, labels), the hapi convention."""
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return ([batch[:-1], [batch[-1]]] if len(batch) > 2
                    else [[batch[0]], [batch[1]]])
        return [[batch], []]

    # ---- persistence ----
    def save(self, path, training=True):
        fio.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        self.network.load_state_dict(fio.load(path + ".pdparams"))
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(path + ".pdopt")):
            self._optimizer.set_state_dict(fio.load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters())

    def summary(self, input_size=None, dtype=None):
        from .summary import summary

        return summary(self.network, input_size)

    def flops(self, input_size, print_detail=False):
        """FLOPs of one forward at ``input_size`` (``paddle.flops``)."""
        from .flops import flops

        return flops(self.network, input_size, print_detail=print_detail)
