"""Metrics — port of ``paddle_tpu/metric/__init__.py``.

``compute`` runs on the device where the predictions live (torch ops);
``update`` and ``accumulate`` run on the host in numpy, as in the JAX
package: ``hapi.Model`` hands ``update`` the host copy of ``compute``'s
result.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """[..., maxk] fp32: 1 where the k-th largest prediction is the
        label."""
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        if label.ndim == pred.ndim and label.shape[-1] == 1:
            label = label[..., 0]
        # stable: tied predictions rank by index on every call (an
        # unstable CUDA sort can move a tied label across k between two
        # calls; JAX's numpy quicksort orders ties its own fixed way)
        top = torch.argsort(pred, dim=-1, descending=True,
                            stable=True)[..., :self.maxk]
        return (top == label[..., None]).to(torch.float32)

    def update(self, correct, *args):
        c = _np(correct)
        accs = []
        for i, k in enumerate(self.topk):
            num = c[..., :k].sum()
            self.total[i] += float(num)
            self.count[i] += int(np.prod(c.shape[:-1]))
            accs.append(float(num) / max(int(np.prod(c.shape[:-1])), 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, -1]
        lab = _np(labels).reshape(-1)
        idx = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        for i, pos in zip(idx, lab):
            if pos:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_neg - tot_neg) * (new_pos + tot_pos) / 2
            tot_pos, tot_neg = new_pos, new_neg
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the ``k`` largest
    predictions, as an fp32 0-dim tensor on the predictions' device."""
    pred = torch.as_tensor(input)
    lab = torch.as_tensor(label, device=pred.device)
    if lab.ndim == pred.ndim and lab.shape[-1] == 1:
        lab = lab[..., 0]
    topk = torch.argsort(pred, dim=-1, descending=True, stable=True)[..., :k]
    hit = (topk == lab[..., None]).any(dim=-1)
    return hit.to(torch.float32).mean()
