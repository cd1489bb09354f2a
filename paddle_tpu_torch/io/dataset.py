"""Datasets — port of ``paddle_tpu/io/dataset.py``. Samples are host
(numpy) data; ``random_split`` draws from numpy's global RNG, as the JAX
package's does, so one ``np.random.seed`` gives both the same split."""

from __future__ import annotations

import bisect
from typing import List, Sequence


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        import numpy as np
        import torch

        assert all(t.shape[0] == tensors[0].shape[0] for t in tensors)
        self.tensors = tensors
        # device->host once: per-sample indexing (in a DataLoader worker
        # too) must run no torch op
        self._arrays = [t.detach().cpu().numpy()
                        if isinstance(t, torch.Tensor) else np.asarray(t)
                        for t in tensors]

    def __getitem__(self, index):
        return tuple(a[index] for a in self._arrays)

    def __len__(self):
        return self._arrays[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        assert all(len(d) == len(self.datasets[0]) for d in self.datasets)

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            item = d[idx]
            sample.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(sample)


class ChainDataset(IterableDataset):
    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        s = 0
        for d in self.datasets:
            s += len(d)
            self.cumulative_sizes.append(s)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = bisect.bisect_right(self.cumulative_sizes, idx)
        start = 0 if di == 0 else self.cumulative_sizes[di - 1]
        return self.datasets[di][idx - start]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None) -> List[Subset]:
    import numpy as np

    total = len(dataset)
    if abs(sum(lengths) - 1.0) < 1e-6 and all(isinstance(l, float) for l in lengths):
        lengths = [int(l * total) for l in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    assert sum(lengths) == total
    perm = np.random.permutation(total)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off : off + n].tolist()))
        off += n
    return out
