"""``paddle_tpu.io`` in the port: datasets, samplers and the DataLoader,
whose batches are CPU torch tensors (``io/dataloader.py``)."""

from .dataloader import (DataLoader, DataLoaderWorkerError,  # noqa: F401
                         default_collate_fn, get_worker_info)
from .dataset import (ChainDataset, ComposeDataset,  # noqa: F401
                      ConcatDataset, Dataset, IterableDataset, Subset,
                      TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler,  # noqa: F401
                      RandomSampler, Sampler, SequenceSampler,
                      SubsetRandomSampler, WeightedRandomSampler)
