"""DataLoader — port of ``paddle_tpu/io/dataloader.py``.

Batches are CPU torch tensors made in the parent from numpy:
``torch.from_numpy`` of the stacked array, int64 for integer samples and
fp32 for floats (an fp64 array becomes fp32, as the JAX package's tensors
take its default dtype); the caller moves them to the device (``hapi.
Model.fit`` pins them and copies without blocking).

Single-process, iterable and no-batch modes run in the caller. The worker
mode forks ``num_workers`` processes (the JAX package's worker pool: index
batches in, collated batches out through the shared-memory ring or a
queue, order kept per batch index, a prefetch depth of ``prefetch_factor``
a worker). The parent may hold a CUDA context and a torch thread pool,
which a forked child must not touch: workers run the dataset and a numpy
collate only — no torch op, no CUDA — and the tensors are made in the
parent. ``skip_corrupt`` logs and skips samples that raise (PT-DATA-002);
a dead worker is respawned ``worker_respawn_limit`` times before the typed
``DataLoaderWorkerError`` (PT-DATA-001).
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import queue
import threading
from collections import namedtuple
from typing import Optional

import numpy as np

import torch

from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

WorkerInfo = namedtuple("WorkerInfo", ["id", "num_workers", "dataset"])
_worker_info: Optional[WorkerInfo] = None

# sentinel batch payload: every sample in the batch was corrupt and
# skip_corrupt dropped them — the parent skips the batch index entirely
_BATCH_SKIPPED = "__PT_DATA_BATCH_SKIPPED__"


class DataLoaderWorkerError(RuntimeError):
    """PT-DATA-001: a DataLoader worker process died unexpectedly (and its
    respawn budget is exhausted). Before this error existed a dead worker
    wedged ``_MultiProcessIter._recv`` forever."""

    code = "PT-DATA-001"


def get_worker_info():
    return _worker_info


def _from_np(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``arr`` (fp64 as fp32; a read-only array copied)."""
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif not arr.flags.writeable:
        arr = np.array(arr)
    return torch.from_numpy(arr)


def default_collate_fn(batch):
    """Stack samples into batched CPU tensors."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return _from_np(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return [default_collate_fn(list(s)) for s in transposed]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


def _np_collate(batch):
    """Worker-side collate producing picklable numpy (Tensors only in the parent)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (list, tuple)):
        return [_np_collate(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: _np_collate([d[k] for d in batch]) for k in sample}
    return batch


def _to_tensor(obj):
    if isinstance(obj, np.ndarray):
        return _from_np(obj)
    if isinstance(obj, list):
        return [_to_tensor(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_tensor(v) for k, v in obj.items()}
    return obj


def _np_sample(s):
    if isinstance(s, tuple):
        return tuple(t.numpy() if isinstance(t, torch.Tensor) else t
                     for t in s)
    return s.numpy() if isinstance(s, torch.Tensor) else s


def _worker_loop(dataset, index_queue, result_queue, collate_fn, worker_id, num_workers,
                 init_fn, shm_name=None, skip_corrupt=False):
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    if init_fn is not None:
        init_fn(worker_id)
    shm = None
    if shm_name is not None:
        from .shm_channel import ShmChannel

        try:
            shm = ShmChannel(shm_name, create=False)
        except Exception:
            shm = None  # fall back to the queue transport

    def emit(batch_idx, data, err):
        if shm is not None:
            try:
                shm.put((batch_idx, data, err))
                return
            except ValueError:
                pass  # batch larger than the ring — use the pickle queue
            except (EOFError, TimeoutError):
                return  # parent closed the channel; shutting down
        result_queue.put((batch_idx, data, err))

    while True:
        item = index_queue.get()
        if item is None:
            break
        batch_idx, indices = item
        try:
            if skip_corrupt:
                # PT-DATA-002: log-and-skip samples whose __getitem__
                # raises instead of killing the epoch
                samples = []
                for i in indices:
                    try:
                        samples.append(_np_sample(dataset[i]))
                    except Exception as e:
                        import warnings

                        warnings.warn(f"[PT-DATA-002] DataLoader worker "
                                      f"{worker_id} skipped sample {i}: {e!r}")
                if not samples:
                    emit(batch_idx, _BATCH_SKIPPED, None)
                    continue
            else:
                samples = [_np_sample(dataset[i]) for i in indices]
            data = collate_fn(samples) if collate_fn is not _np_collate else _np_collate(samples)
            emit(batch_idx, data, None)
        except Exception as e:  # surface worker errors to the parent
            if skip_corrupt:    # collate on a corrupt survivor set
                import warnings

                warnings.warn(f"[PT-DATA-002] DataLoader worker {worker_id} "
                              f"skipped batch {batch_idx} (collate): {e!r}")
                emit(batch_idx, _BATCH_SKIPPED, None)
            else:
                emit(batch_idx, None, repr(e))
    if shm is not None:
        shm.detach()


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None, persistent_workers=False,
                 skip_corrupt=False, worker_respawn_limit=1):
        self.dataset = dataset
        self.num_workers = num_workers
        self.collate_fn = collate_fn
        self.use_shared_memory = use_shared_memory
        self.prefetch_factor = max(prefetch_factor, 2)
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        # robustness policies (docs/NUMERIC_GUARD.md PT-DATA-001/002):
        # skip_corrupt logs-and-skips samples whose __getitem__/collate
        # raises; a dead worker is respawned worker_respawn_limit times
        # (its in-flight batches re-dispatched) before the typed
        # DataLoaderWorkerError surfaces.
        self.skip_corrupt = bool(skip_corrupt)
        self.worker_respawn_limit = max(0, int(worker_respawn_limit))
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_size = batch_size
            self.batch_sampler = None
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            if batch_size is None:
                self.batch_sampler = None
                self.batch_size = None
            else:
                self.batch_sampler = BatchSampler(dataset, shuffle=shuffle, batch_size=batch_size, drop_last=drop_last)
                self.batch_size = batch_size

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()

    def __iter__(self):
        if self._iterable_mode:
            return self._iter_iterable()
        if self.batch_sampler is None:
            return self._iter_no_batch()
        if self.num_workers == 0:
            return self._iter_single()
        return iter(_MultiProcessIter(self))

    def _iter_no_batch(self):
        cf = self.collate_fn or (lambda s: s)
        for i in range(len(self.dataset)):
            yield _to_tensor(cf(self.dataset[i]))

    def _iter_single(self):
        cf = self.collate_fn or default_collate_fn
        for indices in self.batch_sampler:
            if self.skip_corrupt:
                samples = []
                for i in indices:
                    try:
                        samples.append(self.dataset[i])
                    except Exception as e:
                        import warnings

                        warnings.warn(
                            f"[PT-DATA-002] DataLoader skipped sample {i}: {e!r}")
                if not samples:
                    continue
                try:
                    yield cf(samples)
                except Exception as e:
                    import warnings

                    warnings.warn(
                        f"[PT-DATA-002] DataLoader skipped batch (collate): {e!r}")
                continue
            samples = [self.dataset[i] for i in indices]
            yield cf(samples)

    def _iter_iterable(self):
        cf = self.collate_fn or default_collate_fn
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield cf(batch)
                batch = []
        if batch and not self.drop_last:
            yield cf(batch)


class _MultiProcessIter:
    """Ordered multi-process batch pipeline (cf. _DataLoaderIterMultiProcess)."""

    def __init__(self, loader: DataLoader):
        self.loader = loader
        self.collate = loader.collate_fn or _np_collate
        self.num_workers = loader.num_workers
        self._ctx = mp.get_context("fork")
        ctx = self._ctx
        self.index_queues = [ctx.Queue() for _ in range(self.num_workers)]
        self.result_queue = ctx.Queue()
        # Shared-memory ring transport (native shm_ring.cc) keeps bulk array
        # bytes out of the pickle pipe — reference dataloader_iter.py:370's
        # LoDTensorBlockingQueue role.
        self.shm = None
        self._shm_name = None
        if loader.use_shared_memory:
            from .shm_channel import ShmChannel

            if ShmChannel.available():
                shm_name = f"/pt_dl_{os.getpid()}_{id(self) & 0xFFFFFF:x}"
                try:
                    self.shm = ShmChannel(shm_name, capacity=64 << 20, create=True)
                    self._shm_name = shm_name
                except RuntimeError:
                    self.shm = None
        self.workers = []
        for wid in range(self.num_workers):
            self.workers.append(self._spawn_worker(wid))
        self.batches = list(loader.batch_sampler)
        self.send_idx = 0
        self.rcv_idx = 0
        self.cache = {}
        self._owner = {}                    # batch idx -> worker id
        self.respawns = [0] * self.num_workers
        # prime the pipeline
        for _ in range(self.num_workers * loader.prefetch_factor):
            self._dispatch()

    def _spawn_worker(self, wid):
        w = self._ctx.Process(
            target=_worker_loop,
            args=(self.loader.dataset, self.index_queues[wid],
                  self.result_queue, self.collate, wid, self.num_workers,
                  self.loader.worker_init_fn, self._shm_name,
                  self.loader.skip_corrupt),
            daemon=True,
        )
        w.start()
        return w

    def _dispatch(self):
        if self.send_idx >= len(self.batches):
            return
        # round-robin over LIVE workers: a reaped-without-respawn slot
        # (workers[wid] is None) must not swallow batches
        start = self.send_idx % self.num_workers
        for off in range(self.num_workers):
            wid = (start + off) % self.num_workers
            if self.workers[wid] is not None:
                break
        else:
            raise DataLoaderWorkerError(
                "[PT-DATA-001] no live DataLoader workers left to dispatch to")
        self.index_queues[wid].put((self.send_idx, self.batches[self.send_idx]))
        self._owner[self.send_idx] = wid
        self.send_idx += 1

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self.rcv_idx >= len(self.batches):
                self._shutdown()
                raise StopIteration
            while self.rcv_idx not in self.cache:
                idx, data, err = self._recv()
                self._owner.pop(idx, None)
                if err is not None:
                    self._shutdown()
                    raise RuntimeError(f"DataLoader worker failed: {err}")
                self.cache[idx] = data
            data = self.cache.pop(self.rcv_idx)
            self.rcv_idx += 1
            self._dispatch()
            if isinstance(data, str) and data == _BATCH_SKIPPED:
                continue        # every sample was corrupt (PT-DATA-002)
            return _to_tensor(data)

    def _recv(self):
        """Next (idx, data, err) from the shm ring or the queue — polling,
        so a dead worker is detected (PT-DATA-001) instead of wedging the
        epoch in a blocking get."""
        while True:
            if self.shm is not None:
                # Queue first (non-blocking): oversized batches and
                # attach-failed workers use it, and it must not pay the
                # shm wait per batch.
                try:
                    return self.result_queue.get_nowait()
                except queue.Empty:
                    pass
                try:
                    return self.shm.get(timeout=0.1)
                except TimeoutError:
                    pass
            else:
                try:
                    return self.result_queue.get(timeout=0.1)
                except queue.Empty:
                    pass
            self._reap_dead_workers()

    def _reap_dead_workers(self):
        """Detect worker death: respawn (once, by default) re-dispatching
        the dead worker's in-flight batches, or raise the typed
        DataLoaderWorkerError when the respawn budget is spent. A worker
        that died idle is respawned too (or its slot retired so _dispatch
        routes around it) — an idle death must not swallow future batches."""
        for wid, w in enumerate(self.workers):
            if w is None or w.is_alive():
                continue
            pending = sorted(i for i, o in self._owner.items() if o == wid)
            exitcode = w.exitcode
            if self.respawns[wid] >= self.loader.worker_respawn_limit:
                if pending:
                    self._shutdown()
                    raise DataLoaderWorkerError(
                        f"[PT-DATA-001] DataLoader worker {wid} died "
                        f"(exitcode {exitcode}) with batches {pending} in "
                        f"flight and no respawn budget left")
                self.workers[wid] = None    # retired; _dispatch skips it
                continue
            self.respawns[wid] += 1
            # fresh queue: the dead process may have left the old one in an
            # inconsistent state (feeder thread mid-pickle)
            self.index_queues[wid] = self._ctx.Queue()
            self.workers[wid] = self._spawn_worker(wid)
            for idx in pending:
                self.index_queues[wid].put((idx, self.batches[idx]))

    def _shutdown(self):
        for q in self.index_queues:
            try:
                q.put(None)
            except Exception:
                pass
        # Close the ring BEFORE joining: workers parked in a blocking push wake
        # on close (push returns closed) and can then see the None sentinel.
        if self.shm is not None:
            self.shm.close()
            self.shm = None
        for w in self.workers:
            if w is None:
                continue
            w.join(timeout=1)
            if w.is_alive():
                w.terminate()

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass
