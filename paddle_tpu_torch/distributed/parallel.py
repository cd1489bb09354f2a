"""Process bootstrap and ``DataParallel`` — port of ``paddle_tpu/
distributed/parallel.py`` on ``torch.distributed``.

The JAX package starts ``jax.distributed`` from the launcher's
environment; the port starts a ``torch.distributed`` world from the same
environment (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_RANK_IN_NODE``, ``MASTER_ADDR``/``MASTER_PORT``), one process
per rank. The backend is NCCL on the card and gloo when the caller asked
for the CPU (``set_device("cpu")``); ``PADDLE_DISTRI_BACKEND`` (Paddle's
variable, which ``spawn(backend=)`` sets) chooses another, for example
gloo over CUDA tensors. With no launcher environment the world is this
one process.
"""

from __future__ import annotations

import contextlib
import multiprocessing as _mp
import os
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..nn.layer.layers import Layer
from .communication.group import Group, get_default_group

_BACKENDS = ("nccl", "gloo")


class ParallelEnv:
    """The launcher's environment, as Paddle's ``ParallelEnv`` reads it."""

    @property
    def rank(self):
        v = os.environ.get("PADDLE_TRAINER_ID")
        return int(v) if v is not None else get_rank()

    @property
    def world_size(self):
        v = os.environ.get("PADDLE_TRAINERS_NUM")
        return int(v) if v is not None else get_world_size()

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_RANK_IN_NODE", 0))

    @property
    def device_id(self):
        n = torch.cuda.device_count()
        return self.local_rank % n if n else 0

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []


def free_port() -> int:
    """A TCP port on localhost that was free when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _backend(device: torch.device) -> str:
    b = os.environ.get("PADDLE_DISTRI_BACKEND", "auto").lower()
    if b == "auto":
        return "nccl" if device.type == "cuda" else "gloo"
    if b not in _BACKENDS:
        raise ValueError(f"backend {b!r}: the port runs 'nccl' or 'gloo'")
    if b == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs the card; the CPU runs gloo")
    return b


def init_parallel_env():
    """Start this rank's ``torch.distributed`` world from the launcher's
    environment (idempotent); returns the default group."""
    if dist.is_initialized():
        return get_default_group()
    env = ParallelEnv()
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    device = resolve_device(None)
    if device.type == "cuda":
        torch.cuda.set_device(env.device_id)
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT")
    if port is None:
        if world > 1:
            raise RuntimeError("a world of several ranks needs MASTER_PORT "
                               "(spawn sets it)")
        port = free_port()
    dist.init_process_group(_backend(device),
                            init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank)
    return get_default_group()


def get_rank(group: Optional[Group] = None) -> int:
    if not dist.is_initialized():
        return 0
    r = dist.get_rank()
    return group.get_group_rank(r) if group is not None else r


def get_world_size(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.nranks
    return dist.get_world_size() if dist.is_initialized() else 1


def is_initialized() -> bool:
    return dist.is_initialized()


class DataParallel(Layer):
    """Data parallelism over a group (Paddle's ``DataParallel``): each rank
    runs ``layers`` on its own batch; rank 0's parameters are broadcast at
    construction, and each parameter's gradient is averaged over the group
    as soon as backward has accumulated it. Under :meth:`no_sync` the
    gradients stay local (gradient accumulation)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.group = group
        self.find_unused_parameters = find_unused_parameters
        self._sync = True
        self._n = get_world_size(group)
        if self._n > 1:
            pg = group.pg if group is not None else None
            src = group.ranks[0] if group is not None else 0
            with torch.no_grad():
                for p in layers.parameters():
                    dist.broadcast(p.data, src=src, group=pg)
            for p in layers.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._average)

    def _average(self, p):
        if not self._sync or p.grad is None:
            return
        pg = self.group.pg if self.group is not None else None
        dist.all_reduce(p.grad, group=pg)
        p.grad.div_(self._n)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def scale_loss(self, loss):
        return loss

    @contextlib.contextmanager
    def no_sync(self):
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev


def _spawn_worker(func, args, rank, nprocs, master_port, backend, place):
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_RANK_IN_NODE": str(rank),
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(master_port),
        "PADDLE_DISTRI_BACKEND": backend,
    })
    if place is not None:
        from ..device import set_device

        set_device(place)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Run ``func(*args)`` in ``nprocs`` new processes, one rank each, with
    the launcher's environment set (Paddle's ``spawn``); ``nprocs`` of -1,
    0 or 1 calls it here. Options: ``backend`` ("auto", "nccl", "gloo"),
    ``master_port`` (default: a free port) and ``timeout`` (seconds for
    the join, after which every child is killed and an error raised)."""
    if nprocs in (-1, 0, 1):
        func(*args)
        return None
    backend = options.get("backend", "auto")
    port = options.get("master_port") or free_port()
    from .. import device as _device

    place = None if _device._PLACE is None else str(_device._PLACE)
    ctx = _mp.get_context("spawn")
    procs = [ctx.Process(target=_spawn_worker,
                         args=(func, args, r, nprocs, port, backend, place),
                         daemon=daemon)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    if not join:
        return procs
    timeout = options.get("timeout")
    deadline = None if timeout is None else time.monotonic() + timeout
    for p in procs:
        p.join(None if deadline is None
               else max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung:
        raise RuntimeError(f"spawn: {len(hung)} worker(s) still running "
                           f"after {timeout} s were killed")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"spawn workers failed with exit codes {bad}")
    return None
