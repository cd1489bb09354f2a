"""Start a world of gloo ranks for the port's distributed tests.

``launch(suite, workdir)`` starts ``nprocs`` processes of
``torch_dist_worker.py`` (or of ``script=``, a test file that is its own
rank script through :func:`rank_main`), one rank each, over a TCP rendezvous on a
localhost port found free at run time (several pytest workers run
worlds at once). ``World.wait()`` joins them within their own time limit:
a rank still running then is killed with the rest and the test fails
with each rank's log, so a hung rank never holds the suite. The workers
import the port only, never JAX; each runs its torch on one thread.
"""

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WORKER = HERE / "torch_dist_worker.py"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    def __init__(self, suite, workdir, procs, logs, deadline):
        self.suite, self.workdir = suite, Path(workdir)
        self.procs, self.logs, self.deadline = procs, logs, deadline

    def _log_tails(self):
        out = []
        for r, path in enumerate(self.logs):
            text = Path(path).read_text(errors="replace")[-3000:]
            out.append(f"--- rank {r} ---\n{text}")
        return "\n".join(out)

    def wait(self):
        """Every rank's result (a list indexed by rank)."""
        for p in self.procs:
            left = max(0.1, self.deadline - time.monotonic())
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                for q in self.procs:
                    q.wait()
                raise AssertionError(f"world {self.suite!r} did not finish "
                                     f"in time; killed\n{self._log_tails()}")
        codes = [p.returncode for p in self.procs]
        if any(codes):
            raise AssertionError(f"world {self.suite!r} exit codes {codes}\n"
                                 f"{self._log_tails()}")
        out = []
        for r in range(len(self.procs)):
            with open(self.workdir / f"{self.suite}.{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def launch(suite, workdir, nprocs=4, timeout=150.0, script=WORKER):
    port = _free_port()
    procs, logs = [], []
    for r in range(nprocs):
        env = dict(os.environ, PADDLE_TRAINER_ID=str(r),
                   PADDLE_TRAINERS_NUM=str(nprocs),
                   PADDLE_RANK_IN_NODE=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PADDLE_DISTRI_BACKEND="gloo",
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        log = Path(workdir) / f"{suite}.{r}.log"
        logs.append(log)
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, str(script), suite, str(workdir)],
                env=env, stdout=fh, stderr=subprocess.STDOUT, cwd=ROOT))
    return World(suite, workdir, procs, logs, time.monotonic() + timeout)


def rank_main(suites):
    """The body of a rank script (``python SCRIPT SUITE DIR``): join the
    world on the CPU, run ``suites[SUITE](workdir, rank, world)`` and
    pickle its result to ``DIR/SUITE.<rank>.pkl``; a failing rank exits at
    once (the others may wait in a collective)."""
    import traceback

    import torch
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as pdist

    suite, workdir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    pt.set_device("cpu")
    pdist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        out = suites[suite](workdir, rank, world)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    tmp = os.path.join(workdir, f"{suite}.{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, os.path.join(workdir, f"{suite}.{rank}.pkl"))
    dist.barrier()
    pdist.destroy_process_group()
