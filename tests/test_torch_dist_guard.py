"""The guarded ``Engine`` over a mesh: one world of 2 gloo ranks on the
CPU for the whole file (this file is also the ranks' script:
``python test_torch_dist_guard.py DIR``, started like
``torch_dist_harness.launch`` starts its worlds and joined by its
``World``, whose time limit kills a hung rank).

The model is JAX's guard fixture (one ``Linear`` of 8, a float loss, lr
0.05, no clip) with the JAX model's seed-0 weights; its weight is
annotated ``("embed", "mlp")`` and its bias ``("mlp",)``, so tp shards
their columns. Each case takes 5 guarded steps (``skip_step``, warm-up 2,
spike factor 50) on float batches:
- ``dp2``: ``{"dp": 2}``; step 2's batch has a NaN in row 6, which lands
  in rank 1's rows only;
- ``tp2``: ``{"tp": 2}``; step 2's labels have a NaN in column 6, whose
  gradient lies in rank 1's shard of the weight only (rank 0's local
  gradients stay finite: without the OR over the ranks it would see
  NAN_LOSS alone);
- both: the fault plan's ``nan_grad`` at step 4.
Held: every rank reports the same word every step, equal to the port's
``mesh=None`` run and to the JAX engine's; the skipped steps leave each
rank's local parameters and moments bit-identical, the counter advancing;
the losses and final parameters within the mesh tests' rtol 2e-4
(tests/test_torch_dist_engine.py) of the port's ``mesh=None``; the
detector states within 1e-6.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

D, STEPS = 8, 5
CASES = {"dp2": {"dp": 2}, "tp2": {"tp": 2}}
POLICY = dict(action="skip_step", warmup_steps=2, spike_factor=50.0)


def _batch(case, step):
    rng = np.random.default_rng(1000 + step)
    x = rng.standard_normal((8, D)).astype(np.float32)
    y = rng.standard_normal((8, D)).astype(np.float32)
    if step == 1:
        if case == "dp2":
            x[6, 3] = np.nan          # rank 1's rows (4..7)
        else:
            y[2, 6] = np.nan          # a column of rank 1's shard (4..7)
    return x, y


def _plan(mod):
    return mod.FaultPlan(seed=2, specs=[
        mod.FaultSpec("numeric.step", "nan_grad", at=3, count=1)])


def _toy(pt, weights):
    from paddle_tpu_torch.distributed.auto_parallel import annotate

    class Toy(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pt.nn.Linear(D, D)
            annotate(self.fc.weight, "embed", "mlp")
            annotate(self.fc.bias, "mlp")

        def loss_fn(self, x, y):
            diff = self.fc(x) - y
            return (diff * diff).mean()

    from paddle_tpu_torch.weights import load_jax_state

    m = Toy()
    load_jax_state(m, weights)
    return m


def _run(case, weights, mesh=None):
    """The guarded run on this process (a rank of the world, or alone with
    ``mesh=None``): words, losses, skipped flags, guard state, state."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import Engine, GuardPolicy
    from paddle_tpu_torch.distributed.resilience import faults
    from paddle_tpu_torch.distributed.auto_parallel.engine import _local

    eng = Engine(_toy(pt, weights), mesh, lr=0.05, clip_norm=None,
                 guard=GuardPolicy(**POLICY))
    words, losses, unchanged, counts = [], [], [], []
    with _plan(faults):
        for s in range(STEPS):
            before = [_local(t).clone() for t in eng.params + eng.m + eng.v]
            loss = eng.step(*_batch(case, s))
            after = [_local(t) for t in eng.params + eng.m + eng.v]
            words.append(int(eng.last_health))
            losses.append(float(loss))
            unchanged.append(all(torch.equal(a, b)
                                 for a, b in zip(before, after)))
            counts.append(int(eng.step_count))
    sd = eng.state_dict()
    return {"words": words, "losses": losses, "unchanged": unchanged,
            "counts": counts, "guard_state": eng.guard_state.numpy().copy(),
            "model": {n: t.detach().numpy().copy()
                      for n, t in sd["model"].items()}}


def _rank_main(workdir):
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed.auto_parallel import make_mesh

    torch.set_num_threads(1)
    pt.set_device("cpu")
    pdist.init_parallel_env()
    rank = dist.get_rank()
    with np.load(os.path.join(workdir, "guard_in.npz")) as z:
        weights = {k: z[k] for k in z.files}
    out = {}
    try:
        for case, axes in CASES.items():
            out[case] = _run(case, weights, make_mesh(axes))
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)       # the other rank may wait in a collective
    tmp = os.path.join(workdir, f"guard.{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, os.path.join(workdir, f"guard.{rank}.pkl"))
    pdist.destroy_process_group()


def _launch(workdir, nprocs=2, timeout=150.0):
    from torch_dist_harness import ROOT, World, _free_port

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
        log = os.path.join(workdir, f"guard.{r}.log")
        logs.append(log)
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(workdir)],
                env=env, stdout=fh, stderr=subprocess.STDOUT, cwd=ROOT))
    return World("guard", workdir, procs, logs, time.monotonic() + timeout)


def _jax_words(weights):
    """The JAX engine's words on the same runs (mesh=None; the same
    fault plan)."""
    import jax  # noqa: F401  (on the CPU, as tests/conftest.py sets it)

    import paddle_tpu as paddle
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.distributed.auto_parallel import Engine
    from paddle_tpu.distributed.resilience import faults
    from paddle_tpu.framework.numeric_guard import GuardPolicy

    class Toy(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = paddle.nn.Linear(D, D)

        def loss_fn(self, x, y):
            out = self.fc(Tensor(x))
            diff = out._data - y
            return (diff * diff).mean()

    out = {}
    for case in CASES:
        paddle.seed(0)
        eng = Engine(Toy(), None, lr=0.05, clip_norm=None,
                     guard=GuardPolicy(**POLICY))
        words = []
        with _plan(faults):
            for s in range(STEPS):
                eng.step(*_batch(case, s))
                words.append(int(eng.last_health))
        out[case] = words
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import device as pt_device
    from paddle_tpu_torch.weights import state_from_jax_layer

    workdir = tmp_path_factory.mktemp("guard_world")
    paddle.seed(0)
    weights = state_from_jax_layer(paddle.nn.Linear(D, D))
    weights = {f"fc.{k}": v for k, v in weights.items()}
    np.savez(workdir / "guard_in.npz", **weights)
    world = _launch(str(workdir))
    # meanwhile: the JAX words and the port's own mesh=None runs
    jax_words = _jax_words(weights)
    prev = pt_device._PLACE
    pt.set_device("cpu")
    try:
        alone = {case: _run(case, weights) for case in CASES}
    finally:
        pt_device._PLACE = prev
    return world.wait(), alone, jax_words


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_rank_computes_the_same_word_as_mesh_none_and_jax(runs, case):
    ranks, alone, jax_words = runs
    words = [r[case]["words"] for r in ranks]
    assert words[0] == words[1] == alone[case]["words"] == jax_words[case]
    assert words[0][1] & 1 and words[0][1] & 4       # NAN_GRAD | NAN_LOSS
    assert words[0][3] & 1                           # the injected nan_grad


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_skips_leave_local_state_bit_identical(runs, case):
    ranks, alone, _ = runs
    for r in ranks:
        got = r[case]
        assert got["counts"] == list(range(1, STEPS + 1))
        assert got["unchanged"] == [bool(w) for w in got["words"]]
    assert alone[case]["unchanged"] == ranks[0][case]["unchanged"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_losses_and_state_equal_mesh_none(runs, case):
    ranks, alone, _ = runs
    ref = alone[case]
    for r in ranks:
        got = r[case]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-4)
        np.testing.assert_allclose(got["guard_state"], ref["guard_state"],
                                   rtol=1e-6, atol=1e-6)
        for name, want in ref["model"].items():
            np.testing.assert_allclose(got["model"][name], want, rtol=2e-4,
                                       atol=1e-6, err_msg=name)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
