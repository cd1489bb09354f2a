"""``Engine(model, mesh)`` over a ``sep`` dim (context parallelism: the
sequence sharded, attention through ring attention) against the JAX
package's ``Engine`` on a mesh of the same shape, fp32 on the CPU.

One world of 4 gloo ranks (this file is also the ranks' script, ``python
test_torch_dist_sep.py sep DIR``) trains the port's tiny Llama (4 q / 2 kv
heads, from the JAX model's weights) three steps on ``{"sep": 4}`` and
``{"sep": 2, "tp": 2}``, and on ``{"sep": 4}`` with labels that hold
-100 at the first position of two shards (a per-shard shift of the labels
would drop the pair at every shard boundary and miscount; its JAX
reference is the JAX engine on one device, whose shift is the global
one), while this process runs the JAX engines in threads.

Tolerances (tests/test_torch_dist_engine.py's): losses relative 2e-4;
parameters after three steps within 2 * lr * steps of JAX's, at most 0.1%
of the elements more than 2e-5 apart. The port's own ``mesh=None`` run on
the same batches: losses relative 2e-4. And one step's collectives on
``{"sep": 4}`` gather nothing through DTensor (its functional all-gather
is what two gloo ranks sharing a card cannot run, PERF.md section 7).
"""

import os

import numpy as np
import pytest

LR, STEPS, SEQ = 1e-3, 3, 16
CASES = {"sep4": {"sep": 4}, "sep2_tp2": {"sep": 2, "tp": 2},
         "sep4_ignore": {"sep": 4}}


def _batches(case):
    rng = np.random.default_rng(0)
    ids = [rng.integers(0, 256, (4, SEQ)).astype(np.int64)
           for _ in range(STEPS)]
    labels = [b.copy() for b in ids]
    if case == "sep4_ignore":
        # the first position of shards 1 and 2: the label that the last
        # position of shards 0 and 1 predicts
        for lb in labels:
            lb[:, SEQ // 4] = -100
            lb[1:, SEQ // 2] = -100
    return ids, labels


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _suite_sep(workdir, rank, world):
    from torch.distributed.tensor.debug import CommDebugMode

    from paddle_tpu_torch.distributed.auto_parallel import Engine, make_mesh
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.weights import load_jax_state

    with np.load(os.path.join(workdir, "sep_in.npz")) as z:
        weights = {k: z[k] for k in z.files}

    def engine(mesh):
        m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        load_jax_state(m, weights)
        return Engine(m, mesh, lr=LR)

    out = {}
    meshes = {}
    for case, axes in CASES.items():
        key = tuple(axes.items())
        mesh = meshes.setdefault(key, make_mesh(axes))
        ids, labels = _batches(case)
        eng = engine(mesh)
        losses = [float(eng.step(i, lb)) for i, lb in zip(ids, labels)]
        sd = eng.state_dict()
        ref = engine(None)
        alone = [float(ref.step(i, lb)) for i, lb in zip(ids, labels)]
        res = {"losses": losses, "alone": alone}
        if rank == 0:
            res["model"] = {n: t.detach().numpy().copy()
                            for n, t in sd["model"].items()}
        with CommDebugMode() as comm:
            eng.step(ids[0], labels[0])
        res["comms"] = {str(k).split(".")[-1]: v
                        for k, v in comm.get_comm_counts().items()}
        out[case] = res
    return out


# ---------------------------------------------------------------------------
# the JAX engines
# ---------------------------------------------------------------------------

def _jax_model(mesh=None):
    import paddle_tpu as paddle
    from paddle_tpu.distributed.auto_parallel import axis_rules
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM

    paddle.seed(42)
    with axis_rules(mesh):
        return LlamaForCausalLM(LlamaConfig.tiny())


def _jax_case(case, mesh, model):
    from paddle_tpu.distributed.auto_parallel import Engine

    eng = Engine(model, mesh, lr=LR)
    ids, labels = _batches(case)
    losses = [float(eng.step(*eng.shard_batch(i.astype(np.int32),
                                              lb.astype(np.int32))))
              for i, lb in zip(ids, labels)]
    return {"losses": losses,
            "model": {n: np.asarray(p) for n, p in zip(eng._param_names,
                                                       eng.params)}}


def _jax_runs(weights):
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu.distributed.auto_parallel import make_mesh
    from paddle_tpu_torch.weights import state_from_jax_layer

    models = {}
    for case, axes in CASES.items():
        # the ignored labels' reference is JAX's engine on one device: the
        # same global shift, and the cheapest program to compile
        mesh = make_mesh(axes) if case != "sep4_ignore" else None
        model = _jax_model(mesh)
        st = state_from_jax_layer(model)
        assert all(np.array_equal(st[k], weights[k]) for k in st)
        models[case] = (mesh, model)
    with ThreadPoolExecutor(len(CASES)) as pool:
        futs = {c: pool.submit(_jax_case, c, *models[c])
                for c in CASES}
        return {c: f.result() for c, f in futs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from torch_dist_harness import launch

    from paddle_tpu_torch.weights import state_from_jax_layer

    d = tmp_path_factory.mktemp("sep")
    weights = state_from_jax_layer(_jax_model())
    np.savez(d / "sep_in.npz", **weights)
    world = launch("sep", d, nprocs=4, timeout=200,
                   script=os.path.abspath(__file__))
    jax_out = _jax_runs(weights)
    return world.wait(), jax_out


def _params_close(got, ref):
    far = total = 0
    for name, r in ref.items():
        err = np.abs(got[name] - r)
        assert err.max() <= 2 * LR * STEPS, (name, err.max())
        far += int((err > 2e-5).sum())
        total += err.size
    assert far <= 1e-3 * total, (far, total)


@pytest.mark.parametrize("case", list(CASES))
def test_sep_losses_match_jax_and_mesh_none(runs, case):
    port, jax_out = runs
    for r in range(4):
        np.testing.assert_allclose(port[r][case]["losses"],
                                   jax_out[case]["losses"], rtol=2e-4)
        np.testing.assert_allclose(port[r][case]["losses"],
                                   port[r][case]["alone"], rtol=2e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_sep_parameters_match_jax(runs, case):
    port, jax_out = runs
    _params_close(port[0][case]["model"], jax_out[case]["model"])


def test_ignored_labels_across_shard_boundaries_count_as_jax(runs):
    """Two -100 labels at shard starts: the mean runs over the same
    positions as JAX's global shift (its engine on one device; a
    per-shard shift drops 3 of 15 pairs a row and gives another loss)."""
    port, jax_out = runs
    a, b = port[0]["sep4_ignore"]["losses"], port[0]["sep4"]["losses"]
    assert all(abs(x - y) > 1e-4 for x, y in zip(a, b))
    np.testing.assert_allclose(a, jax_out["sep4_ignore"]["losses"],
                               rtol=2e-4)


@pytest.mark.parametrize("case", ["sep4", "sep4_ignore"])
def test_sep_step_gathers_nothing_through_dtensor(runs, case):
    """A step over sep reduces (the loss's halves, the gradients of the
    replicated parameters) and never runs DTensor's all-gather: the
    sequence stays sharded end to end. The only gathers are ring
    attention's zigzag exchanges, c10d's own ``all_gather_into_tensor``
    (``_allgather_base_``): q, k, v in and the output out, forward and
    backward, in each of the 2 layers."""
    port, _ = runs
    comms = port[0][case]["comms"]
    assert all(port[r][case]["comms"] == comms for r in range(4))
    assert set(comms) == {"all_reduce", "_allgather_base_"}, comms
    assert comms["_allgather_base_"] == 4 * 2 * 2, comms


def test_segment_parallel_passes_through_as_jax():
    """``SegmentParallel`` wraps a model: its forward, ``state_dict`` and
    ``set_state_dict`` are the model's, in both packages (the sharding is
    the model's own)."""
    import paddle_tpu as paddle
    import paddle_tpu.distributed.fleet.meta_parallel as J
    import torch

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed.fleet.meta_parallel as T
    from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

    prev = pt.device._PLACE
    pt.set_device("cpu")
    try:
        paddle.seed(3)
        jm = paddle.nn.Linear(4, 3)
        tm = pt.nn.Linear(4, 3)
        load_jax_state(tm, state_from_jax_layer(jm))
        jw, tw = J.SegmentParallel(jm, None), T.SegmentParallel(tm, None)
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        np.testing.assert_allclose(
            tw(torch.from_numpy(x)).detach().numpy(),
            np.asarray(jw(paddle.to_tensor(x)).numpy()), rtol=1e-6)
        assert sorted(tw.state_dict()) == sorted(jw.state_dict())
        zero = {k: torch.zeros_like(v) for k, v in tw.state_dict().items()}
        tw.set_state_dict(zero)
        assert not any(bool(v.any()) for v in tm.state_dict().values())
    finally:
        pt.device._PLACE = prev


if __name__ == "__main__":
    from torch_dist_harness import rank_main

    rank_main({"sep": _suite_sep})
