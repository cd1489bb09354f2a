"""The port's collectives, placements, process meshes, logical-axis rules
and tensor-/sequence-parallel layers (``paddle_tpu_torch.distributed``),
run by 4 gloo ranks on the CPU.

One world runs every case (``torch_dist_worker.py``, suite
"distributed") and the tests read its results: each collective against
numpy, each rank's view; ``logical_to_spec`` for every rule of
``DEFAULT_RULES`` against the JAX package's ``PartitionSpec`` on a mesh
of the same shape; the parallel layers, the two sequence-parallel linears
and the vocab-parallel cross entropy against their dense forms, outputs
and gradients within 1e-5 (fp32; only summation orders differ). The
refusals left in item 6 each name their part.
"""

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

from torch_dist_harness import launch

W = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return launch("distributed", tmp_path_factory.mktemp("dist"),
                  nprocs=W, timeout=120).wait()


def _x(r):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + r + 1


def _expected(name, r):
    xs = [_x(i) for i in range(W)]
    big = np.arange(W * 2 * 3, dtype=np.float32).reshape(W * 2, 3)
    nxt, prv = (r + 1) % W, (r - 1) % W
    return {
        "all_reduce_sum": sum(xs), "all_reduce_max": xs[-1],
        "all_reduce_min": xs[0], "all_reduce_prod": np.prod(xs, axis=0),
        "all_reduce_avg": sum(xs) / W,
        "all_gather": xs, "all_gather_into_tensor": np.concatenate(xs),
        "all_gather_object": [{"rank": i} for i in range(W)],
        "reduce_scatter": (big * 10)[2 * r:2 * r + 2],
        "reduce_scatter_list": (big * 10)[2 * r:2 * r + 2],
        "broadcast": xs[1], "broadcast_object_list": ["from 2", 2],
        "reduce": sum(xs) if r == 0 else None,
        "scatter": xs[3] * (r + 10),
        "scatter_object_list": [f"obj{r}"],
        "alltoall": [np.full(2, j * 10 + r, np.float32) for j in range(W)],
        "alltoall_single": np.array([r + 100 * j for j in range(W)],
                                    np.float32),
        "alltoall_uneven": np.concatenate(
            [np.full(r + 1, i * 10 + r, np.float32) for i in range(W)]),
        "send_recv": np.full(3, prv, np.float32),
        "batch_isend_irecv": np.full(3, prv + 0.5, np.float32),
        "group_all_reduce": xs[0] + xs[1] if r < 2 else xs[r],
        "group": (2, r if r < 2 else -1, r if r < 2 else -1, 2, r, W),
    }[name]


COLLECTIVES = ["all_reduce_sum", "all_reduce_max", "all_reduce_min",
               "all_reduce_prod", "all_reduce_avg", "all_gather",
               "all_gather_into_tensor", "all_gather_object",
               "reduce_scatter", "reduce_scatter_list", "broadcast",
               "broadcast_object_list", "reduce", "scatter",
               "scatter_object_list", "alltoall", "alltoall_single",
               "alltoall_uneven", "send_recv", "batch_isend_irecv",
               "group_all_reduce", "group"]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_numpy(world, name):
    for r in range(W):
        want = _expected(name, r)
        if want is None:
            continue
        got = world[r]["collectives"][name]
        if isinstance(want, (list, tuple)) and want and isinstance(
                want[0], np.ndarray):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-6)
        elif isinstance(want, np.ndarray):
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            assert tuple(got) == tuple(want) if isinstance(
                want, tuple) else got == want


def test_data_parallel_averages_gradients(world):
    w0 = world[0]["data_parallel"]["weight0"]
    for r in range(W):
        res = world[r]["data_parallel"]
        # rank 0's weights were broadcast
        np.testing.assert_array_equal(res["weight0"], w0)
        for got, want in zip(res["synced"], res["dense"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        # under no_sync the gradient stays this rank's own
        np.testing.assert_allclose(
            res["no_sync"], res["local_x"].T @ np.ones((1, 3), np.float32),
            rtol=1e-6)


def test_placements_shard_reshard_and_to_local(world):
    full = np.arange(24, dtype=np.float32).reshape(4, 6)
    for r in range(W):
        res = world[r]["placements"]
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(res["local"],
                                      full[2 * i:2 * i + 2, 3 * j:3 * j + 3])
        np.testing.assert_array_equal(res["reshard_local"],
                                      full[2 * j:2 * j + 2])
        np.testing.assert_array_equal(res["unshard"], full)
        np.testing.assert_array_equal(res["partial_to_replicate"],
                                      np.full((2, 2), 6.0))
        assert res["process_mesh"] == ([2, 2], [0, 1, 2, 3], 2, ("dp", "tp"))
        np.testing.assert_array_equal(
            res["loader_local"],
            np.arange(8, dtype=np.float32).reshape(4, 2)[2 * i:2 * i + 2])


def test_shard_layer_and_shard_optimizer_train_as_dense(world):
    import paddle_tpu_torch as pt

    res = world[0]["placements"]
    pt.seed(0)
    lin = pt.nn.Linear(4, 3, device="cpu")
    np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                  res["shard_layer_w0"])
    opt = pt.optimizer.AdamW(learning_rate=0.1,
                             parameters=list(lin.parameters()))
    lin(torch.ones(2, 4)).sum().backward()
    opt.step()
    for r in range(W):
        np.testing.assert_allclose(world[r]["placements"][
            "shard_layer_weight"], lin.weight.detach().numpy(), rtol=1e-6)


MESH_SHAPES = {"dp2_tp2": {"dp": 2, "tp": 2},
               "fsdp2_tp2": {"fsdp": 2, "tp": 2},
               "dp1_fsdp2_sep1_tp2": {"dp": 1, "fsdp": 2, "sep": 1, "tp": 2},
               "dp2_fsdp2": {"dp": 2, "fsdp": 2}, "fsdp4": {"fsdp": 4},
               "sep2_tp2": {"sep": 2, "tp": 2}, "ep2_tp2": {"ep": 2, "tp": 2}}


def _spec_cases():
    from paddle_tpu.distributed.auto_parallel.logical_sharding import \
        DEFAULT_RULES

    axes = [(ax,) for ax, _ in DEFAULT_RULES] + [
        ("batch", "seq", "embed"), ("embed", "heads"),
        ("batch", "seq_sp", "embed"), ("vocab_in", "embed"),
        ("embed", "vocab"), ("batch", "seq", "heads", "head_dim")]
    return [(k, a) for k in MESH_SHAPES for a in axes]


@pytest.mark.parametrize("mesh_key,axes", _spec_cases())
def test_logical_to_spec_matches_jax(world, mesh_key, axes):
    from paddle_tpu.distributed.auto_parallel import logical_to_spec, \
        make_mesh

    want = tuple(logical_to_spec(axes, make_mesh(MESH_SHAPES[mesh_key])))
    key = axes[0] if len(axes) == 1 else axes
    assert world[0]["placements"]["specs"][(mesh_key, key)] == want


LAYERS = ["column", "column_split", "row", "vocab_embedding", "column_sp",
          "row_sp"]


@pytest.mark.parametrize("name", LAYERS)
def test_parallel_layer_matches_dense(world, name):
    for r in range(W):
        (out, grads), (dout, dgrads) = world[r]["layers"][name]
        np.testing.assert_allclose(out, dout, rtol=1e-5, atol=1e-6)
        assert sorted(grads) == sorted(dgrads)
        for n in grads:
            np.testing.assert_allclose(grads[n], dgrads[n], rtol=1e-5,
                                       atol=1e-5)


def test_sequence_parallel_pair_matches_dense(world):
    for r in range(W):
        res = world[r]["layers"]
        assert res["sp_pair_placements"] == (
            "(Replicate(), Shard(dim=1))", "(Replicate(), Shard(dim=1))")
        np.testing.assert_allclose(res["sp_pair"], res["sp_pair_dense"],
                                   rtol=1e-5, atol=1e-5)


def test_parallel_cross_entropy_matches_dense(world):
    for r in range(W):
        res = world[r]["layers"]
        loss, grad, grad_pl = res["pce"]
        dloss, dgrad = res["pce_dense"]
        assert grad_pl == "(Replicate(), Shard(dim=2))"
        assert loss[0, 3] == 0.0
        np.testing.assert_allclose(loss, dloss, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(grad, dgrad, rtol=1e-5, atol=1e-6)


def test_mesh_refusals_name_their_part(world):
    msgs = world[0]["refusals"]
    # a batch of 6 rows does not divide over dp x fsdp = 4 (as in JAX)
    assert "does not divide over the 4 ranks" in msgs["uneven_batch"]
    # sep and pp train now (tests/test_torch_dist_sep.py,
    # tests/test_torch_pipeline.py); an MoE model over them still refuses
    for key, part in (("moe_sep", "ep mesh"), ("moe_pp", "ep mesh"),
                      ("ep", "ep mesh"), ("moe", "ep mesh")):
        assert "item 6" in msgs[key] and part in msgs[key], msgs[key]


def _refusals():
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import auto_parallel, \
        communication, fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel

    return [
        ("fleet.get_hybrid_communicate_group",
         lambda: fleet.get_hybrid_communicate_group, "fleet and ZeRO"),
        ("ShardingParallel", lambda: meta_parallel.ShardingParallel,
         "fleet and ZeRO"),
        ("ResilientTrainer_elastic",
         lambda: D.ResilientTrainer(None, "unused", elastic=object()),
         "the store, launch and elastic"),
        ("TensorParallel", lambda: meta_parallel.TensorParallel,
         "fleet and ZeRO"),
        ("launch", lambda: D.launch, "the store, launch and elastic"),
        ("fleet.init", lambda: fleet.init, "fleet and ZeRO"),
        ("fleet.DistributedStrategy", lambda: fleet.DistributedStrategy,
         "fleet and ZeRO"),
        ("sharding", lambda: D.sharding, "fleet and ZeRO"),
        ("fleet.elastic", lambda: fleet.elastic,
         "the store, launch and elastic"),
        ("TCPStore", lambda: D.TCPStore, "the store, launch and elastic"),
        ("CommTaskManager", lambda: D.CommTaskManager,
         "the store, launch and elastic"),
        ("get_comm_task_manager", lambda: D.get_comm_task_manager,
         "the store, launch and elastic"),
        ("communication.watchdog", lambda: communication.watchdog,
         "the store, launch and elastic"),
        ("ps", lambda: D.ps, "ps, rpc and auto_tuner"),
        ("rpc", lambda: D.rpc, "ps, rpc and auto_tuner"),
        ("utils", lambda: D.utils, "MoE over an ep mesh"),
        ("to_static", lambda: auto_parallel.to_static(None),
         "a compiled mesh step"),
        ("zb_selective_remat", lambda: auto_parallel.pipeline.zb_schedule(
            lambda ps, h: h, 2, 1, 1, remat=True, remat_policy=object()),
         "the zero-bubble schedule's selective remat regime"),
    ]


@pytest.mark.parametrize("case", _refusals(), ids=lambda c: c[0])
def test_item6_refusal_names_its_part(case):
    import paddle_tpu_torch as pt

    _, fn, part = case
    prev = pt.device._PLACE
    pt.set_device("cpu")
    try:
        with pytest.raises(NotImplementedError, match="item 6") as e:
            fn()
    finally:
        pt.device._PLACE = prev
    assert part in str(e.value)
