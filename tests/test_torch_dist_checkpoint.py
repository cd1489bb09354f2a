"""Sharded checkpoints of the port (``paddle_tpu_torch.distributed.
checkpoint``) against the JAX package's, CPU, fp32.

The JAX package saves a Llama's parameters sharded on ``{"dp": 2, "tp":
2}``; a world of 4 gloo ranks (``torch_dist_worker.py``, suite
"checkpoint") loads that checkpoint onto ``{"fsdp": 2, "tp": 2}`` and
saves the same weights on ``{"dp": 2, "tp": 2}`` and on ``{"fsdp": 4}``
(with replicas); the JAX package loads the latter onto ``{"tp": 4}``.
Values must come back equal (bit for bit), and the two packages'
``0.metadata`` for the same mesh equal field by field. The port's loader
refuses a corrupted shard, naming it, and recovers from its replica;
``async_save`` and the ``checkpoint.shard`` fault site behave as the JAX
package's.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from torch_dist_harness import launch


def _jax_model(mesh=None):
    import paddle_tpu as paddle
    from paddle_tpu.distributed.auto_parallel import axis_rules, \
        shard_params
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM

    paddle.seed(42)
    with axis_rules(mesh):
        m = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=4))
        if mesh is not None:
            shard_params(m, mesh)
    return m


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from paddle_tpu.distributed.auto_parallel import make_mesh
    from paddle_tpu.distributed.checkpoint import save_state_dict
    from paddle_tpu_torch.weights import state_from_jax_layer

    d = tmp_path_factory.mktemp("ckpt")
    weights = state_from_jax_layer(_jax_model())
    np.savez(d / "checkpoint_in.npz",
             **{f"w/{k}": v for k, v in weights.items()})
    jm = _jax_model(make_mesh({"dp": 2, "tp": 2}))
    save_state_dict(dict(jm.named_parameters()), str(d / "jax_ckpt"))
    port = launch("checkpoint", d, nprocs=4, timeout=120).wait()
    return d, weights, port


def test_jax_checkpoint_loads_onto_another_port_mesh(ckpt):
    _, weights, port = ckpt
    got = port[0]["from_jax"]
    assert sorted(got) == sorted(weights)
    for name, ref in weights.items():
        np.testing.assert_array_equal(got[name], ref)
    specs = port[0]["from_jax_specs"]
    assert specs["model.layers.0.self_attn.q_proj_weight"] == ("fsdp", "tp")
    assert specs["model.layers.0.mlp.down_proj_weight"] == ("tp", "fsdp")


def test_port_checkpoint_loads_onto_another_jax_mesh(ckpt):
    import jax.numpy as jnp

    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.distributed.auto_parallel import make_mesh
    from paddle_tpu.distributed.checkpoint import load_state_dict

    d, weights, _ = ckpt
    jm = _jax_model(make_mesh({"tp": 4}))
    target = dict(jm.named_parameters())
    for t in target.values():
        t._data = jnp.zeros_like(t._data)
    target["step"] = Tensor(jnp.zeros((), jnp.int32))
    load_state_dict(target, str(d / "port_fsdp4"))
    assert int(np.asarray(target["step"]._data)) == 7
    for name, ref in weights.items():
        np.testing.assert_array_equal(np.asarray(target[name]._data), ref)
    q = target["model.layers.0.self_attn.q_proj_weight"]._data
    assert tuple(q.sharding.spec)[:2] == (None, "tp")


def test_metadata_equal_field_by_field(ckpt):
    d, _, _ = ckpt
    jmeta = json.loads((d / "jax_ckpt" / "0.metadata").read_text())
    pmeta = json.loads((d / "port_dp2_tp2" / "0.metadata").read_text())
    assert set(jmeta) == set(pmeta) == {"tensors", "flat_mapping", "files"}
    assert jmeta["flat_mapping"] is None and pmeta["flat_mapping"] is None
    assert set(pmeta["tensors"]) == set(jmeta["tensors"]) | {"step"}
    for name, jt in jmeta["tensors"].items():
        pt_ = pmeta["tensors"][name]
        assert pt_["global_shape"] == jt["global_shape"]
        assert pt_["dtype"] == jt["dtype"]
        assert len(pt_["chunks"]) == len(jt["chunks"])

        def key(c):
            return (tuple(c["offsets"]), tuple(c["lengths"]), c["key"])

        assert sorted(map(key, pt_["chunks"])) == sorted(map(key,
                                                             jt["chunks"]))
        assert all(set(c) == {"offsets", "lengths", "file", "key"}
                   for c in pt_["chunks"])
    for meta in (jmeta, pmeta):
        files = {c["file"] for t in meta["tensors"].values()
                 for c in t["chunks"]}
        assert files == set(meta["files"])
        assert all(set(r) == {"size", "crc32", "sha256"}
                   for r in meta["files"].values())
    # each rank wrote the chunks it owns: on {dp: 2, tp: 2} the ranks at
    # dp 0 (0 and 1) own every chunk of the dp-replicated weights
    assert set(pmeta["files"]) == {"0_0.distcp", "1_0.distcp"}


def _whole_targets(weights):
    t = {n: torch.zeros(v.shape, dtype=torch.float32)
         for n, v in weights.items()}
    t["step"] = torch.zeros((), dtype=torch.int32)
    return t


def test_corrupted_shard_is_refused_and_its_replica_recovers(ckpt,
                                                             tmp_path):
    from paddle_tpu_torch.distributed.checkpoint import (
        CheckpointCorruptionError, load_state_dict)

    d, weights, _ = ckpt
    src = d / "port_fsdp4"
    bad = tmp_path / "bad"
    shutil.copytree(src, bad)
    blob = bytearray((bad / "2_0.distcp").read_bytes())
    blob[len(blob) // 2] ^= 0x10
    (bad / "2_0.distcp").write_bytes(bytes(blob))
    # the replica recovers the load, with equal values
    target = _whole_targets(weights)
    load_state_dict(target, str(bad))
    for name, ref in weights.items():
        np.testing.assert_array_equal(target[name].numpy(), ref)
    # without it the shard is refused, by name
    (bad / "2_0.distcp.replica").unlink()
    with pytest.raises(CheckpointCorruptionError) as e:
        load_state_dict(_whole_targets(weights), str(bad))
    assert e.value.code == "PT-CKPT-001" and "2_0.distcp" in str(e.value)
    # a corrupt replica fails too, and both copies are named
    shutil.copy(bad / "2_0.distcp", bad / "2_0.distcp.replica")
    with pytest.raises(CheckpointCorruptionError, match="replica"):
        load_state_dict(_whole_targets(weights), str(bad))


def test_async_save_and_the_shard_fault_site(tmp_path):
    from paddle_tpu_torch.distributed.checkpoint import (
        CheckpointCorruptionError, load_state_dict, save_state_dict,
        wait_async_save)
    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec

    w = torch.arange(512, dtype=torch.float32)
    save_state_dict({"w": w}, str(tmp_path / "a"), async_save=True)
    wait_async_save(str(tmp_path / "a"))
    got = {"w": torch.zeros(512)}
    load_state_dict(got, str(tmp_path / "a"))
    assert torch.equal(got["w"], w)
    for name, replica in (("b", True), ("c", False)):
        with FaultPlan(seed=9, specs=[FaultSpec("checkpoint.shard",
                                                "bitflip", arg=4)]):
            save_state_dict({"w": w}, str(tmp_path / name), replica=replica)
    got = {"w": torch.zeros(512)}
    load_state_dict(got, str(tmp_path / "b"))
    assert torch.equal(got["w"], w)
    with pytest.raises(CheckpointCorruptionError) as e:
        load_state_dict({"w": torch.zeros(512)}, str(tmp_path / "c"))
    assert e.value.code == "PT-CKPT-001"


def test_bf16_chunks_round_trip_with_the_jax_package(tmp_path):
    import jax.numpy as jnp

    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.distributed.checkpoint import load_state_dict as jload
    from paddle_tpu.distributed.checkpoint import save_state_dict as jsave
    from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                         save_state_dict)

    w = torch.linspace(-3, 3, 96, dtype=torch.bfloat16).reshape(8, 12)
    save_state_dict({"w": w}, str(tmp_path / "p"))
    t = {"w": Tensor(jnp.zeros((8, 12), jnp.bfloat16))}
    jload(t, str(tmp_path / "p"))
    np.testing.assert_array_equal(
        np.asarray(t["w"]._data).astype(np.float32), w.float().numpy())
    jsave({"w": t["w"]}, str(tmp_path / "j"))
    got = {"w": torch.zeros(8, 12, dtype=torch.bfloat16)}
    load_state_dict(got, str(tmp_path / "j"))
    assert torch.equal(got["w"], w)
