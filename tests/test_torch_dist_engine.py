"""``Engine(model, mesh)`` of the port over 4 gloo ranks on the CPU,
against the JAX package's ``Engine`` on a mesh of the same shape (8
virtual CPU devices, tests/conftest.py), fp32.

One world (``torch_dist_worker.py``, suite "engine") trains the port's
Llama from the JAX model's weights (``load_jax_state``) on the same three
seeded batches over ``{"dp": 4}``, ``{"dp": 2, "tp": 2}``, ``{"fsdp": 2,
"tp": 2}``, ``{"fsdp": 4}``, ``{"dp": 2, "tp": 2}`` with
``sequence_parallel=True`` and ``{"tp": 4}`` with 2 kv heads (which tp
does not divide: attention runs on q, k, v gathered whole), with the
built-in AdamW and with ``optimizer=AdamW(...)``, while this process runs
the JAX engines.

Tolerances:
- losses: relative 2e-4, the JAX package's own for dp=N against one
  device (tests/test_engine.py:46-50);
- parameters after three steps, gathered: within 2 * lr * steps of the
  JAX engine's, at most 0.1% of the elements more than 2e-5 apart (the
  bound and its reason in tests/test_torch_training.py: Adam normalises
  each update); the moments within 1e-4 of each one's largest magnitude;
- placements: each parameter's, and each moment's, spec equal to the JAX
  parameter's ``PartitionSpec`` on that mesh (JAX's rules);
- the port's dp=4 against its own ``mesh=None``: losses relative 2e-4; a
  one-rank mesh against ``mesh=None``: losses and parameters relative
  1e-6.
"""

import numpy as np
import pytest

from torch_dist_harness import launch

CASES = {
    "dp4": ({"dp": 4}, False, False),
    "dp2_tp2": ({"dp": 2, "tp": 2}, False, False),
    "fsdp2_tp2": ({"fsdp": 2, "tp": 2}, False, False),
    "fsdp4": ({"fsdp": 4}, False, False),
    "dp2_tp2_sp": ({"dp": 2, "tp": 2}, True, False),
    "dp2_tp2_adamw": ({"dp": 2, "tp": 2}, False, True),
    # GQA, 2 kv heads over tp=4: attention on q, k, v gathered whole
    "tp4_gqa": ({"tp": 4}, False, False),
}
KV_HEADS = {"tp4_gqa": 2}
LR, STEPS = 1e-3, 3


def _batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (4, 16)).astype(np.int32)
            for _ in range(STEPS + 1)]


def _jax_model(sp=False, mesh=None, kv_heads=4):
    import paddle_tpu as paddle
    from paddle_tpu.distributed.auto_parallel import axis_rules
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM

    paddle.seed(42)
    with axis_rules(mesh):
        return LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=kv_heads,
                                                 sequence_parallel=sp))


def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _jax_runs(batches, weights):
    """Every case's JAX engine; the models are built here, one after
    another (the seed is global), and the engines compile and step in
    threads (XLA compiles outside the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu.distributed.auto_parallel import make_mesh
    from paddle_tpu_torch.weights import state_from_jax_layer

    models = {}
    for name, (axes, sp, adamw) in CASES.items():
        mesh = make_mesh(axes)
        kvh = KV_HEADS.get(name, 4)
        model = _jax_model(sp, mesh, kvh)
        st = state_from_jax_layer(model)
        assert all(np.array_equal(st[k], weights[kvh][k]) for k in st)
        models[name] = (mesh, model, adamw)
    with ThreadPoolExecutor(4) as pool:
        futs = {n: pool.submit(_jax_case, n, *models[n], batches)
                for n in CASES}
        return {n: f.result() for n, f in futs.items()}


def _jax_case(name, mesh, model, adamw, batches):
    from paddle_tpu.distributed.auto_parallel import Engine
    from paddle_tpu.optimizer import AdamW

    eng = Engine(model, mesh, lr=LR,
                 optimizer=AdamW(learning_rate=LR) if adamw else None)
    ids = [eng.shard_batch(b, b) for b in batches]
    res = {"losses": [float(eng.step(*ids[i])) for i in range(STEPS)],
           "specs": {n: _strip(p.sharding.spec) for n, p in zip(
               eng._param_names, eng.params)},
           "model": {n: np.asarray(p) for n, p in zip(
               eng._param_names, eng.params)}}
    if not adamw:
        res["m"] = {n: np.asarray(a) for n, a in zip(eng._param_names,
                                                     eng.m)}
        res["v"] = {n: np.asarray(a) for n, a in zip(eng._param_names,
                                                     eng.v)}
    if name in ("dp2_tp2", "dp2_tp2_adamw"):
        res["loss4"] = float(eng.step(*ids[STEPS]))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from paddle_tpu_torch.weights import state_from_jax_layer

    d = tmp_path_factory.mktemp("engine")
    batches = _batches()
    weights = {kvh: state_from_jax_layer(_jax_model(kv_heads=kvh))
               for kvh in (4, 2)}
    np.savez(d / "engine_in.npz",
             **{f"w/{k}": v for k, v in weights[4].items()},
             **{f"w2/{k}": v for k, v in weights[2].items()},
             **{f"ids{i}": b for i, b in enumerate(batches)})
    world = launch("engine", d, nprocs=4, timeout=240)
    jax_out = _jax_runs(batches, weights)
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
def test_losses_match_jax_on_the_same_mesh(runs, case):
    port, jax_out = runs
    for r in range(4):
        np.testing.assert_allclose(port[r][case]["losses"],
                                   jax_out[case]["losses"], rtol=2e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_updated_parameters_match_jax(runs, case):
    port, jax_out = runs
    got = port[0][case]["state"]
    assert port[0][case]["step"] == STEPS
    _params_close(got["model"], jax_out[case]["model"])
    if "m" in jax_out[case]:
        for key in ("m", "v"):
            for name, ref in jax_out[case][key].items():
                err = np.abs(got[key][name] - ref).max()
                assert err <= 1e-4 * np.abs(ref).max(), (key, name, err)
    else:
        assert sorted(got["opt"]) == port[0][case]["acc_names"]


@pytest.mark.parametrize("case", list(CASES))
def test_parameters_and_moments_placed_by_jax_rules(runs, case):
    port, jax_out = runs
    for r in range(4):
        res = port[r][case]
        specs = {n: _strip(s) for n, s in res["specs"].items()}
        assert specs == jax_out[case]["specs"]
        if "moment_specs" in res:
            for n, (sm, sv) in res["moment_specs"].items():
                assert sm == sv == res["specs"][n]
        else:
            assert res["acc_local_like_param"]
    if case.startswith("fsdp"):
        q = jax_out[case]["specs"]["model.layers.0.self_attn.q_proj_weight"]
        assert q[0] == "fsdp"


def test_collectives_per_step_by_mesh(runs):
    """One step's collectives (CommDebugMode), by kind: dp only
    all-reduces (one a gradient, the loss's two halves); fsdp gathers each
    weight before its product and reduce-scatters its gradient (ZeRO-3),
    one for one; tp adds the activations' all-reduces and gathers. The
    same on every rank."""
    port, _ = runs
    got = {case: port[0][case]["comms"] for case in CASES}
    for case in CASES:
        assert all(port[r][case]["comms"] == got[case] for r in range(4))
    assert set(got["dp4"]) == {"all_reduce"}
    # 2 layers x 9 parameters + embedding, final norm, lm head + 2 halves
    assert got["dp4"]["all_reduce"] == 2 * 9 + 5
    for case in ("fsdp4", "fsdp2_tp2"):
        assert got[case]["all_gather_into_tensor"] == \
            got[case]["reduce_scatter_tensor"] > 0, got[case]
    for case in ("dp2_tp2", "dp2_tp2_sp", "fsdp2_tp2", "tp4_gqa"):
        assert set(got[case]) == {"all_reduce", "all_gather_into_tensor",
                                  "reduce_scatter_tensor"}, got[case]


def test_dp4_matches_the_ports_own_single_device_run(runs):
    port, _ = runs
    np.testing.assert_allclose(port[0]["dp4"]["losses"],
                               port[0]["none"]["losses"], rtol=2e-4)


def test_one_rank_mesh_equals_mesh_none(runs):
    port, _ = runs
    one, none = port[0]["one_rank"], port[0]["none"]
    np.testing.assert_allclose(one["losses"], none["losses"], rtol=1e-6)
    for key in ("model", "m", "v"):
        for name, ref in none["state"][key].items():
            np.testing.assert_allclose(one["state"][key][name], ref,
                                       rtol=1e-6, atol=1e-6 * max(
                                           1.0, np.abs(ref).max()))


@pytest.mark.parametrize("src", ["dp2_tp2", "dp2_tp2_adamw"])
def test_state_resumes_on_another_mesh(runs, src):
    """A snapshot of three steps on {dp: 2, tp: 2} resumes on {fsdp: 4}
    (AdamW's on {dp: 4}) and takes the JAX engine's fourth step."""
    port, jax_out = runs
    for r in range(4):
        res = port[r][f"resume_{src}"]
        assert res["step"] == STEPS + 1
        np.testing.assert_allclose(res["loss"], jax_out[src]["loss4"],
                                   rtol=2e-4)
