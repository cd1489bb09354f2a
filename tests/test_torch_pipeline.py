"""Pipeline parallelism of the port (``distributed.auto_parallel.
pipeline``, ``Engine`` over a ``pp`` dim, ``fleet.meta_parallel``'s
pipeline layers and RNG tracker) against the JAX package's, fp32 on the
CPU.

One world of 4 gloo ranks (this file is also the ranks' script, ``python
test_torch_pipeline.py pipeline DIR``) runs, while this process runs the
JAX side under ``jax.jit`` on meshes of the same shapes:
- ``pipeline_call`` with a toy block (``tanh(x @ w)``, 8 layers of 16,
  a batch of 8 in 4 microbatches) on ``{"pp": 4}`` under GPipe, VPP
  (``interleave=2``) and zb: the loss of ``mean(y**2)`` and its gradients
  for the stacked weights and the input (each rank's part, summed over
  the ranks), within rtol 1e-5 / atol 1e-6 of JAX's (rtol 1e-4 for the
  gradients, tests/test_pipeline.py's); JAX's schedule builders
  (``gpipe_schedule``, ``interleaved_schedule``, ``zb_schedule``) on each
  rank's rows the same;
- the tiny Llama's ``Engine`` on ``{pp: 2}``, ``{dp: 2, pp: 2}``,
  ``{sep: 2, pp: 2}`` and ``{pp: 4}`` with ``pp_interleave=2`` (8 layers),
  and zb on ``{pp: 2}`` with and without ``pp_remat``, three steps:
  losses relative 2e-4, parameters by tests/test_torch_dist_engine.py's
  bound, the moments within 1e-4 of each one's largest magnitude, and
  ``state_dict``'s names equal to JAX's (``blocks.<name>`` stacks in
  ``_pp_order``); a pp engine's state saves and loads through the sharded
  checkpoint unchanged.
In this process: ``SegmentLayers``, ``PipelineLayer`` with a
``SharedLayerDesc`` (its weight one tensor), ``PipelineParallel.
train_batch`` against the JAX classes on the same weights (losses and
updated weights within 1e-5), and the RNG tracker's contract.
"""

import os

import numpy as np
import pytest

LR, STEPS = 1e-3, 3
#: name -> (mesh, Engine keywords, layers)
ENGINE_CASES = {
    "pp2": ({"pp": 2}, {}, 2),
    "dp2_pp2": ({"dp": 2, "pp": 2}, {}, 2),
    "sep2_pp2": ({"sep": 2, "pp": 2}, {}, 2),
    "pp4_vpp2": ({"pp": 4}, {"pp_interleave": 2}, 8),
    "pp2_zb": ({"pp": 2}, {"pp_schedule": "zb"}, 2),
    "pp2_zb_remat": ({"pp": 2}, {"pp_schedule": "zb", "pp_remat": True}, 2),
}
#: pipeline_call schedules: name -> keywords
SCHEDULES = {"gpipe": {}, "vpp": {"interleave": 2}, "zb": {"schedule": "zb"}}
NL, DW = 8, 16


def _toy_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((NL, DW, DW)) * 0.5).astype(np.float32)
    x = rng.standard_normal((8, DW)).astype(np.float32)
    return ws, x


def _batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (4, 16)).astype(np.int64)
            for _ in range(STEPS)]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _pipeline_calls(rank):
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.auto_parallel import make_mesh
    from paddle_tpu_torch.distributed.auto_parallel.pipeline import \
        pipeline_call

    mesh = make_mesh({"pp": 4})
    out = {}
    for name, kw in SCHEDULES.items():
        ws0, x0 = _toy_inputs()
        ws = torch.tensor(ws0, requires_grad=True)
        x = torch.tensor(x0, requires_grad=True)
        y = pipeline_call(lambda p, h: torch.tanh(h @ p[0]), [ws], x,
                          mesh=mesh, n_micro=4, **kw)
        loss = (y ** 2).mean()
        loss.backward()
        # each rank holds its part: its rows' gradients, and (stage 0)
        # the input's
        g, gx = ws.grad.clone(), x.grad.clone()
        dist.all_reduce(g)
        dist.all_reduce(gx)
        out[name] = (float(loss), g.numpy().copy(), gx.numpy().copy())
    out.update(_schedule_builders(rank))
    return out


def _schedule_builders(rank):
    """The schedules as JAX's builders give them (``gpipe_schedule``,
    ``interleaved_schedule``, ``zb_schedule``) on this rank's rows of the
    same stacks: the loss and the gradients, summed over the ranks."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.auto_parallel import make_mesh
    from paddle_tpu_torch.distributed.auto_parallel import pipeline as P

    mesh = make_mesh({"pp": 4})
    p, out = 4, {}
    for name, v in (("gpipe_schedule", 1), ("interleaved_schedule", 2),
                    ("zb_schedule", 2)):
        ws0, x0 = _toy_inputs()
        ws = torch.tensor(ws0, requires_grad=True)
        x = torch.tensor(x0, requires_grad=True)
        lc = NL // (p * v)
        local = [ws[rank * lc * v:(rank + 1) * lc * v]]
        micro = x.reshape(4, 2, DW)
        if name == "gpipe_schedule":
            def stage(params, h):
                for w in params[0]:
                    h = torch.tanh(h @ w)
                return h
            run = P.gpipe_schedule(stage, p, mesh=mesh)
            y = run(local, micro)
        elif name == "interleaved_schedule":
            def stage(params, c, h):
                for i in range(lc):
                    h = torch.tanh(h @ params[0][c * lc + i])
                return h
            y = P.interleaved_schedule(stage, p, v, mesh=mesh)(local, micro)
        else:
            y = P.zb_schedule(lambda ps, h: torch.tanh(h @ ps[0]), p, v, lc,
                              mesh=mesh)(local, micro)
        loss = (y ** 2).mean()
        loss.backward()
        g, gx = ws.grad.clone(), x.grad.clone()
        dist.all_reduce(g)
        dist.all_reduce(gx)
        out[name] = (float(loss), g.numpy().copy(), gx.numpy().copy())
    return out


def _suite_pipeline(workdir, rank, world):
    import torch

    from paddle_tpu_torch.distributed.auto_parallel import Engine, make_mesh
    from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                         save_state_dict)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.weights import load_jax_state

    z = np.load(os.path.join(workdir, "pipeline_in.npz"))
    out = {"calls": _pipeline_calls(rank)}
    batches = _batches()
    meshes = {}
    for case, (axes, kw, layers) in ENGINE_CASES.items():
        key = tuple(axes.items())
        mesh = meshes.setdefault(key, make_mesh(axes))
        if mesh.get_coordinate() is None:
            continue
        m = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=layers),
                             device="cpu")
        pre = f"L{layers}/"
        load_jax_state(m, {k[len(pre):]: z[k] for k in z.files
                           if k.startswith(pre)})
        eng = Engine(m, mesh, lr=LR, **kw)
        res = {"losses": [float(eng.step(b, b)) for b in batches]}
        sd = eng.state_dict()
        res["names"] = {k: sorted(sd[k]) for k in ("model", "m", "v")}
        if rank == 0:
            res["state"] = {k: {n: t.detach().numpy().copy()
                                for n, t in sd[k].items()}
                            for k in ("model", "m", "v")}
        if case == "pp4_vpp2":
            # the sharded checkpoint round trip of a pp engine's state
            path = os.path.join(workdir, "pp_ckpt")
            flat = {f"{k}/{n}": t for k in ("model", "m", "v")
                    for n, t in sd[k].items()}
            save_state_dict(flat, path)
            back = {n: torch.zeros_like(t) for n, t in flat.items()}
            load_state_dict(back, path)
            res["ckpt_equal"] = all(torch.equal(back[n], flat[n])
                                    for n in flat)
        out[case] = res
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_mesh(axes):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(list(axes.values())))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(
        tuple(axes.values())), tuple(axes))


def _jax_calls():
    import jax
    import jax.numpy as jnp

    from paddle_tpu.distributed.auto_parallel.pipeline import pipeline_call

    mesh = _jax_mesh({"pp": 4})
    ws0, x0 = _toy_inputs()
    out = {}
    for name, kw in SCHEDULES.items():
        def f(ws, x, kw=kw):
            y = pipeline_call(lambda p, h: jnp.tanh(h @ p[0]), [ws], x,
                              mesh=mesh, n_micro=4, **kw)
            return jnp.mean(y ** 2)

        loss, (gw, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
            jnp.asarray(ws0), jnp.asarray(x0))
        out[name] = (float(loss), np.asarray(gw), np.asarray(gx))
    return out


def _jax_model(layers, mesh=None):
    import paddle_tpu as paddle
    from paddle_tpu.distributed.auto_parallel import axis_rules
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM

    paddle.seed(42)
    with axis_rules(mesh):
        return LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=layers))


def _jax_engine(case, mesh, model):
    from paddle_tpu.distributed.auto_parallel import Engine

    _, kw, _ = ENGINE_CASES[case]
    eng = Engine(model, mesh, lr=LR, **kw)
    losses = [float(eng.step(*eng.shard_batch(b.astype(np.int32),
                                              b.astype(np.int32))))
              for b in _batches()]
    sd = eng.state_dict()
    return {"losses": losses,
            "state": {k: {n: np.asarray(getattr(t, "_data", t))
                          for n, t in sd[k].items()}
                      for k in ("model", "m", "v")}}


def _jax_runs(weights):
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.weights import state_from_jax_layer

    models = {}
    for case, (axes, _, layers) in ENGINE_CASES.items():
        mesh = _jax_mesh(axes)
        model = _jax_model(layers, mesh)
        st = state_from_jax_layer(model)
        assert all(np.array_equal(st[k], weights[layers][k]) for k in st)
        models[case] = (mesh, model)
    with ThreadPoolExecutor(4) as pool:
        calls = pool.submit(_jax_calls)
        futs = {c: pool.submit(_jax_engine, c, *models[c])
                for c in ENGINE_CASES}
        out = {c: f.result() for c, f in futs.items()}
        out["calls"] = calls.result()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from torch_dist_harness import launch

    from paddle_tpu_torch.weights import state_from_jax_layer

    d = tmp_path_factory.mktemp("pipeline")
    weights = {n: state_from_jax_layer(_jax_model(n)) for n in (2, 8)}
    np.savez(d / "pipeline_in.npz",
             **{f"L{n}/{k}": v for n, w in weights.items()
                for k, v in w.items()})
    world = launch("pipeline", d, nprocs=4, timeout=240,
                   script=os.path.abspath(__file__))
    jax_out = _jax_runs(weights)
    return world.wait(), jax_out


def _ranks(case):
    axes = ENGINE_CASES[case][0]
    return range(int(np.prod(list(axes.values()))))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_pipeline_call_matches_jax(runs, name):
    port, jax_out = runs
    loss, gw, gx = jax_out["calls"][name]
    for r in range(4):
        got = port[r]["calls"][name]
        np.testing.assert_allclose(got[0], loss, rtol=1e-5)
        np.testing.assert_allclose(got[1], gw, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got[2], gx, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name,ref", [("gpipe_schedule", "gpipe"),
                                      ("interleaved_schedule", "vpp"),
                                      ("zb_schedule", "vpp")])
def test_schedule_builders_match_jax(runs, name, ref):
    """JAX's builders on each rank's rows (the zero-bubble one with two
    chunks a stage) give ``pipeline_call``'s JAX loss and gradients."""
    port, jax_out = runs
    loss, gw, gx = jax_out["calls"][ref]
    for r in range(4):
        got = port[r]["calls"][name]
        np.testing.assert_allclose(got[0], loss, rtol=1e-5)
        np.testing.assert_allclose(got[1], gw, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got[2], gx, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_pp_engine_losses_match_jax(runs, case):
    port, jax_out = runs
    for r in _ranks(case):
        np.testing.assert_allclose(port[r][case]["losses"],
                                   jax_out[case]["losses"], rtol=2e-4)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_pp_engine_state_matches_jax(runs, case):
    port, jax_out = runs
    got, ref = port[0][case]["state"], jax_out[case]["state"]
    for r in _ranks(case):
        assert port[r][case]["names"] == {k: sorted(v)
                                          for k, v in ref.items()}
    far = total = 0
    for name, want in ref["model"].items():
        err = np.abs(got["model"][name] - want)
        assert err.max() <= 2 * LR * STEPS, (name, err.max())
        far += int((err > 2e-5).sum())
        total += err.size
    assert far <= 1e-3 * total, (far, total)
    for key in ("m", "v"):
        for name, want in ref[key].items():
            err = np.abs(got[key][name] - want).max()
            assert err <= 1e-4 * np.abs(want).max(), (key, name, err)


def test_pp_state_round_trips_the_sharded_checkpoint(runs):
    port, _ = runs
    assert all(port[r]["pp4_vpp2"]["ckpt_equal"] for r in range(4))


# ---------------------------------------------------------------------------
# in this process: the pipeline layers and the RNG tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts,method", [(2, "uniform"), (3, "uniform"),
                                         (2, "layer:Linear")])
def test_segment_layers_equal_jax(parts, method):
    import paddle_tpu.distributed.fleet.meta_parallel.parallel_layers.\
        pp_layers as J

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed.fleet.meta_parallel.\
        parallel_layers.pp_layers as T

    def descs(M, nn):
        return ([M.LayerDesc(nn.Linear, 4, 4) for _ in range(4)]
                + [M.LayerDesc(nn.ReLU)] + [M.LayerDesc(nn.Linear, 4, 4)])

    import paddle_tpu as paddle
    got = T.SegmentLayers(descs(T, pt.nn), parts, method).do_segment()
    want = J.SegmentLayers(descs(J, paddle.nn), parts, method).do_segment()
    assert got == want


def _pp_layers(M, nn, weights):
    """Embed-like shared Linear, two Linears, the shared one again
    (through its forward_func): a PipelineLayer of 2 stages."""
    descs = [M.SharedLayerDesc("tied", nn.Linear, None, "weight", 6, 6),
             M.LayerDesc(nn.Linear, 6, 6), M.LayerDesc(nn.Linear, 6, 6),
             M.SharedLayerDesc("tied", nn.Linear,
                               lambda lay, x: x @ lay.weight, "weight", 6, 6)]
    pl = M.PipelineLayer(descs, num_stages=2,
                         loss_fn=lambda out, y: ((out - y) ** 2).mean())
    for (n, p), w in zip(pl.named_parameters(), weights):
        p.set_value(w) if hasattr(p, "set_value") else p.data.copy_(w)
    return pl


class _Hcg:
    def get_pipe_parallel_world_size(self):
        return 2


class _Strategy:
    pipeline_configs = {"accumulate_steps": 2, "micro_batch_size": 2}


def test_pipeline_layer_and_train_batch_equal_jax():
    import paddle_tpu as paddle
    import paddle_tpu.distributed.fleet.meta_parallel as J
    import torch

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed.fleet.meta_parallel as T

    rng = np.random.default_rng(3)
    weights = [rng.standard_normal(s).astype(np.float32) * 0.3
               for s in ((6, 6), (6,)) * 3]
    x = rng.standard_normal((4, 6)).astype(np.float32)
    y = rng.standard_normal((4, 6)).astype(np.float32)
    prev = pt.device._PLACE
    pt.set_device("cpu")
    try:
        tl = _pp_layers(T, pt.nn, [torch.tensor(w) for w in weights])
        assert tl.segment_parts == [0, 2, 4]
        assert len(list(tl.parameters())) == 6      # the shared one once
        assert tl.get_stage_layers(1)[1]._base is tl.run_function[0]
        tpp = T.PipelineParallel(tl, _Hcg(), _Strategy())
        topt = pt.optimizer.SGD(learning_rate=0.1,
                                parameters=list(tl.parameters()))
        tloss = [float(tpp.train_batch((torch.tensor(x), torch.tensor(y)),
                                       topt)) for _ in range(2)]
        teval = float(tpp.eval_batch((torch.tensor(x), torch.tensor(y))))
        tw = [p.detach().numpy().copy() for p in tl.parameters()]
    finally:
        pt.device._PLACE = prev
    jl = _pp_layers(J, paddle.nn, [paddle.to_tensor(w) for w in weights])
    assert jl.segment_parts == [0, 2, 4]
    jpp = J.PipelineParallel(jl, _Hcg(), _Strategy())
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=list(jl.parameters()))
    jloss = [float(jpp.train_batch((paddle.to_tensor(x),
                                    paddle.to_tensor(y)), jopt).numpy())
             for _ in range(2)]
    jeval = float(jpp.eval_batch((paddle.to_tensor(x),
                                  paddle.to_tensor(y))).numpy())
    jw = [np.asarray(p.numpy()) for p in jl.parameters()]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(teval, jeval, rtol=1e-5)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_rng_tracker_contract_as_jax():
    """The tracker's contract, which JAX's keeps too (its bits are
    threefry's): ``add`` refuses a name twice; a named state's draws are
    reproducible from its seed and leave the global stream where it was;
    ``model_parallel_random_seed`` resets the tracker to one state."""
    import paddle_tpu.distributed.fleet.meta_parallel as J
    import torch

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed.fleet.meta_parallel as T

    prev = pt.device._PLACE
    pt.set_device("cpu")
    try:
        for M in (T, J):
            tr = M.RNGStatesTracker()
            tr.add("a", 7)
            with pytest.raises(ValueError, match="already exists"):
                tr.add("a", 8)
        pt.seed(11)
        base = pt.rand([4]).numpy()
        tr = T.RNGStatesTracker()
        tr.add("mp", 5)
        pt.seed(11)
        with tr.rng_state("mp"):
            a = pt.rand([4]).numpy()
        after = pt.rand([4]).numpy()
        np.testing.assert_array_equal(after, base)   # global untouched
        tr2 = T.RNGStatesTracker()
        tr2.add("mp", 5)
        with tr2.rng_state("mp"):
            np.testing.assert_array_equal(pt.rand([4]).numpy(), a)
        with tr.rng_state("mp"):
            b = pt.rand([4]).numpy()
        assert not np.array_equal(a, b)          # the state advanced
        for M in (T, J):
            M.model_parallel_random_seed(3)
            st = M.get_rng_state_tracker().states_
            assert list(st) == ["model_parallel_rng"]
        assert isinstance(T.get_rng_state_tracker(), T.RNGStatesTracker)
        del torch
    finally:
        pt.device._PLACE = prev


if __name__ == "__main__":
    from torch_dist_harness import rank_main

    rank_main({"pipeline": _suite_pipeline})
