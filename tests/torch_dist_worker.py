"""One rank of a gloo world for the port's distributed tests (started by
``torch_dist_harness.launch``): ``python torch_dist_worker.py SUITE DIR``.

Each suite runs every case of one test file in this one world, on the
CPU, and pickles this rank's results to ``DIR/SUITE.<rank>.pkl`` for the
test process, which holds them against numpy and the JAX package. A
case's inputs (the JAX model's weights, the batches) come from
``DIR/<suite>_in.npz``. This process imports the port only.
"""

import logging
import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

import paddle_tpu_torch as pt
from paddle_tpu_torch import distributed as pdist
from paddle_tpu_torch.distributed.auto_parallel import (
    Engine, Partial, Replicate, Shard, axis_rules, logical_to_spec,
    make_mesh)
from paddle_tpu_torch.distributed.auto_parallel.placement import (
    from_dtensor_placements, placements_to_spec)

torch.set_num_threads(1)
# DTensor's note on two sequential all-reduces is expected on 2-d meshes
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)


def _np(t):
    """A numpy copy (never a view of the tensor's memory)."""
    t = t.detach().cpu()
    return np.array((t.float() if t.is_floating_point() else t).numpy())


def _tree(x):
    """Tensors in nested dicts as numpy copies."""
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return _np(x)


def _spec(p):
    """A DTensor's placements as a per-dim spec tuple."""
    return tuple(placements_to_spec(from_dtensor_placements(p.placements),
                                    p.device_mesh.mesh_dim_names, p.ndim))


# ---------------------------------------------------------------------------
# collectives, placements, the parallel layers (test_torch_distributed.py)
# ---------------------------------------------------------------------------

def _collectives(rank, world):
    F = pdist
    out = {}
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + rank + 1
    for op in ("sum", "max", "min", "prod", "avg"):
        t = x.clone()
        F.all_reduce(t, op=op)
        out[f"all_reduce_{op}"] = _np(t)
    parts = []
    F.all_gather(parts, x)
    out["all_gather"] = [_np(p) for p in parts]
    out["all_gather_into_tensor"] = _np(F.all_gather_into_tensor(None, x))
    objs = []
    F.all_gather_object(objs, {"rank": rank})
    out["all_gather_object"] = objs
    big = torch.arange(world * 2 * 3, dtype=torch.float32).reshape(
        world * 2, 3) * (rank + 1)
    t = torch.empty(2, 3)
    F.reduce_scatter(t, big)
    out["reduce_scatter"] = _np(t)
    t = torch.empty(2, 3)
    F.reduce_scatter(t, list(big.chunk(world)))
    out["reduce_scatter_list"] = _np(t)
    t = x.clone()
    F.broadcast(t, src=1)
    out["broadcast"] = _np(t)
    objs = [f"from {rank}", rank]
    F.broadcast_object_list(objs, src=2)
    out["broadcast_object_list"] = objs
    t = x.clone()
    F.reduce(t, dst=0)
    out["reduce"] = _np(t)
    t = torch.empty(2, 3)
    F.scatter(t, [x * (i + 10) for i in range(world)] if rank == 3 else None,
              src=3)
    out["scatter"] = _np(t)
    objs = []
    F.scatter_object_list(objs, [f"obj{i}" for i in range(world)]
                          if rank == 0 else None, src=0)
    out["scatter_object_list"] = objs
    got = []
    F.alltoall(got, [torch.full((2,), float(rank * 10 + j))
                     for j in range(world)])
    out["alltoall"] = [_np(g) for g in got]
    out["alltoall_single"] = _np(F.alltoall_single(
        None, torch.arange(world, dtype=torch.float32) + 100 * rank))
    # uneven: rank r sends j + 1 rows to rank j
    ins = [j + 1 for j in range(world)]
    src = torch.cat([torch.full((n,), float(rank * 10 + j))
                     for j, n in enumerate(ins)])
    out["alltoall_uneven"] = _np(F.alltoall_single(
        None, src, in_split_sizes=ins, out_split_sizes=[rank + 1] * world))
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    got = torch.empty(3)
    if rank % 2 == 0:
        F.send(torch.full((3,), float(rank)), dst=nxt)
        F.recv(got, src=prv)
    else:
        F.recv(got, src=prv)
        F.send(torch.full((3,), float(rank)), dst=nxt)
    out["send_recv"] = _np(got)
    got = torch.empty(3)
    reqs = F.batch_isend_irecv([
        F.P2POp(F.isend, torch.full((3,), float(rank) + 0.5), nxt),
        F.P2POp(F.irecv, got, prv)])
    for r in reqs:
        r.wait()
    out["batch_isend_irecv"] = _np(got)
    F.barrier()
    g = F.new_group([0, 1])
    t = x.clone()
    if rank in (0, 1):
        F.all_reduce(t, group=g)
    out["group_all_reduce"] = _np(t)
    out["group"] = (g.nranks, g.rank, pdist.get_rank(g), pdist.get_world_size(
        g), pdist.get_rank(), pdist.get_world_size())
    return out


def _data_parallel(rank, world):
    pt.seed(rank)      # ranks start apart: rank 0's are broadcast
    lin = pt.nn.Linear(5, 3)
    dp = pdist.DataParallel(lin)
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.standard_normal((world * 2, 5)).astype(
        np.float32))
    w0 = lin.weight.detach().clone()
    b0 = lin.bias.detach().clone()
    dp(xs[rank * 2:(rank + 1) * 2]).square().mean().backward()
    synced = (_np(lin.weight.grad), _np(lin.bias.grad))
    ref = torch.nn.Linear(5, 3)
    with torch.no_grad():
        ref.weight.copy_(w0.T)
        ref.bias.copy_(b0)
    ref(xs).square().mean().backward()
    lin.weight.grad = None
    with dp.no_sync():
        dp(xs[rank:rank + 1]).sum().backward()
    return {"weight0": _np(w0), "synced": synced,
            "dense": (_np(ref.weight.grad.T), _np(ref.bias.grad)),
            "no_sync": _np(lin.weight.grad),
            "local_x": _np(xs[rank:rank + 1])}


def _placements(rank, world):
    out = {}
    mesh = make_mesh({"dp": 2, "tp": 2})
    full = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    d = pdist.shard_tensor(full, mesh, [Shard(0), Shard(1)])
    out["local"] = _np(pdist.dtensor_to_local(d))
    r = pdist.reshard(d, mesh, [Replicate(), Shard(0)])
    out["reshard_local"] = _np(r.to_local())
    out["unshard"] = _np(pdist.unshard_dtensor(r))
    p = pdist.dtensor_from_local(torch.full((2, 2), float(rank)), mesh,
                                 [Partial(), Partial()])
    out["partial_to_replicate"] = _np(pdist.reshard(
        p, mesh, [Replicate(), Replicate()]).to_local())
    pm = pdist.ProcessMesh([[0, 1], [2, 3]], ["dp", "tp"])
    out["process_mesh"] = (pm.shape, pm.process_ids, pm.get_dim_size("tp"),
                           tuple(pm.to_torch().mesh_dim_names))
    specs = {}
    shapes = {"dp2_tp2": {"dp": 2, "tp": 2},
              "fsdp2_tp2": {"fsdp": 2, "tp": 2},
              "dp1_fsdp2_sep1_tp2": {"dp": 1, "fsdp": 2, "sep": 1, "tp": 2},
              "dp2_fsdp2": {"dp": 2, "fsdp": 2}, "fsdp4": {"fsdp": 4},
              "sep2_tp2": {"sep": 2, "tp": 2}, "ep2_tp2": {"ep": 2, "tp": 2}}
    from paddle_tpu_torch.distributed.auto_parallel import DEFAULT_RULES
    for key, shape in shapes.items():
        m = make_mesh(shape)
        for ax, _ in DEFAULT_RULES:
            specs[(key, ax)] = tuple(logical_to_spec((ax,), m))
        for axes in (("batch", "seq", "embed"), ("embed", "heads"),
                     ("batch", "seq_sp", "embed"), ("vocab_in", "embed"),
                     ("embed", "vocab"), ("batch", "seq", "heads",
                                          "head_dim")):
            specs[(key, axes)] = tuple(logical_to_spec(axes, m))
    out["specs"] = specs
    # shard_layer + shard_optimizer: a replicated layer trains as dense
    pt.seed(0)
    lin = pt.nn.Linear(4, 3)
    w0 = lin.weight.detach().clone()
    pdist.shard_layer(lin, mesh)
    opt = pdist.shard_optimizer(pt.optimizer.AdamW(
        learning_rate=0.1, parameters=list(lin.parameters())))
    xin = pdist.shard_tensor(torch.ones(2, 4), mesh,
                             [Replicate(), Replicate()])
    lin(xin).sum().backward()
    opt.step()
    out["shard_layer_weight"] = _np(lin.weight.full_tensor())
    out["shard_layer_w0"] = _np(w0)
    loader = pdist.shard_dataloader([torch.arange(8.).reshape(4, 2)], mesh,
                                    shard_dims="dp")
    out["loader_local"] = _np(next(iter(loader)).to_local())
    return out


def _layers(rank, world):
    """The tensor- and sequence-parallel layers on a {dp: 2, tp: 2} mesh
    against the same layers dense; forward and the gradients of
    sum(out * cot)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    from paddle_tpu_torch.distributed.fleet.utils import \
        sequence_parallel_utils as spu

    mesh = make_mesh({"dp": 2, "tp": 2})
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, 6)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 16, (2, 8)))
    cot = torch.from_numpy(rng.standard_normal((2, 8, 8)).astype(np.float32))
    out = {}

    def run(make, inp, mesh_on):
        pt.seed(5)
        if mesh_on:
            with axis_rules(mesh):
                layer = make()
                o = layer(inp)
        else:
            layer = make()
            o = layer(inp)
        full = o.full_tensor() if hasattr(o, "full_tensor") else o
        c = cot[..., :full.shape[-1]]
        (o * (pdist.shard_tensor(c, mesh, [Replicate(), Replicate()])
              if mesh_on else c)).sum().backward()
        grads = {n: _np(p.grad.full_tensor() if hasattr(p.grad, "full_tensor")
                        else p.grad) for n, p in layer.named_parameters()}
        return _np(full), grads

    makes = {
        "column": (lambda: ColumnParallelLinear(6, 8), x),
        "column_split": (lambda: ColumnParallelLinear(6, 8,
                                                      gather_output=False), x),
        "row": (lambda: RowParallelLinear(6, 6), x),
        "vocab_embedding": (lambda: VocabParallelEmbedding(16, 6), ids),
        "column_sp": (lambda: spu.ColumnSequenceParallelLinear(
            6, 8, gather_output=True), x),
        "row_sp": (lambda: spu.RowSequenceParallelLinear(6, 6), x),
    }
    for name, (make, inp) in makes.items():
        out[name] = (run(make, inp, True), run(make, inp, False))
    # the two SP linears in their Megatron order: seq-sharded in and out
    pt.seed(5)
    with axis_rules(mesh):
        col = spu.ColumnSequenceParallelLinear(6, 8)
        row = spu.RowSequenceParallelLinear(8, 6)
        xs = spu.ScatterOp.apply(x)
        y = row(col(xs))
        out["sp_pair_placements"] = (str(xs.placements), str(y.placements))
        out["sp_pair"] = _np(spu.GatherOp.apply(y).full_tensor())
    out["sp_pair_dense"] = _np((x @ col.weight.full_tensor()
                                + col.bias.full_tensor())
                               @ row.weight.full_tensor()
                               + row.bias.full_tensor())
    # vocab-parallel CE: logits sharded over tp, against the dense CE
    logits = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 16, (2, 8)))
    labels[0, 3] = -100
    with axis_rules(mesh):
        lg = pdist.shard_tensor(logits, mesh, [Replicate(), Shard(2)])
        lg.requires_grad_(True)
        loss = ParallelCrossEntropy()(lg, labels)
        (loss * pdist.shard_tensor(torch.arange(16.).reshape(2, 8), mesh,
                                   [Replicate(), Replicate()])
         ).sum().backward()
        out["pce"] = (_np(loss.full_tensor()), _np(lg.grad.full_tensor()),
                      str(lg.grad.placements))
    ld = logits.clone().requires_grad_(True)
    dense = ParallelCrossEntropy()(ld, labels)
    (dense * torch.arange(16.).reshape(2, 8)).sum().backward()
    out["pce_dense"] = (_np(dense), _np(ld.grad))
    return out


def _refusals(rank, world):
    """The mesh refusals of the Engine, each message."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    msgs = {}
    eng = Engine(LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                                  device="cpu"), make_mesh({"dp": 2,
                                                            "fsdp": 2}))
    try:
        eng.shard_batch(np.zeros((6, 8), np.int64))
        msgs["uneven_batch"] = "accepted"
    except ValueError as e:
        msgs["uneven_batch"] = str(e)
    cases = {"moe_sep": ({"sep": 2, "tp": 2}, 4),
             "moe_pp": ({"pp": 2, "dp": 2}, 4),
             "ep": ({"ep": 2, "dp": 2}, 1), "moe": ({"dp": 4}, 4)}
    for key, (axes, experts) in cases.items():
        mesh = make_mesh(axes)
        cfg = LlamaConfig.tiny(num_hidden_layers=1, num_experts=experts)
        try:
            Engine(LlamaForCausalLM(cfg, device="cpu"), mesh)
            msgs[key] = "accepted"
        except NotImplementedError as e:
            msgs[key] = str(e)
    return msgs


def suite_distributed(workdir, rank, world):
    out = {"refusals": _refusals(rank, world)}
    for name, fn in (("collectives", _collectives),
                     ("data_parallel", _data_parallel),
                     ("placements", _placements), ("layers", _layers)):
        out[name] = fn(rank, world)
    return out


# ---------------------------------------------------------------------------
# the Engine over meshes (test_torch_dist_engine.py)
# ---------------------------------------------------------------------------

ENGINE_CASES = {
    "dp4": ({"dp": 4}, False, False),
    "dp2_tp2": ({"dp": 2, "tp": 2}, False, False),
    "fsdp2_tp2": ({"fsdp": 2, "tp": 2}, False, False),
    "fsdp4": ({"fsdp": 4}, False, False),
    "dp2_tp2_sp": ({"dp": 2, "tp": 2}, True, False),
    "dp2_tp2_adamw": ({"dp": 2, "tp": 2}, False, True),
    # GQA: 2 kv heads over tp=4 do not divide, so attention runs on q, k, v
    # gathered whole (the JAX package drops to _xla_attention there)
    "tp4_gqa": ({"tp": 4}, False, False),
}
#: kv heads by case (the rest are MHA, 4 heads, which tp=2 divides)
KV_HEADS = {"tp4_gqa": 2}


def _model(inp, sp=False, kv_heads=4, prefix="w/"):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.weights import load_jax_state

    cfg = LlamaConfig.tiny(num_key_value_heads=kv_heads, sequence_parallel=sp)
    m = LlamaForCausalLM(cfg, device="cpu")
    n = len(prefix)
    load_jax_state(m, {k[n:]: inp[k] for k in inp.files
                       if k[:n] == prefix})
    return m


def _engine(inp, mesh, sp=False, adamw=False, kv_heads=4):
    opt = (pt.optimizer.AdamW(learning_rate=1e-3) if adamw else None)
    prefix = "w/" if kv_heads == 4 else f"w{kv_heads}/"
    return Engine(_model(inp, sp, kv_heads, prefix), mesh, lr=1e-3,
                  optimizer=opt)


def _engine_case(inp, name, axes, sp, adamw, rank):
    batches = [inp[f"ids{i}"] for i in range(3)]
    eng = _engine(inp, make_mesh(axes), sp, adamw, KV_HEADS.get(name, 4))
    losses = [float(eng.step(b, b)) for b in batches]
    res = {"losses": losses,
           "specs": {n: _spec(p) for n, p in zip(eng._param_names,
                                                 eng.params)}}
    if adamw:
        # the proxies' shapes are the local shards'
        res["acc_local_like_param"] = all(
            tuple(a.shape) == tuple(k.shape)
            for d in eng.opt_state.values() for k, a in d.items()
            if a.ndim == len(k.shape))
        res["acc_names"] = sorted(eng.opt_state)
    else:
        res["moment_specs"] = {n: (_spec(m), _spec(v)) for n, m, v in zip(
            eng._param_names, eng.m, eng.v)}
    sd = eng.state_dict()
    if rank == 0:
        res["state"] = {k: _tree(v) for k, v in sd.items() if k != "step"}
        res["step"] = int(sd["step"])
    # the collectives of one more step, by kind
    from torch.distributed.tensor.debug import CommDebugMode

    with CommDebugMode() as comm:
        eng.step(batches[0], batches[0])
    res["comms"] = {str(k).split(".")[-1]: v
                    for k, v in comm.get_comm_counts().items()}
    return eng, sd, res


def suite_engine(workdir, rank, world):
    inp = np.load(os.path.join(workdir, "engine_in.npz"))
    out = {}
    kept = {}
    for name, (axes, sp, adamw) in ENGINE_CASES.items():
        eng, sd, out[name] = _engine_case(inp, name, axes, sp, adamw, rank)
        kept[name] = sd
    # the port's own mesh=None on every rank (no collectives), and a
    # one-rank mesh on rank 0 (the other ranks are off that mesh; 2-d:
    # chip_smoke.py phase 56 (a) runs the 3-d one on the card, whose
    # sharding propagation costs seconds more on the host)
    batches = [inp[f"ids{i}"] for i in range(3)]
    ref = _engine(inp, None)
    out["none"] = {"losses": [float(ref.step(b, b)) for b in batches]}
    sd = ref.state_dict()
    out["none"]["state"] = {k: {n: _np(t) for n, t in sd[k].items()}
                            for k in ("model", "m", "v")}
    one = make_mesh({"dp": 1, "tp": 1})
    if rank == 0:
        eng = _engine(inp, one)
        out["one_rank"] = {"losses": [float(eng.step(b, b))
                                      for b in batches]}
        sd = eng.state_dict()
        out["one_rank"]["state"] = {k: {n: _np(t) for n, t in sd[k].items()}
                                    for k in ("model", "m", "v")}
    # a snapshot of the dp2_tp2 run resumes on fsdp4 (and AdamW's on dp4)
    for src, axes, adamw in (("dp2_tp2", {"fsdp": 4}, False),
                             ("dp2_tp2_adamw", {"dp": 4}, True)):
        eng = _engine(inp, make_mesh(axes), adamw=adamw)
        eng.set_state_dict(kept[src])
        b = inp["ids3"]
        out[f"resume_{src}"] = {"loss": float(eng.step(b, b)),
                                "step": int(eng.step_count)}
    return out


# ---------------------------------------------------------------------------
# sharded checkpoints (test_torch_dist_checkpoint.py)
# ---------------------------------------------------------------------------

def suite_checkpoint(workdir, rank, world):
    from paddle_tpu_torch.distributed.auto_parallel import shard_params
    from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                         save_state_dict)

    inp = np.load(os.path.join(workdir, "checkpoint_in.npz"))
    out = {}
    # the JAX package's checkpoint (saved on {dp: 2, tp: 2}) onto
    # {fsdp: 2, tp: 2}: the model's parameters, sharded, filled in place
    model = _model(inp)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    mesh = make_mesh({"fsdp": 2, "tp": 2})
    with axis_rules(mesh):
        shard_params(model, mesh)
    sd = dict(model.named_parameters())
    load_state_dict(sd, os.path.join(workdir, "jax_ckpt"))
    full = {n: _np(p.full_tensor()) for n, p in sd.items()}
    out["from_jax"] = full if rank == 0 else None
    out["from_jax_specs"] = {n: _spec(p) for n, p in sd.items()}
    # the port's own checkpoint of the same weights on {dp: 2, tp: 2} (the
    # JAX save's mesh, for the metadata comparison) and on {fsdp: 4}
    for key, axes in (("port_dp2_tp2", {"dp": 2, "tp": 2}),
                      ("port_fsdp4", {"fsdp": 4})):
        model = _model(inp)
        mesh = make_mesh(axes)
        with axis_rules(mesh):
            shard_params(model, mesh)
        state = {n: p for n, p in model.named_parameters()}
        state["step"] = torch.tensor(7, dtype=torch.int32)
        save_state_dict(state, os.path.join(workdir, key),
                        replica=(key == "port_fsdp4"))
    return out


# ---------------------------------------------------------------------------
# on the card, two ranks sharing it over gloo (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

def suite_cuda_gloo(workdir, rank, world):
    """Which collectives gloo runs on CUDA tensors: each one's result, or
    the error it raised (the same on every rank, so no rank waits)."""
    dev = torch.device("cuda")
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    out = {}

    def attempt(name, fn):
        try:
            out[name] = ("ok", _np(fn()))
        except Exception as e:  # recorded; the test decides
            out[name] = ("error", f"{type(e).__name__}: {e}")

    def all_reduce():
        t = x.clone()
        dist.all_reduce(t)
        return t

    def broadcast():
        t = x.clone()
        dist.broadcast(t, src=1)
        return t

    def all_gather_into_tensor():
        t = torch.empty(8 * world, device=dev)
        dist.all_gather_into_tensor(t, x)
        return t

    def reduce_scatter_tensor():
        t = torch.empty(8 // world, device=dev)
        dist.reduce_scatter_tensor(t, x)
        return t

    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor)):
        attempt(name, fn)
    return out


def suite_cuda_ppermute(workdir, rank, world):
    """ppermute of CUDA tensors over gloo (host-staged: gloo's own
    send/recv write a CUDA pointer through the host and fail): the two
    ranks swap, and the gradient of sum(y * (rank + 1)) comes back."""
    from paddle_tpu_torch.distributed.communication.functional import (
        exchange, ppermute)

    mesh = make_mesh({"sep": 2})
    x = (torch.arange(8, dtype=torch.float32, device="cuda")
         + rank).requires_grad_()
    exchange.sends = exchange.recvs = 0
    y = ppermute(x, "sep", [(0, 1), (1, 0)], mesh=mesh)
    (y * (rank + 1.0)).sum().backward()
    return {"y": _np(y), "grad": _np(x.grad), "device": str(y.device),
            "p2p": (exchange.sends, exchange.recvs)}


RING_CARD = dict(b=2, s=512, hq=8, hkv=2, d=64)


def _ring_card_inputs():
    g = torch.Generator().manual_seed(27)
    c = RING_CARD
    return [torch.randn(c["b"], c["s"], h, c["d"], generator=g)
            for h in (c["hq"], c["hkv"], c["hkv"], c["hq"])]


def suite_cuda_ring(workdir, rank, world):
    """Ring attention over {"sep": 2} on the card (fp32, zigzag, causal):
    each rank's output and q, k, v gradients of sum(out * cot) on its
    contiguous shard, and its K1-lse / K2 (GLSE) / K3 launches."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.ring_attention import ring_attention

    mesh = make_mesh({"sep": 2})
    q, k, v, cot = (t.chunk(2, 1)[rank].contiguous().cuda()
                    for t in _ring_card_inputs())
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fwd = ops.flash_attention_forward
    bwd = ops.flash_attention_backward
    fwd.launches = bwd.launches_glse = bwd.launches_dkv = 0
    bwd.launches_dq = 0
    out = ring_attention(q, k, v, mesh, "sep", causal=True)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    return {"out": _np(out), "grads": [_np(t.grad) for t in (q, k, v)],
            "launches": (fwd.launches, bwd.launches_dq, bwd.launches_glse,
                         bwd.launches_dkv)}


PIPE_CARD = dict(layers=4, b=4, s=256, h=4, d=64, n_micro=2)


def _pipe_card_inputs():
    g = torch.Generator().manual_seed(28)
    c = PIPE_CARD
    ws = torch.randn(c["layers"], c["d"], c["d"], generator=g) * 0.1
    x = torch.randn(c["b"], c["s"], c["h"], c["d"], generator=g)
    return ws, x


def pipe_card_block(params, h):
    """A block with the flash kernels on the card: h + causal attention of
    (h @ w, h, h)."""
    from paddle_tpu_torch.ops import flash_attention

    return h + flash_attention(h @ params[0], h, h, causal=True)


def suite_cuda_pipeline(workdir, rank, world):
    """pipeline_call over {"pp": 2} on the card (GPipe, 2 microbatches,
    fp32): the loss mean(y ** 2), the gradients of the stacked weights
    (this rank's rows) and of the input (stage 0's), and the flash
    launches of the stage's 2 layers x 2 microbatches."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed.auto_parallel.pipeline import \
        pipeline_call

    mesh = make_mesh({"pp": 2})
    ws, x = (t.cuda().requires_grad_() for t in _pipe_card_inputs())
    fwd = ops.flash_attention_forward
    bwd = ops.flash_attention_backward
    fwd.launches = bwd.launches_dq = bwd.launches_dkv = 0
    y = pipeline_call(pipe_card_block, [ws], x, mesh=mesh,
                      n_micro=PIPE_CARD["n_micro"])
    loss = (y ** 2).mean()
    loss.backward()
    torch.cuda.synchronize()
    return {"loss": float(loss), "gw": _np(ws.grad), "gx": _np(x.grad),
            "launches": (fwd.launches, bwd.launches_dq, bwd.launches_dkv)}


def suite_cuda_dp(workdir, rank, world):
    """dp=2 on the card (fp32, small): losses, launches, gathered state."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    inp = np.load(os.path.join(workdir, "cuda_dp_in.npz"))
    # head_dim 64, which the flash kernels take
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_key_value_heads=4)
    eng = Engine(LlamaForCausalLM(cfg, seed=3), make_mesh({"dp": 2}),
                 lr=1e-3)
    n0 = (ops.flash_attention_forward.launches,
          ops.flash_attention_backward.launches_dq,
          ops.flash_attention_backward.launches_dkv)
    losses = [float(eng.step(inp[f"ids{i}"], inp[f"ids{i}"]))
              for i in range(3)]
    n1 = (ops.flash_attention_forward.launches,
          ops.flash_attention_backward.launches_dq,
          ops.flash_attention_backward.launches_dkv)
    sd = eng.state_dict()
    return {"losses": losses, "launches": [b - a for a, b in zip(n0, n1)],
            "model": _tree(sd["model"]) if rank == 0 else None}


SUITES = {"distributed": suite_distributed, "engine": suite_engine,
          "checkpoint": suite_checkpoint, "cuda_gloo": suite_cuda_gloo,
          "cuda_dp": suite_cuda_dp, "cuda_ring": suite_cuda_ring,
          "cuda_ppermute": suite_cuda_ppermute,
          "cuda_pipeline": suite_cuda_pipeline}


def main():
    suite, workdir = sys.argv[1], sys.argv[2]
    pt.set_device("cuda" if suite.startswith("cuda_") else "cpu")
    pdist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        out = SUITES[suite](workdir, rank, world)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)       # the other ranks may wait in a collective
    tmp = os.path.join(workdir, f"{suite}.{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, os.path.join(workdir, f"{suite}.{rank}.pkl"))
    dist.barrier()
    pdist.destroy_process_group()


if __name__ == "__main__":
    main()
