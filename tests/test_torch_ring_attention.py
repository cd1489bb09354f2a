"""The port's ring attention (``paddle_tpu_torch.ops.ring_attention``) and
its differentiable ``ppermute`` against the JAX package's, fp32 on the
CPU.

One world of 4 gloo ranks runs every case (this file is also the ranks'
script, ``python test_torch_ring_attention.py ring DIR``, started by
``torch_dist_harness.launch``), while this process computes the JAX
references under ``jax.jit`` (in threads) on meshes of the same shapes (4
of the 8 virtual CPU devices, tests/conftest.py):
- the copied zigzag helpers and ``_zigzag_pair_counts`` equal JAX's;
- ``ppermute``'s forward and its gradient equal ``lax.ppermute``'s, zeros
  for a coordinate that is no pair's destination included (exact: only
  copies);
- ``ring_attention`` on ``{sep: 4}`` and ``{sep: 2, tp: 2}``, zigzag and
  contiguous, causal and not, MHA and GQA: outputs, and dq/dk/dv of
  ``sum(out * cot)``, within rtol 1e-4 / atol 1e-5 of JAX's (the
  stripe pairs' fp32 partial attentions merge in another order than one
  softmax; summation order only).
"""

import os

import numpy as np
import pytest

B, S, D = 2, 64, 32
#: name -> (mesh, layout, causal, q heads, kv heads)
CASES = {
    "sep4_zigzag": ({"sep": 4}, "zigzag", True, 4, 4),
    "sep4_contiguous": ({"sep": 4}, "contiguous", True, 4, 4),
    "sep4_noncausal": ({"sep": 4}, "zigzag", False, 4, 4),
    "sep4_zigzag_gqa": ({"sep": 4}, "zigzag", True, 4, 2),
    "sep2_tp2_zigzag": ({"sep": 2, "tp": 2}, "zigzag", True, 4, 4),
    "sep2_tp2_zigzag_gqa": ({"sep": 2, "tp": 2}, "zigzag", True, 4, 2),
    "sep2_tp2_contiguous": ({"sep": 2, "tp": 2}, "contiguous", True, 4, 2),
    "sep2_tp2_noncausal": ({"sep": 2, "tp": 2}, "contiguous", False, 4, 4),
}
#: ppermute pairs over 4 coordinates: a ring, its reverse, a partial one
#: (coordinates 0 and 2 are no destination) and one with a fixed point
PERMS = {
    "ring": [(i, (i + 1) % 4) for i in range(4)],
    "reverse": [(i, (i - 1) % 4) for i in range(4)],
    "partial": [(0, 1), (2, 3)],
    "fixed": [(0, 0), (1, 2), (2, 1)],
}


def _inputs(case):
    _, _, _, hq, hkv = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, S, hq, D), f(B, S, hkv, D), f(B, S, hkv, D), f(B, S, hq, D)


def _perm_x(r):
    return (np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r)


# ---------------------------------------------------------------------------
# the ranks (this file as a script)
# ---------------------------------------------------------------------------

def _suite_ring(workdir, rank, world):
    import torch
    from torch.distributed.tensor import DTensor

    from paddle_tpu_torch.distributed.auto_parallel import axis_rules, \
        make_mesh
    from paddle_tpu_torch.distributed.auto_parallel.logical_sharding import \
        local_chunk, logical_placements
    from paddle_tpu_torch.distributed.communication.functional import (
        axis_index, ppermute)
    from paddle_tpu_torch.ops.ring_attention import ring_attention

    out = {"perm": {}}
    mesh = make_mesh({"sep": 4})
    out["axis_index"] = int(axis_index("sep", mesh))
    for name, perm in PERMS.items():
        x = torch.tensor(_perm_x(rank), requires_grad=True)
        with axis_rules(mesh):
            y = ppermute(x, "sep", perm)
        (y * (rank + 1.0)).sum().backward()
        out["perm"][name] = (y.detach().numpy().copy(),
                             x.grad.numpy().copy())
    meshes = {}
    for case, (axes, layout, causal, _, _) in CASES.items():
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = make_mesh(axes)
        mesh = meshes[key]
        q, k, v, cot = (torch.from_numpy(a) for a in _inputs(case))
        qp = logical_placements(("batch", "seq", "heads", None), mesh)
        kp = logical_placements(("batch", "seq", "kv_heads", None), mesh)

        def dt(t, pl):
            return DTensor.from_local(
                local_chunk(t, mesh, pl).contiguous(), mesh, pl,
                run_check=False, shape=t.shape, stride=t.stride())

        qd, kd, vd = (dt(q, qp).requires_grad_(True),
                      dt(k, kp).requires_grad_(True),
                      dt(v, kp).requires_grad_(True))
        o = ring_attention(qd, kd, vd, mesh, "sep", causal=causal,
                           layout=layout)
        (o * dt(cot, qp)).sum().backward()
        full = [t.full_tensor().detach().numpy().copy()
                for t in (o, qd.grad, kd.grad, vd.grad)]
        out[case] = full if rank == 0 else None
    return out


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------

def _jax_mesh(axes):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(list(axes.values())))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(
        tuple(axes.values())), tuple(axes))


def _jax_ppermute():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.framework.jax_compat import shard_map

    mesh = _jax_mesh({"sep": 4})
    xs = jnp.asarray(np.concatenate([_perm_x(r) for r in range(4)]))
    scale = jnp.repeat(jnp.arange(1.0, 5.0), 2)[:, None]
    out = {}
    for name, perm in PERMS.items():
        f = shard_map(lambda x: jax.lax.ppermute(x, "sep", perm), mesh=mesh,
                      in_specs=P("sep"), out_specs=P("sep"))
        y = jax.jit(f)(xs)
        g = jax.jit(jax.grad(lambda x: (f(x) * scale).sum()))(xs)
        out[name] = (np.asarray(y).reshape(4, 2, 3),
                     np.asarray(g).reshape(4, 2, 3))
    return out


def _jax_ring(case):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.distributed.auto_parallel.logical_sharding import \
        axis_rules
    from paddle_tpu.ops.ring_attention import ring_attention

    axes, layout, causal, _, _ = CASES[case]
    mesh = _jax_mesh(axes)
    q, k, v, cot = (jnp.asarray(a) for a in _inputs(case))

    def f(q, k, v):
        with axis_rules(mesh):
            o = ring_attention(q, k, v, mesh, "sep", causal=causal,
                               layout=layout)
        return (o * cot).sum(), o

    (_, o), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                           has_aux=True))(q, k, v)
    return [np.asarray(t) for t in (o, *g)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from torch_dist_harness import launch

    from concurrent.futures import ThreadPoolExecutor

    world = launch("ring", tmp_path_factory.mktemp("ring"), nprocs=4,
                   timeout=150, script=os.path.abspath(__file__))
    # the JAX programs compile in threads (XLA compiles outside the GIL)
    with ThreadPoolExecutor(4) as pool:
        perm = pool.submit(_jax_ppermute)
        futs = {case: pool.submit(_jax_ring, case) for case in CASES}
        jax_out = {case: f.result() for case, f in futs.items()}
        jax_out["perm"] = perm.result()
    return world.wait(), jax_out


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_zigzag_helpers_equal_jax(n):
    import importlib

    J = importlib.import_module("paddle_tpu.ops.ring_attention")
    T = importlib.import_module("paddle_tpu_torch.ops.ring_attention")

    s = 4 * n * 3
    np.testing.assert_array_equal(T.zigzag_perm(s, n), J.zigzag_perm(s, n))
    np.testing.assert_array_equal(T.zigzag_inverse(s, n),
                                  J.zigzag_inverse(s, n))
    assert T._zigzag_pair_counts(n) == J._zigzag_pair_counts(n)
    assert len(set(T._zigzag_pair_counts(n))) == 1


@pytest.mark.parametrize("name", sorted(PERMS))
def test_ppermute_forward_and_gradient_equal_lax(runs, name):
    port, jax_out = runs
    y_ref, g_ref = jax_out["perm"][name]
    for r in range(4):
        y, g = port[r]["perm"][name]
        np.testing.assert_array_equal(y, y_ref[r])
        np.testing.assert_array_equal(g, g_ref[r])


def test_axis_index_is_the_coordinate(runs):
    port, _ = runs
    assert [port[r]["axis_index"] for r in range(4)] == [0, 1, 2, 3]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_attention_and_grads_equal_jax(runs, case):
    port, jax_out = runs
    for got, want, what in zip(port[0][case], jax_out[case],
                               ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{case} {what}")


if __name__ == "__main__":
    from torch_dist_harness import rank_main

    rank_main({"ring": _suite_ring})
