"""Graph-learning ops — port of ``paddle_tpu/geometric/__init__.py``.

- The segment reductions (``segment_sum/mean/min/max``) and message
  passing (``send_u_recv``, ``send_ue_recv``, ``send_uv``) gather with
  indexing and reduce with ``index_add`` (sum, mean) and
  ``scatter_reduce`` (min, max), where the tensors lie; a segment no row
  reaches is 0, as in JAX; counts for the mean are fp32. They go through
  the op dispatcher, so autograd reaches the data.
- ``reindex_graph`` / ``reindex_heter_graph`` and the neighbour samplers
  have data-dependent shapes and run on the host in numpy, as in JAX; the
  samplers draw from ``numpy.random.default_rng(next_host_seed())``, the
  JAX package's stream, so under one ``paddle.seed`` both packages sample
  the same neighbours. Their results go to the device of their graph
  tensors (the current place for numpy input).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.op_registry import apply_fn
from ..core.tensor import Tensor, unwrap
from ..device import resolve_device
from ..framework.random import next_host_seed

__all__ = [
    "send_u_recv", "send_ue_recv", "send_uv",
    "segment_sum", "segment_mean", "segment_min", "segment_max",
    "reindex_graph", "reindex_heter_graph",
    "sample_neighbors", "weighted_sample_neighbors",
]


def _ids(x, device):
    """Index operand as an int64 tensor on ``device``."""
    x = unwrap(x)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=device)


def _data(x):
    """Feature data: a tensor as it is, array data through ``to_tensor``
    on the current place (float64 becomes float32)."""
    if isinstance(x, torch.Tensor):
        return x
    from ..tensor.creation import to_tensor

    return to_tensor(x)


def _num_segments(ids, hint=None):
    if hint is not None:
        return int(hint)
    return int(ids.max()) + 1 if ids.numel() else 0


# ---------------------------------------------------------------------------
# segment reductions and message passing
# ---------------------------------------------------------------------------

def _reduce_to_dst(msg, dst, n, reduce_op):
    """Rows of ``msg`` reduced into ``n`` rows at ``dst``."""
    shape = (n,) + tuple(msg.shape[1:])
    if reduce_op == "sum":
        return msg.new_zeros(shape).index_add(0, dst, msg)
    counts = torch.zeros((n,), dtype=torch.float32,
                         device=msg.device).index_add(
        0, dst, torch.ones((msg.shape[0],), dtype=torch.float32,
                           device=msg.device))
    bshape = (n,) + (1,) * (msg.ndim - 1)
    if reduce_op == "mean":
        tot = msg.new_zeros(shape).index_add(0, dst, msg)
        return tot / counts.clamp_min(1.0).to(msg.dtype).reshape(bshape)
    if reduce_op in ("min", "max"):
        idx = dst.reshape((-1,) + (1,) * (msg.ndim - 1)).expand_as(msg)
        out = msg.new_zeros(shape).scatter_reduce(
            0, idx, msg, "amin" if reduce_op == "min" else "amax",
            include_self=False)
        return torch.where((counts > 0).reshape(bshape), out,
                           torch.zeros_like(out))
    raise ValueError(f"reduce_op must be sum/mean/min/max, got {reduce_op!r}")


def _segment(data, segment_ids, op):
    data = _data(data)
    ids = _ids(segment_ids, data.device)
    n = _num_segments(ids)
    return apply_fn(f"geometric.segment_{op}",
                    lambda d: _reduce_to_dst(d, ids, n, op), data)


def segment_sum(data, segment_ids, name=None):
    """out[i] = the sum of the rows whose segment id is i."""
    return _segment(data, segment_ids, "sum")


def segment_mean(data, segment_ids, name=None):
    """The mean a segment; an empty segment gives 0."""
    return _segment(data, segment_ids, "mean")


def segment_min(data, segment_ids, name=None):
    """The minimum a segment; an empty segment gives 0."""
    return _segment(data, segment_ids, "min")


def segment_max(data, segment_ids, name=None):
    """The maximum a segment; an empty segment gives 0."""
    return _segment(data, segment_ids, "max")


def _rows_out(x, out_size):
    return (int(out_size) if out_size is not None and int(out_size) > 0
            else x.shape[0])


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """x[src_index] reduced into rows ``dst_index``; ``out_size`` rows
    (default: x's), rows no edge reaches 0."""
    x = _data(x)
    src, dst = _ids(src_index, x.device), _ids(dst_index, x.device)
    n = _rows_out(x, out_size)
    return apply_fn("geometric.send_u_recv",
                    lambda xd: _reduce_to_dst(xd[src], dst, n, reduce_op), x)


def _edge_message(xg, y, message_op):
    if y.ndim < xg.ndim:
        y = y.reshape(tuple(y.shape) + (1,) * (xg.ndim - y.ndim))
    if message_op == "add":
        return xg + y
    if message_op == "sub":
        return xg - y
    if message_op == "mul":
        return xg * y
    if message_op == "div":
        return xg / y
    raise ValueError(f"message_op must be add/sub/mul/div, got {message_op!r}")


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """x[src_index] combined with the edge values ``y`` by ``message_op``,
    reduced into rows ``dst_index``."""
    x = _data(x)
    y = _data(y)
    src, dst = _ids(src_index, x.device), _ids(dst_index, x.device)
    n = _rows_out(x, out_size)
    return apply_fn(
        "geometric.send_ue_recv",
        lambda xd, yd: _reduce_to_dst(_edge_message(xd[src], yd, message_op),
                                      dst, n, reduce_op), x, y)


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """One output an edge: ``message_op(x[src], y[dst])``."""
    x = _data(x)
    y = _data(y)
    src, dst = _ids(src_index, x.device), _ids(dst_index, x.device)
    return apply_fn(
        "geometric.send_uv",
        lambda xd, yd: _edge_message(xd[src], yd[dst], message_op), x, y)


# ---------------------------------------------------------------------------
# reindex and neighbour sampling (host, data-dependent shapes)
# ---------------------------------------------------------------------------

def _np(x):
    x = unwrap(x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _device_of(x):
    return x.device if isinstance(x, torch.Tensor) else resolve_device()


def _out(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device).as_subclass(
        Tensor)


def _reindex(x, neighbor_lists, count_lists):
    dev = _device_of(x)
    x = _np(x).reshape(-1)
    mapping = {}
    out_nodes = []
    for v in x.tolist():
        mapping[v] = len(out_nodes)
        out_nodes.append(v)
    srcs, dsts = [], []
    for neighbors, count in zip(neighbor_lists, count_lists):
        neighbors = _np(neighbors).reshape(-1)
        count = _np(count).reshape(-1)
        for v in neighbors.tolist():
            if v not in mapping:
                mapping[v] = len(out_nodes)
                out_nodes.append(v)
        srcs.append(np.asarray([mapping[v] for v in neighbors.tolist()],
                               np.int64))
        dsts.append(np.repeat(np.arange(len(count), dtype=np.int64), count))
    src = np.concatenate(srcs) if srcs else np.zeros((0,), np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros((0,), np.int64)
    nodes = np.asarray(out_nodes, x.dtype)
    return (_out(src.astype(x.dtype), dev), _out(dst.astype(x.dtype), dev),
            _out(nodes, dev))


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """Reindex sampled-subgraph node ids from 0 (reindex.py:32): returns
    (reindex_src, reindex_dst, out_nodes); out_nodes = x ++ first-seen
    neighbors not in x. Host-side (data-dependent shapes), like the
    reference's sampling pipeline."""
    return _reindex(x, [neighbors], [count])


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """reindex_graph over per-edge-type neighbor lists sharing one node set
    (reindex.py:157)."""
    return _reindex(x, list(neighbors), list(count))


# ---------------------------------------------------------------------------
# neighbor sampling (sampling/neighbors.py) — host-side
# ---------------------------------------------------------------------------

def _sample(row, colptr, input_nodes, sample_size, eids, return_eids,
            weights=None):
    dev = _device_of(row)
    row = _np(row).reshape(-1)
    colptr = _np(colptr).reshape(-1)
    nodes = _np(input_nodes).reshape(-1)
    if eids is not None:
        eids = _np(eids).reshape(-1)
    elif return_eids:
        raise ValueError("return_eids=True requires eids")
    out_n, out_c, out_e = [], [], []
    w_all = _np(weights).reshape(-1).astype(np.float64) \
        if weights is not None else None
    # reproducible under paddle.seed: the framework RNG stream seeds numpy
    rng = np.random.default_rng(next_host_seed())
    for n in nodes.tolist():
        lo, hi = int(colptr[n]), int(colptr[n + 1])
        deg = hi - lo
        idx = np.arange(lo, hi)
        if 0 <= sample_size < deg:
            if w_all is None:
                idx = rng.choice(idx, size=sample_size, replace=False)
            else:
                w = w_all[lo:hi]
                p = w / w.sum() if w.sum() > 0 else None
                idx = rng.choice(idx, size=sample_size, replace=False, p=p)
            deg = sample_size
        out_n.append(row[idx])
        out_c.append(deg)
        if return_eids:
            out_e.append(eids[idx])
    neighbors = (np.concatenate(out_n) if out_n
                 else np.zeros((0,), row.dtype))
    counts = np.asarray(out_c, np.int32)
    if return_eids:
        e = np.concatenate(out_e) if out_e else np.zeros((0,), row.dtype)
        return _out(neighbors, dev), _out(counts, dev), _out(e, dev)
    return _out(neighbors, dev), _out(counts, dev)


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Uniform neighbor sampling over a CSC graph
    (sampling/neighbors.py:68): returns (neighbors, counts[, eids]).
    sample_size=-1 takes all neighbors."""
    return _sample(row, colptr, input_nodes, sample_size, eids, return_eids)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None, return_eids=False,
                              name=None):
    """Weight-proportional sampling without replacement
    (sampling/neighbors.py weighted_sample_neighbors)."""
    return _sample(row, colptr, input_nodes, sample_size, eids, return_eids,
                   weights=edge_weight)
