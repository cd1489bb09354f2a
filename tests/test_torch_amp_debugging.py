"""``paddle_tpu_torch.amp.debugging`` against the JAX package's on the CPU.

Held: ``check_numerics`` (counts, the raise / warn modes, the health
word's bits); the tensor checker (raises naming the first op, warns,
restores the prior level); the operator-stats collection under O1; the
dispatcher's stats hook (``core.op_registry.stats_recorder``): the JAX
recorder and the port's give the same records (keys, dtype names, values
within 1e-6 of the statistic) for the same outputs; and a JAX dump and a
port dump of the same tiny encoder step (embeddings, a
TransformerEncoderLayer, a head and cross entropy, weights moved from JAX)
align op for op, and ``compare_accuracy`` flags 0 rows, both ways.
"""

import json
import warnings

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu.framework import numeric_guard as jguard
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.core import op_registry
from paddle_tpu_torch.framework import numeric_guard as pguard
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)
RNG = np.random.default_rng(23)
ENC = dict(vocab=64, hidden=16, heads=2, ffn=32, layers=1, max_pos=16,
           labels=3)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev
    pt.amp.debugging.disable_tensor_checker()
    jp.amp.debugging.disable_tensor_checker()


def encoder(P, cfg):
    """A Paddle-API encoder classifier, the same code for both packages."""
    nn = P.nn

    class Encoder(nn.Layer):
        def __init__(self):
            super().__init__()
            h = cfg["hidden"]
            self.word = nn.Embedding(cfg["vocab"], h)
            self.pos = nn.Embedding(cfg["max_pos"], h)
            self.norm = nn.LayerNorm(h)
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                h, cfg["heads"], cfg["ffn"], dropout=0.0, activation="gelu"),
                cfg["layers"])
            self.head = nn.Linear(h, cfg["labels"])

        def forward(self, ids):
            pos = P.arange(ids.shape[1]).unsqueeze(0)
            x = self.norm(self.word(ids) + self.pos(pos))
            return self.head(self.encoder(x)[:, 0])

    return Encoder()


def _dump_step(P, model, ids, labels, path, **amp):
    with P.amp.debugging.dump_tensor_stats(path):
        with P.amp.auto_cast(**amp) if amp else _null():
            loss = P.nn.functional.cross_entropy(model(P.to_tensor(ids)),
                                                 P.to_tensor(labels))
        loss.backward()
    return loss


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_check_numerics():
    for P, G in ((jp, jguard), (pt, pguard)):
        dbg = P.amp.debugging
        n, i = dbg.check_numerics(P.to_tensor(np.ones(4, np.float32)))
        assert int(n) == 0 and int(i) == 0
        bad = np.array([1.0, np.nan, np.inf, -np.inf, np.nan], np.float32)
        G.consume_health()
        with pytest.raises(FloatingPointError, match="op=matmul var=w"):
            dbg.check_numerics(P.to_tensor(bad), "matmul", "w")
        word = G.consume_health()
        assert word & G.NAN_GRAD and word & G.INF_GRAD
        with pytest.warns(UserWarning, match="2 nan, 2 inf"):
            n, i = dbg.check_numerics(P.to_tensor(bad), "op", "v",
                                      dbg.DebugMode.CHECK_NAN_INF)
        assert (int(n), int(i)) == (2, 2)
    assert pt.amp.debugging.DebugMode.CHECK_ALL == \
        jp.amp.debugging.DebugMode.CHECK_ALL


def test_tensor_checker_raises_names_op_and_restores_level():
    for P in (jp, pt):
        dbg = P.amp.debugging
        P.set_flags({"check_nan_inf_level": 3})
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
            debug_mode=dbg.DebugMode.CHECK_NAN_INF_AND_ABORT))
        assert dbg.tensor_checker_config() is not None
        x = P.to_tensor(np.array([1.0, 0.0], np.float32))
        with pytest.raises(FloatingPointError, match="log"):
            P.log(x - 1.0)
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
            debug_mode=dbg.DebugMode.CHECK_NAN_INF))
        with pytest.warns(UserWarning, match="divide"):
            P.divide(x, P.zeros([2]))
        dbg.disable_tensor_checker()
        assert P.flags.get_flag("check_nan_inf_level") == 3
        assert not P.flags.get_flag("check_nan_inf")
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=False))
        assert dbg.tensor_checker_config() is None
        P.set_flags({"check_nan_inf_level": 0})


def test_operator_stats_under_o1(capsys):
    out = []
    for P in (jp, pt):
        with P.amp.auto_cast(level="O1"):
            with P.amp.debugging.enable_operator_stats_collection():
                a = P.to_tensor(np.ones((2, 3), np.float32))
                P.matmul(a, P.transpose(a, [1, 0]))
                P.nn.functional.linear(a, P.ones([3, 4]))
                P.nn.functional.linear(a, P.ones([3, 4]))
                P.exp(a)
                stats = P.amp.debugging.collect_operator_stats()
        out.append(stats)
    assert out[0] == out[1] == {"matmul": 1, "linear": 2}
    assert "low-precision calls: 2" in capsys.readouterr().out
    assert pt.amp.debugging.collect_operator_stats() == {}


def test_recorder_records_match_jax():
    x = RNG.standard_normal((3, 5)).astype(np.float32)
    x[0, 0], x[1, 1], x[2, 2] = np.nan, np.inf, -np.inf
    recs = []
    for P in (jp, pt):
        rec = P.amp.debugging._StatsRecorder()
        prev = P.core.op_registry.stats_recorder
        P.core.op_registry.stats_recorder = rec
        try:
            t = P.to_tensor(x)
            P.add(t, t)
            P.topk(P.to_tensor(np.abs(x[:, 3:])), 1)
            P.cast(t, "bfloat16")
            P.argmax(t)
        finally:
            P.core.op_registry.stats_recorder = prev
        recs.append(rec.records)
    assert len(recs[0]) == len(recs[1]) == 3
    for a, b in zip(*recs):
        assert sorted(a) == sorted(b)
        for k in ("op", "out", "dtype", "shape", "num_nan", "num_inf"):
            assert a[k] == b[k], (k, a, b)
        for k in ("mean_abs", "max_abs"):
            assert abs(a[k] - b[k]) <= 1e-6 * max(1.0, abs(a[k]))
    assert recs[1][2]["dtype"] == "bfloat16"


def test_stats_hook_costs_one_check_when_off():
    assert op_registry.stats_recorder is None
    x = pt.ones([2])
    with pt.amp.debugging.dump_tensor_stats("/dev/null") as rec:
        assert op_registry.stats_recorder is rec
        pt.exp(x)
        assert len(rec._pending) == 1     # on the device until the close
    assert op_registry.stats_recorder is None and not rec._pending


def _pair():
    jp.seed(0)
    jm = encoder(jp, ENC)
    tm = encoder(pt, ENC)
    load_jax_state(tm, state_from_jax_layer(jm))
    ids = RNG.integers(0, ENC["vocab"], (2, 8))
    labels = RNG.integers(0, ENC["labels"], (2,))
    return jm, tm, ids, labels


def test_jax_and_port_dumps_align_and_agree(tmp_path):
    jm, tm, ids, labels = _pair()
    paths = {"jax": str(tmp_path / "jax.jsonl"),
             "port": str(tmp_path / "port.jsonl")}
    _dump_step(jp, jm, ids, labels, paths["jax"])
    _dump_step(pt, tm, ids, labels, paths["port"])
    seqs = {k: [(r["op"], r["dtype"], r["shape"]) for r in
                map(json.loads, open(p))] for k, p in paths.items()}
    assert seqs["jax"] == seqs["port"] and len(seqs["jax"]) >= 20
    for a, b in ((paths["jax"], paths["port"]),
                 (paths["port"], paths["jax"])):
        out = str(tmp_path / "cmp.csv")
        assert pt.amp.debugging.compare_accuracy(a, b, out) == []
        assert jp.amp.debugging.compare_accuracy(a, b, out) == []
        assert open(out).readline().startswith("op,out,call,status")


def test_fp32_and_bf16_dumps_align(tmp_path):
    """The reference workflow: an fp32 step and an O1 bf16 step dumped and
    compared. The port's two dumps align op for op (no MISSING row). The
    JAX package's do not: its AMP casts go through the dispatcher (JAX
    ``op_registry._amp_cast_preserving_graph``), so its bf16 dump carries
    ``cast`` records the fp32 one lacks (MISSING_IN_A); the port casts
    inside the dispatcher, unrecorded. The other rows flag alike."""
    jm, tm, ids, labels = _pair()
    flagged = {}
    for P, m in (("jax", jm), ("port", tm)):
        pkg = jp if P == "jax" else pt
        f32, b16 = str(tmp_path / f"{P}32"), str(tmp_path / f"{P}16")
        _dump_step(pkg, m, ids, labels, f32)
        _dump_step(pkg, m, ids, labels, b16, level="O1", dtype="bfloat16")
        rows = pkg.amp.debugging.compare_accuracy(
            f32, b16, str(tmp_path / f"{P}.csv"), rtol=5e-2)
        missing = {r["op"] for r in rows if r["status"].startswith("MISSING")}
        assert missing == ({"cast"} if P == "jax" else set())
        flagged[P] = [r for r in rows if r["op"] != "cast"]
    dtypes = [json.loads(line)["dtype"] for line in open(tmp_path / "port16")]
    assert "bfloat16" in dtypes and "float32" in dtypes
    assert len(flagged["port"]) <= len(flagged["jax"]) + 2


def test_compare_accuracy_flags_missing_and_nonfinite(tmp_path):
    rec = {"op": "add", "out": 0, "dtype": "float32", "shape": [2],
           "mean_abs": 1.0, "max_abs": 2.0, "num_nan": 0, "num_inf": 0}
    a, b = tmp_path / "a", tmp_path / "b"
    a.write_text(json.dumps(rec) + "\n" + json.dumps(dict(rec, op="exp"))
                 + "\n")
    b.write_text(json.dumps(dict(rec, num_nan=1, mean_abs=2.0)) + "\n")
    for P in (jp, pt):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rows = P.amp.debugging.compare_accuracy(
                str(a), str(b), str(tmp_path / "o.csv"), loss_scale=2,
                dump_all_tensors=True)
        assert [r["status"] for r in rows] == ["EXCESS_ERROR",
                                               "MISSING_IN_B"]
