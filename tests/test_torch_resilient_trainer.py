"""The port's resilience trainer, ``LATEST`` fence and checkpoint
publisher against the JAX package on the CPU.

Every scenario runs in both packages on JAX's guard fixture (one
``Linear`` of 8, a float loss, lr 0.05, no clip), the port's model
carrying the JAX model's seed-0 weights, both engines ``mesh=None``; the
JAX package's own tests for these (tests/test_numeric_guard.py:243-290,
tests/test_resilience.py:629-655, tests/test_lifecycle.py:57-95, :150-200
and :329-456) run meshes and the elastic manager, which the port's trainer
refuses (``elastic=``). Held equal to JAX's:
- resume; the fallback past a corrupt newest checkpoint; a NaN rollback
  whose replayed tail equals an uninterrupted run; skip with capture
  (the captures byte-equal); abort with the typed error and its codes;
- the ``LATEST`` fence (its bytes, the stale writer's PT-CKPT-005, the
  legacy bare integer, the commit fence of a killed async flush, the
  zombie trainer); a checkpoint directory crossing packages both ways;
- the publisher: the published model bit-equal to the checkpoint's
  parameters, a corrupt checkpoint refused with the weights intact, the
  generation fence, the ``publish`` and ``resume`` spans, and both
  collectors' ``MetricsRegistry.dump()`` text.
Losses: relative 1e-6 (the same fp32 arithmetic on 8 x 8 matmuls; the
two BLAS calls may sum in other orders).
"""

import functools
import json

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability as jobs
import paddle_tpu_torch as pt
import paddle_tpu_torch.observability as tobs
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.auto_parallel import Engine as JEngine
from paddle_tpu.distributed.checkpoint import latest as jlatest
from paddle_tpu.distributed.resilience import FaultPlan as JFaultPlan
from paddle_tpu.distributed.resilience import FaultSpec as JFaultSpec
from paddle_tpu.distributed.resilience import ResilientTrainer as JTrainer
from paddle_tpu.distributed.resilience import lifecycle as jlife
from paddle_tpu.distributed.resilience.watchdog import \
    NumericWatchdog as JWatchdog
from paddle_tpu.framework import numeric_guard as jng
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.distributed import Engine as TEngine
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed.checkpoint import latest as tlatest
from paddle_tpu_torch.distributed.resilience import FaultPlan as TFaultPlan
from paddle_tpu_torch.distributed.resilience import FaultSpec as TFaultSpec
from paddle_tpu_torch.distributed.resilience import \
    ResilientTrainer as TTrainer
from paddle_tpu_torch.distributed.resilience import lifecycle as tlife
from paddle_tpu_torch.distributed.resilience.watchdog import \
    NumericWatchdog as TWatchdog
from paddle_tpu_torch.framework import numeric_guard as tng
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)
D = 8


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


class JToy(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = paddle.nn.Linear(D, D)

    def loss_fn(self, x, y):
        out = self.fc(Tensor(x))
        diff = out._data - y
        return (diff * diff).mean()


class TToy(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = pt.nn.Linear(D, D)

    def loss_fn(self, x, y):
        diff = self.fc(x) - y
        return (diff * diff).mean()


@functools.lru_cache(maxsize=1)
def _seed0_weights():
    paddle.seed(0)
    return state_from_jax_layer(JToy())


def _jbuild(policy=None):
    def build(alive):
        paddle.seed(0)
        return JEngine(JToy(), None, lr=0.05, clip_norm=None, guard=policy)
    return build


def _tbuild(policy=None):
    def build(alive):
        m = TToy()
        load_jax_state(m, _seed0_weights())
        return TEngine(m, None, lr=0.05, clip_norm=None, guard=policy)
    return build


def _data_fn(step, b=8):
    rng = np.random.default_rng(1000 + step)
    return (rng.standard_normal((b, D)).astype(np.float32),
            rng.standard_normal((b, D)).astype(np.float32))


PKGS = {
    "jax": dict(Trainer=JTrainer, build=_jbuild, Plan=JFaultPlan,
                Spec=JFaultSpec, ng=jng, ckpt=jckpt, latest=jlatest,
                life=jlife, obs=jobs, Watchdog=JWatchdog),
    "port": dict(Trainer=TTrainer, build=_tbuild, Plan=TFaultPlan,
                 Spec=TFaultSpec, ng=tng, ckpt=tckpt, latest=tlatest,
                 life=tlife, obs=tobs, Watchdog=TWatchdog),
}


def _both(case, tmp_path):
    """``case(pkg, dir)`` for each package, each in a directory of its
    own: ``{"jax": ..., "port": ...}``."""
    out = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = case(pkg, d)
    return out


def _close(a, b):
    assert sorted(a) == sorted(b)
    np.testing.assert_allclose([a[k] for k in sorted(a)],
                               [b[k] for k in sorted(b)], rtol=1e-6)


def _flip(path):
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))


def _host(t):
    t = getattr(t, "_data", t)
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


# ---------------------------------------------------------------------------
# resume, fallback
# ---------------------------------------------------------------------------

def test_resume_continues_training_as_jax(tmp_path):
    def case(pkg, d):
        build = pkg["build"]()
        out1 = pkg["Trainer"](build, str(d), save_every=2).fit(_data_fn, 4)
        t2 = pkg["Trainer"](build, str(d), save_every=2)
        out2 = t2.fit(_data_fn, 6)
        return out1["losses"], out2["losses"], t2.latest_step()

    r = _both(case, tmp_path)
    for i in range(2):
        _close(r["port"][i], r["jax"][i])
    assert r["port"][2] == r["jax"][2] == 6
    # steps 1-4 were not re-run: the resume started at the recorded step
    assert sorted(r["port"][1]) == [5, 6]


def test_corrupt_latest_falls_back_as_jax(tmp_path):
    def case(pkg, d):
        build = pkg["build"]()
        pkg["Trainer"](build, str(d), save_every=2,
                       async_save=False).fit(_data_fn, 4)
        _flip(d / "step_00000004" / "0_0.distcp")
        t2 = pkg["Trainer"](build, str(d), save_every=2)
        return t2.resume(build(["local"]))

    r = _both(case, tmp_path)
    assert r["port"] == r["jax"] == 2       # newest corrupt -> step 2


# ---------------------------------------------------------------------------
# the guard in the trainer: rollback, skip with capture, abort
# ---------------------------------------------------------------------------

def test_nan_rollback_matches_uninterrupted_as_jax(tmp_path):
    def case(pkg, d):
        pol = pkg["ng"].GuardPolicy(action="rollback", warmup_steps=3,
                                    spike_factor=50.0)
        build = pkg["build"](pol)
        ref = pkg["Trainer"](build, str(d / "ref"), save_every=100,
                             async_save=False).fit(_data_fn, 8)
        trainer = pkg["Trainer"](build, str(d / "job"), save_every=2,
                                 async_save=False)
        with pkg["Plan"](seed=3, specs=[
                pkg["Spec"]("numeric.step", "nan_grad", at=5, count=1)]):
            out = trainer.fit(_data_fn, 8)
        return ref, out

    r = _both(case, tmp_path)
    (tref, tout), (jref, jout) = r["port"], r["jax"]
    for key in ("numeric_rollbacks", "rollback_at", "numeric_events",
                "numeric_skips", "final_step"):
        assert tout[key] == jout[key], key
    assert tout["numeric_rollbacks"] == 1 and tout["rollback_at"] == [4]
    assert tout["numeric_events"][0][1] & tng.NAN_GRAD
    _close(tout["losses"], jout["losses"])
    _close(tref["losses"], jref["losses"])
    for s in range(5, 9):                   # the replayed tail
        np.testing.assert_allclose(tout["losses"][s], tref["losses"][s],
                                   rtol=1e-6)


def test_skip_with_capture_as_jax(tmp_path):
    def case(pkg, d):
        pol = pkg["ng"].GuardPolicy(action="skip_step", warmup_steps=3,
                                    spike_factor=50.0)
        trainer = pkg["Trainer"](pkg["build"](pol), str(d), save_every=100,
                                 async_save=False)
        with pkg["Plan"](seed=3, specs=[pkg["Spec"](
                "data.batch", "poison_batch", at=2, count=1, arg=4)]):
            out = trainer.fit(_data_fn, 6)
        rec = pkg["ng"].BadBatchRecorder(str(d / "badbatch"))
        return out, rec.steps()

    r = _both(case, tmp_path)
    (tout, tsteps), (jout, jsteps) = r["port"], r["jax"]
    assert tout["numeric_skips"] == jout["numeric_skips"] == [3]
    assert tout["numeric_events"] == jout["numeric_events"]
    _close(tout["losses"], jout["losses"])
    assert tsteps == jsteps == [3]
    for name in ("meta.json", "batch.npz"):
        a = tmp_path / "port" / "badbatch" / "step_00000003" / name
        b = tmp_path / "jax" / "badbatch" / "step_00000003" / name
        assert a.read_bytes() == b.read_bytes(), name
    meta, arrays = tng.BadBatchRecorder(
        str(tmp_path / "jax" / "badbatch")).load(3)
    assert meta["codes"] and np.isnan(arrays["input_ids"]).any()


def test_abort_raises_the_typed_error_as_jax(tmp_path):
    def case(pkg, d):
        pol = pkg["ng"].GuardPolicy(action="abort", warmup_steps=3)
        trainer = pkg["Trainer"](pkg["build"](pol), str(d), save_every=100,
                                 async_save=False)
        with pkg["Plan"](seed=3, specs=[
                pkg["Spec"]("numeric.step", "nan_grad", at=2, count=1)]):
            with pytest.raises(pkg["ng"].NumericAnomalyError) as ei:
                trainer.fit(_data_fn, 6)
        return ei.value.word, ei.value.step, ei.value.codes, str(ei.value)

    r = _both(case, tmp_path)
    assert r["port"] == r["jax"]
    assert "PT-NUM-001" in r["port"][2]


# ---------------------------------------------------------------------------
# the LATEST fence
# ---------------------------------------------------------------------------

def test_latest_fence_bytes_and_errors_as_jax(tmp_path):
    def case(pkg, d):
        L = pkg["latest"]
        out = [L.read_latest(str(d)), L.latest_generation(str(d))]
        L.commit_latest(str(d), 5, 1)
        out.append((d / "LATEST").read_bytes())
        L.commit_latest(str(d), 10, 3)
        with pytest.raises(L.StaleGenerationError) as ei:
            L.commit_latest(str(d), 12, 2)
        e = ei.value
        out += [(e.code, e.committed, e.attempted, e.path == str(d),
                 str(e).replace(str(d), "D")), L.read_latest(str(d))]
        L.commit_latest(str(d), 14, 3)       # same writer, later save
        out.append(L.read_latest(str(d)))
        (d / "LATEST").write_text("7")       # a legacy pointer
        out += [L.read_latest(str(d)), L.claim_generation(str(d))]
        g1 = L.claim_generation(str(d))
        L.commit_latest(str(d), 1, g1)
        g2 = L.claim_generation(str(d))
        L.commit_latest(str(d), 3, g2)
        with pytest.raises(L.StaleGenerationError):
            L.commit_latest(str(d), 5, g1)
        out += [g1, g2, (d / "LATEST").read_bytes()]
        return out

    r = _both(case, tmp_path)
    assert r["port"] == r["jax"]
    assert r["port"][2] == b"5 1" and r["port"][-1] == b"3 2"
    assert r["port"][3][0] == "PT-CKPT-005"


def test_trainer_commit_fence_and_zombie_as_jax(tmp_path):
    def case(pkg, d):
        build = pkg["build"]()
        L = pkg["latest"]
        t = pkg["Trainer"](build, str(d / "kill"), save_every=2,
                           async_save=True)
        eng = build(["local"])
        for s in range(2):
            eng.step(*_data_fn(s))
        t.save(eng, 2, sync=True)
        out = [L.read_latest(str(d / "kill"))]
        with pkg["Plan"](specs=[pkg["Spec"]("checkpoint.shard", "error")]):
            t.save(eng, 4)                   # the async flush dies
            with pytest.raises(RuntimeError, match="fault injected"):
                t.commit()
        t.commit()                           # must not resurrect step 4
        out.append(L.read_latest(str(d / "kill")))
        t2 = pkg["Trainer"](build, str(d / "kill"), save_every=2)
        out.append(t2.resume(build(["local"])))
        old = pkg["Trainer"](build, str(d / "z"), save_every=2,
                             async_save=False)
        old.save(eng, 2, sync=True)
        new = pkg["Trainer"](build, str(d / "z"), save_every=2,
                             async_save=False)
        new.save(eng, 4, sync=True)
        with pytest.raises(L.StaleGenerationError):
            old.save(eng, 6, sync=True)
        out += [old.generation, new.generation,
                L.read_latest(str(d / "z"))]
        return out

    r = _both(case, tmp_path)
    assert r["port"] == r["jax"] == [(2, 1), (2, 1), 2, 1, 2, (4, 2)]


def test_checkpoint_directories_cross_packages_both_ways(tmp_path):
    """Four steps in one package, two more in the other from its
    directory (LATEST included): the same losses as six in either."""
    runs = {}
    for first, second in (("jax", "port"), ("port", "jax")):
        d = tmp_path / f"{first}_then_{second}"
        a, b = PKGS[first], PKGS[second]
        out1 = a["Trainer"](a["build"](), str(d), save_every=2
                            ).fit(_data_fn, 4)
        t2 = b["Trainer"](b["build"](), str(d), save_every=2)
        assert t2.generation == 2            # above the first one's
        out2 = t2.fit(_data_fn, 6)
        assert sorted(out2["losses"]) == [5, 6]
        assert (d / "LATEST").read_bytes() == b"6 2"
        runs[first] = {**out1["losses"], **out2["losses"]}
    whole = PKGS["jax"]["Trainer"](PKGS["jax"]["build"](),
                                   str(tmp_path / "whole"), save_every=2
                                   ).fit(_data_fn, 6)["losses"]
    _close(runs["jax"], whole)
    _close(runs["port"], whole)


# ---------------------------------------------------------------------------
# the checkpoint publisher
# ---------------------------------------------------------------------------

def _trained(pkg, d, steps=2):
    t = pkg["Trainer"](pkg["build"](), str(d), save_every=1,
                       async_save=False)
    return t, t.fit(_data_fn, steps)["engine"]


def _model_leaves(model):
    return {k: _host(v) for k, v in model.state_dict().items()}


def test_publish_fills_the_model_bit_equal_as_jax(tmp_path):
    def case(pkg, d):
        pkg["life"].reset_lifecycle_stats()
        t, eng = _trained(pkg, d)
        model = pkg["build"]()(["solo"]).model
        pub = pkg["life"].CheckpointPublisher(str(d)).publish(model)
        ref = {k: _host(v) for k, v in eng.state_dict()["model"].items()}
        got = _model_leaves(model)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        pub.pop("time_s")
        return pub, t.generation, pkg["life"].lifecycle_stats(), got

    r = _both(case, tmp_path)
    assert r["port"][:3] == r["jax"][:3]
    assert r["port"][0]["step"] == 2 and r["port"][0]["shards"] >= 1
    assert r["port"][2]["phase"] == "serve"
    for k, v in r["jax"][3].items():        # the trained weights agree too
        np.testing.assert_allclose(r["port"][3][k], v, rtol=1e-6, atol=1e-7)


def test_corrupt_checkpoint_refused_weights_intact_as_jax(tmp_path):
    def case(pkg, d):
        pkg["life"].reset_lifecycle_stats()
        _trained(pkg, d)
        _flip(d / "step_00000002" / "0_0.distcp")
        model = pkg["build"]()(["solo"]).model
        before = _model_leaves(model)
        with pytest.raises(pkg["ckpt"].CheckpointCorruptionError) as ei:
            pkg["life"].CheckpointPublisher(str(d)).publish(model)
        after = _model_leaves(model)
        for k in before:
            np.testing.assert_array_equal(after[k], before[k])
        return ei.value.code, pkg["life"].lifecycle_stats()

    r = _both(case, tmp_path)
    assert r["port"] == r["jax"]
    assert r["port"][1]["publish_failures"] == 1
    assert r["port"][1]["publish_total"] == 0


def test_publisher_generation_fence_as_jax(tmp_path):
    def case(pkg, d):
        _trained(pkg, d)                     # step dirs 1 and 2
        model = pkg["build"]()(["solo"]).model
        publisher = pkg["life"].CheckpointPublisher(str(d))
        pub = publisher.publish(model)
        with pytest.raises(pkg["latest"].StaleGenerationError) as ei:
            publisher.publish(model, step=1)
        pub2 = publisher.publish(model)
        return (pub["generation"], ei.value.code, pub2["generation"],
                publisher.latest())

    r = _both(case, tmp_path)
    assert r["port"] == r["jax"] == (1, "PT-CKPT-005", 1, (2, 1))


def test_publish_and_resume_spans_as_jax(tmp_path):
    def case(pkg, d):
        _trained(pkg, d)
        tr = pkg["obs"].TraceRecorder()
        publisher = pkg["life"].CheckpointPublisher(str(d), tracer=tr)
        model = pkg["build"]()(["solo"]).model
        publisher.publish(model)
        _flip(d / "step_00000002" / "0_0.distcp")
        with pytest.raises(pkg["ckpt"].CheckpointCorruptionError):
            publisher.publish(model)
        tr.resume(tr.now(), step=3, world=4)
        return [(e["name"], e["ph"], e["args"]) for e in tr.events
                if e["name"] in ("publish", "resume")]

    r = _both(case, tmp_path)
    assert r["port"] == r["jax"]
    assert [a["ok"] for n, _, a in r["port"] if n == "publish"] == [True,
                                                                    False]
    assert r["port"][-1][2] == {"step": 3, "world": 4}


def test_collector_dumps_equal_jax(tmp_path):
    def case(pkg, d):
        life, ng, obs = pkg["life"], pkg["ng"], pkg["obs"]
        life.reset_lifecycle_stats()
        ng.consume_health()
        dumps = []
        reg = obs.MetricsRegistry()
        reg.register_collector(obs.checkpoint_collector())
        dumps.append(reg.dump())             # zero state, phase idle
        _trained(pkg, d)
        life.CheckpointPublisher(str(d)).publish(
            pkg["build"]()(["solo"]).model)
        life.set_lifecycle_phase("resume")
        dumps.append(reg.dump())
        with pytest.raises(ValueError, match="unknown lifecycle phase"):
            life.set_lifecycle_phase("reticulating")
        reg2 = obs.MetricsRegistry()
        reg2.register_collector(obs.checkpoint_collector(lambda: {
            "generation": 3, "publish_total": 2, "publish_failures": 1,
            "phase": "publish"}))
        dumps.append(reg2.dump())
        wd = pkg["Watchdog"](ng.GuardPolicy(action="skip_step",
                                            max_skips_per_window=1))
        for s, w in ((1, 0), (2, ng.NAN_GRAD), (3, ng.SPIKE)):
            wd.observe(s, w)
        wd.note_rollback(1)
        wd.observe(5, ng.INF_GRAD)
        ng.record_health(ng.NAN_GRAD, "test")
        ng.record_health(ng.OVERFLOW, "scaler")
        reg3 = obs.MetricsRegistry()
        reg3.register_collector(obs.guard_collector(wd))
        reg3.register_collector(obs.guard_collector())
        dumps.append(reg3.dump())
        ng.consume_health()
        life.reset_lifecycle_stats()
        return dumps

    r = _both(case, tmp_path)
    assert r["port"] == r["jax"]
    assert "pt_checkpoint_publish_total 1" in r["port"][1]
    assert 'pt_lifecycle_phase{phase="resume"} 1' in r["port"][1]
    assert "pt_guard_health_word 17" in r["port"][3]
    assert "pt_guard_rollbacks_total 1" in r["port"][3]


def test_elastic_is_refused_naming_its_part(tmp_path):
    with pytest.raises(NotImplementedError,
                       match="item 6's part: the store, launch and elastic"):
        TTrainer(_tbuild(), str(tmp_path), elastic=object())


def test_replay_reproduces_a_capture_of_either_package(tmp_path):
    from paddle_tpu_torch.distributed.resilience import replay

    x, y = _data_fn(0)
    x[0, 0] = np.nan
    pol = tng.GuardPolicy(action="skip_step", warmup_steps=2)
    captures = {}
    for name, ng in (("jax", jng), ("port", tng)):
        captures[name] = ng.BadBatchRecorder(str(tmp_path / name)).record(
            1, jng.NAN_GRAD | jng.NAN_LOSS, {"input_ids": x, "labels": y},
            rng_seed=7)
    build = _tbuild(pol)
    for name, d in captures.items():
        out = replay.replay(d, lambda: build(["local"]))
        assert out["reproduced"] and out["replayed"] == out["captured"]
        assert out["report"][-1] == "REPRODUCED"
    # a state-dependent replay restores the ring entry at or before it
    t, _ = _trained(PKGS["port"], tmp_path / "ring")
    eng = build(["local"])
    assert replay.restore_ring_state(eng, str(tmp_path / "ring"), 5) == 2
    assert int(eng.step_count) == 2
    clean = tng.BadBatchRecorder(str(tmp_path / "clean")).record(
        3, jng.SPIKE, dict(zip(("input_ids", "labels"), _data_fn(3))))
    out = replay.replay(clean, lambda: build(["local"]),
                        ckpt_dir=str(tmp_path / "ring"))
    assert out["restored_step"] == 2 and not out["reproduced"]
    with pytest.raises(ValueError, match="without guard="):
        replay.replay(clean, lambda: _tbuild()(["local"]))
    with open(f"{clean}/meta.json") as f:
        assert json.load(f)["codes"] == ["PT-NUM-004"]
