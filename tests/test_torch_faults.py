"""The port's fault plan (``paddle_tpu_torch.distributed.resilience.
faults``) against the JAX package's, and the port's StepWatchdog.

The same specs over the same event stream must fire at the same events in
both packages: the due specs of every event, ``plan.log``, ``fired()``, the
seeded draws of ``ComposedFaultPlan``'s per-spec streams and the sums of
``resource_hold`` / ``device_loss``. The two packages install their plans
independently. Host-only: no model, no engine.
"""

import random
import time
import warnings

import pytest

from paddle_tpu.distributed.resilience import faults as jfaults
from paddle_tpu_torch.distributed.resilience import (ComposedFaultPlan,
                                                     FaultInjected, FaultPlan,
                                                     FaultSpec, StepWatchdog,
                                                     active_plan, device_loss,
                                                     maybe_inject,
                                                     resource_hold)
from paddle_tpu_torch.distributed.resilience import faults as tfaults

SITES = ("serving.step", "serving.stall", "serving.block_pool",
         "device.loss", "fleet.replica_kill", "fleet.drain")


def _events(seed, n=400):
    """A seeded stream of (site, detail) events as the engine, the
    supervisor and the fleet router emit them."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        site = rng.choice(SITES)
        if site.startswith("fleet."):
            detail = f"replica:{rng.randrange(3)}:step:{i}"
        elif site == "serving.block_pool":
            detail = f"rid:{rng.randrange(1, 40)}"
        else:
            detail = f"step:{i}"
        out.append((site, detail))
    return out


SPEC_SETS = {
    "kill_at": [("serving.step", "kill", 3, 1, 0.0, "")],
    "match_replica": [("fleet.replica_kill", "kill", 2, 2, 0.0,
                       "replica:1:"),
                      ("fleet.drain", "kill", 0, 1, 0.0, "replica:2:")],
    "every_from_at": [("serving.stall", "delay", 5, -1, 0.0, ""),
                      ("serving.step", "error", 1, 3, 0.0, "")],
    "exhaust_and_lose": [("serving.block_pool", "exhaust", 1, 4, 7.0, ""),
                         ("serving.block_pool", "exhaust", 2, -1, 3.0,
                          "rid:1"),
                         ("device.loss", "lose", 0, 2, 2.0, ""),
                         ("device.loss", "kill", 0, 1, 0.0, "")],
    "mixed": [("serving.step", "kill", 7, 1, 0.0, ""),
              ("serving.stall", "stall", 2, 1, 0.0, ""),
              ("fleet.replica_kill", "kill", 4, -1, 0.0, "replica:0:"),
              ("serving.block_pool", "exhaust", 0, 2, 5.0, "rid:3"),
              ("checkpoint.shard", "bitflip", 0, 1, 4.0, "")],
}


def _plans(cls_name, specs, seed=7):
    jspecs = [jfaults.FaultSpec(*s) for s in specs]
    tspecs = [FaultSpec(*s) for s in specs]
    return (getattr(jfaults, cls_name)(seed=seed, specs=jspecs),
            getattr(tfaults, cls_name)(seed=seed, specs=tspecs))


def _key(spec):
    return (spec.site, spec.action, spec.at, spec.count, spec.arg,
            spec.match)


@pytest.mark.parametrize("cls_name", ["FaultPlan", "ComposedFaultPlan"])
@pytest.mark.parametrize("name", sorted(SPEC_SETS))
def test_fire_log_and_fired_equal_jax(name, cls_name):
    jp, tp = _plans(cls_name, SPEC_SETS[name])
    for site, detail in _events(sorted(SPEC_SETS).index(name)):
        assert [_key(s) for s in tp.fire(site, detail)] == \
            [_key(s) for s in jp.fire(site, detail)]
    assert tp.log == jp.log
    assert tp.fired() == jp.fired()
    assert tp._counts == jp._counts


def test_fire_counters_match_and_count():
    plan = FaultPlan(specs=[
        FaultSpec("fleet.replica_kill", "kill", at=1, count=2,
                  match="replica:1:"),
        FaultSpec("serving.step", "error", at=2, count=-1)])
    due = [plan.fire("fleet.replica_kill", f"replica:{i % 2}:step:{i}")
           for i in range(8)]
    # only replica 1's events count; its 2nd and 3rd fire
    assert [i for i, d in enumerate(due) if d] == [3, 5]
    assert plan._counts[0] == 4
    hits = [bool(plan.fire("serving.step", f"step:{i}")) for i in range(6)]
    assert hits == [False, False, True, True, True, True]    # count=-1
    assert plan.fired() == {"fleet.replica_kill": 2, "serving.step": 4}
    assert plan.log[0] == ("fleet.replica_kill", "replica:1:step:3", "kill")


def test_fault_spec_validation_equals_jax():
    for action in ("kill", "stall", "delay", "error", "bitflip", "truncate",
                   "garbage", "nan_grad", "loss_spike", "poison_batch",
                   "exhaust", "drop", "duplicate", "torn", "blackhole",
                   "lose"):
        assert FaultSpec("x", action).action == \
            jfaults.FaultSpec("x", action).action
    for bad in ("explode", "", "Kill"):
        with pytest.raises(ValueError, match="unknown fault action"):
            FaultSpec("serving.step", bad)
        with pytest.raises(ValueError, match="unknown fault action"):
            jfaults.FaultSpec("serving.step", bad)


def test_composed_plan_per_spec_streams_equal_jax():
    specs = SPEC_SETS["mixed"]
    jp, tp = _plans("ComposedFaultPlan", specs, seed=11)
    assert isinstance(tp, ComposedFaultPlan)
    for js, ts in zip(jp.specs, tp.specs):
        jr, tr = jp.rng_for(js), tp.rng_for(ts)
        assert [tr.random() for _ in range(16)] == \
            [jr.random() for _ in range(16)]
        assert [tr.randrange(1 << 20) for _ in range(8)] == \
            [jr.randrange(1 << 20) for _ in range(8)]
    # the plain plan shares one seeded stream across its specs
    jp, tp = _plans("FaultPlan", specs, seed=11)
    assert tp.rng_for(tp.specs[0]) is tp.rng_for(tp.specs[1])
    assert [tp.rng.getrandbits(32) for _ in range(8)] == \
        [jp.rng.getrandbits(32) for _ in range(8)]


def test_resource_hold_and_device_loss_sums_equal_jax():
    jp, tp = _plans("FaultPlan", SPEC_SETS["exhaust_and_lose"])
    got, want = [], []
    for site, detail in _events(3):
        if site == "serving.block_pool":
            with tp:
                got.append(resource_hold(site, detail))
            with jp:
                want.append(jfaults.resource_hold(site, detail))
        elif site == "device.loss":
            with tp:
                got.append(device_loss(detail))
            with jp:
                want.append(jfaults.device_loss(detail))
    assert got == want and sum(got) > 0
    assert tp.log == jp.log
    # no plan: the hooks are no-ops
    assert resource_hold("serving.block_pool", "rid:1") == 0
    assert device_loss("step:1") == 0


def test_maybe_inject_actions():
    plan = FaultPlan(specs=[
        FaultSpec("serving.step", "kill", at=0, count=1),
        FaultSpec("serving.step", "error", at=1, count=1),
        FaultSpec("serving.stall", "stall", at=0, count=1, arg=0.05),
        FaultSpec("serving.step", "exhaust", at=2, count=1)])
    with plan:
        with pytest.raises(FaultInjected, match="serving.step"):
            maybe_inject("serving.step", "step:1")
        assert isinstance(FaultInjected("x"), ConnectionError)
        with pytest.raises(RuntimeError, match="error at serving.step"):
            maybe_inject("serving.step", "step:2")
        maybe_inject("serving.step", "step:3")   # data action: ignored
        t0 = time.monotonic()
        maybe_inject("serving.stall", "step:1")
        assert time.monotonic() - t0 >= 0.05
    maybe_inject("serving.step", "step:4")       # uninstalled: no-op
    assert plan.fired() == {"serving.step": 3, "serving.stall": 1}


def test_plans_install_independently_of_the_jax_package():
    tp = FaultPlan(specs=[FaultSpec("serving.step", "kill")])
    jp = jfaults.FaultPlan(specs=[jfaults.FaultSpec("serving.step", "kill")])
    with tp:
        assert active_plan() is tp and jfaults.active_plan() is None
        jfaults.maybe_inject("serving.step", "step:1")    # JAX: no plan
        with jp:
            assert jfaults.active_plan() is jp and active_plan() is tp
        assert jfaults.active_plan() is None
    assert active_plan() is None
    assert tp.log == [] and jp.log == []


class TestStepWatchdog:
    def test_overrun_flagged_mid_hang_then_on_disarm(self):
        wd = StepWatchdog(0.05)
        try:
            with pytest.warns(RuntimeWarning, match="PT-SRV-002"):
                wd.arm("step:1")
                time.sleep(0.2)
                assert wd.fired              # flagged while still stuck
            assert wd.disarm() is True
            assert len(wd.overruns) == 1 and wd.overruns[0][0] == "step:1"
        finally:
            wd.close()

    def test_under_budget_clean_and_rearmable(self):
        wd = StepWatchdog(5.0)
        try:
            wd.arm("a")
            assert wd.disarm() is False
            wd.arm("b")
            assert wd.disarm() is False and not wd.overruns
            assert wd.disarm() is False          # not armed
        finally:
            wd.close()

    def test_disarm_accounts_an_overrun_the_thread_missed(self):
        wd = StepWatchdog(0.01)
        try:
            wd.close()                           # the watcher is gone
            wd.arm("late")
            time.sleep(0.03)
            with warnings.catch_warnings():
                warnings.simplefilter("error")   # nothing warns here
                assert wd.disarm() is True
            assert wd.overruns[0][0] == "late"
        finally:
            wd.close()
