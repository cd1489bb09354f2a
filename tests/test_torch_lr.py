"""Port LR schedulers (paddle_tpu_torch.optimizer.lr) against the JAX
package's: the arithmetic is the same host-side Python, so every
``last_lr`` sequence must be float-equal (tolerance 0), over 60 steps, for
each of the seventeen schedulers; ``ReduceOnPlateau`` over a metric
sequence; ``state_dict`` carried across both ways and stepped on."""

import math

import pytest

import paddle_tpu.optimizer.lr as J
import paddle_tpu_torch.optimizer.lr as T

STEPS = 60

SCHEDULERS = {
    "NoamDecay": lambda L: L.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda L: L.PiecewiseDecay([10, 25, 40],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda L: L.NaturalExpDecay(0.1, gamma=0.07),
    "InverseTimeDecay": lambda L: L.InverseTimeDecay(0.1, gamma=0.3),
    "PolynomialDecay": lambda L: L.PolynomialDecay(0.1, decay_steps=20,
                                                   power=2.0),
    "PolynomialDecay_cycle": lambda L: L.PolynomialDecay(
        0.1, decay_steps=15, end_lr=0.001, power=0.5, cycle=True),
    "LinearWarmup": lambda L: L.LinearWarmup(0.1, warmup_steps=10,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmup_cosine": lambda L: L.LinearWarmup(
        L.CosineAnnealingDecay(3e-4, T_max=30), warmup_steps=8,
        start_lr=0.0, end_lr=3e-4),
    "ExponentialDecay": lambda L: L.ExponentialDecay(0.1, gamma=0.93),
    "MultiStepDecay": lambda L: L.MultiStepDecay(0.1, milestones=[7, 19, 33],
                                                 gamma=0.3),
    "StepDecay": lambda L: L.StepDecay(0.1, step_size=9, gamma=0.5),
    "LambdaDecay": lambda L: L.LambdaDecay(0.1, lambda e: 0.97 ** e),
    "MultiplicativeDecay": lambda L: L.MultiplicativeDecay(
        0.1, lambda e: 0.95 if e % 2 else 0.99),
    "CosineAnnealingDecay": lambda L: L.CosineAnnealingDecay(
        0.1, T_max=17, eta_min=1e-4),
    "CosineAnnealingWarmRestarts": lambda L: L.CosineAnnealingWarmRestarts(
        0.1, T_0=7, T_mult=2, eta_min=1e-4),
    "OneCycleLR": lambda L: L.OneCycleLR(0.1, total_steps=50),
    "OneCycleLR_linear": lambda L: L.OneCycleLR(
        0.1, total_steps=40, anneal_strategy="linear", phase_pct=0.25),
    "CyclicLR": lambda L: L.CyclicLR(0.01, 0.1, step_size_up=6,
                                     step_size_down=9),
    "CyclicLR_triangular2": lambda L: L.CyclicLR(0.01, 0.1, step_size_up=5,
                                                 mode="triangular2"),
    "CyclicLR_exp_range": lambda L: L.CyclicLR(0.01, 0.1, step_size_up=5,
                                               mode="exp_range",
                                               exp_gamma=0.98),
    "CyclicLR_scale_fn": lambda L: L.CyclicLR(
        0.01, 0.1, step_size_up=4, scale_fn=lambda c: 1 / c,
        scale_mode="cycle"),
    "LinearLR": lambda L: L.LinearLR(0.1, total_steps=25),
}


def _run(sched, steps=STEPS):
    out = [sched()]
    for _ in range(steps):
        sched.step()
        out.append(sched.last_lr)
    return out


def test_every_scheduler_class_is_ported():
    names = {n for n, v in vars(J).items()
             if isinstance(v, type) and issubclass(v, J.LRScheduler)}
    assert len(names) == 18   # the base and seventeen schedulers
    assert names <= set(vars(T))
    covered = {type(make(J)).__name__ for make in SCHEDULERS.values()}
    assert covered | {"LRScheduler", "ReduceOnPlateau"} == names


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_last_lr_sequence_is_float_equal_to_jax(name):
    ref = _run(SCHEDULERS[name](J))
    got = _run(SCHEDULERS[name](T))
    assert got == ref
    assert all(math.isfinite(v) for v in got)


@pytest.mark.parametrize("mode,threshold_mode", [("min", "rel"),
                                                 ("max", "abs")])
def test_reduce_on_plateau_over_a_metric_sequence(mode, threshold_mode):
    metrics = [1.0, 0.9, 0.95, 0.91, 0.92, 0.93, 0.5, 0.6, 0.6, 0.7, 0.4,
               0.41, 0.42, 0.43, 0.44, 0.45, 0.46, 0.3, 0.31, 0.32]
    seqs = []
    for L in (J, T):
        s = L.ReduceOnPlateau(0.1, mode=mode, factor=0.5, patience=2,
                              threshold=0.01, threshold_mode=threshold_mode,
                              cooldown=1, min_lr=0.006)
        seq = []
        for m in metrics:
            s.step(m)
            seq.append(s.last_lr)
        s.step()        # no metric: the rate holds
        seq.append((s.last_lr, s.last_epoch))
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert len(set(seqs[1][:-1])) > 1   # the rate did drop


@pytest.mark.parametrize("name", ["CosineAnnealingWarmRestarts",
                                  "CyclicLR", "MultiStepDecay",
                                  "OneCycleLR"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dict_round_trips_both_ways(name, direction):
    """One side steps 13 times; its state_dict goes into a fresh scheduler
    of the other package; both go on for 20 steps, float-equal. (A
    ``LinearWarmup``'s inner scheduler is an object, which neither
    package's ``state_dict`` keeps.)"""
    src_mod, dst_mod = (J, T) if direction == "jax_to_port" else (T, J)
    src = SCHEDULERS[name](src_mod)
    _run(src, 13)
    state = src.state_dict()
    dst = SCHEDULERS[name](dst_mod)
    dst.set_state_dict(dict(state))
    assert dst.state_dict() == state
    assert _run(dst, 20) == _run(src, 20)
