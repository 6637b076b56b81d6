"""The port's LR schedules (``train/schedules.py``) against the JAX
package's: const, piecewise-constant and reduce-on-plateau fed the same
sequences of test losses give the same learning rate at every step,
exactly, and a ``state_dict`` round trip continues the sequence."""

import numpy as np
import pytest

from wssdl_bus_tpu.train import schedules as jax_schedules
from wssdl_bus_tpu_torch.train import schedules

MAX_ITERS = 1000


def _losses(kind):
    rng = np.random.RandomState(len(kind))
    if kind == "plateau":       # improves, then stalls: rop halves twice
        return [10.0, 9.0, 8.5] + [8.5 + 1e-4 * k for k in range(20)]
    if kind == "noisy":
        return list(5.0 + rng.standard_normal(40) * 0.5)
    return list(np.linspace(4.0, 1.0, 30))     # steadily improving


@pytest.mark.parametrize("kind", ["plateau", "noisy", "improving"])
@pytest.mark.parametrize("name", ["const", "pc", "rop"])
def test_schedule_matches_jax(name, kind):
    got = schedules.build_schedule(name, 0.01, MAX_ITERS)
    want = jax_schedules.build_schedule(name, 0.01, MAX_ITERS)
    if name == "rop":
        got.verbose = want.verbose = False
    logs_g, logs_w = [], []
    step = 0
    for loss in _losses(kind):
        for _ in range(40):
            assert got(step) == want(step), (step, got(step), want(step))
            step += 1
        logs_g.append(loss)
        logs_w.append(loss)
        got.on_val_end(logs_g)
        want.on_val_end(logs_w)
        assert got.state_dict() == want.state_dict()
    assert got(step) == want(step)
    if name == "rop" and kind == "plateau":
        assert got(step) <= 0.01 * 0.25     # halved at least twice
    if name == "pc":
        assert got(750) == 0.01 and got(751) == 0.01 * 0.1


@pytest.mark.parametrize("name", ["const", "pc", "rop"])
def test_state_dict_round_trip(name):
    a = schedules.build_schedule(name, 0.02, MAX_ITERS)
    logs = [3.0, 2.0] + [2.0] * 7
    if name == "rop":
        a.verbose = False
    for k in range(1, len(logs) + 1):
        a.on_val_end(logs[:k])
    b = schedules.build_schedule(name, 0.02, MAX_ITERS)
    b.load_state_dict(a.state_dict())
    assert b.state_dict() == a.state_dict()
    for k in range(5):
        logs.append(2.0 - 0.5 * k)
        a.on_val_end(logs)
        b.on_val_end(logs)
        assert a(900 + k) == b(900 + k)
    with pytest.raises(NotImplementedError):
        schedules.build_schedule("cosine", 0.1, 10)
