"""CPU tests of ``hbench/program_trace.py``, the reduction of a trace to
the port's parts of a step (run from the repository's root: ``python -m
pytest h100_bench -q``).

A hand-built trace of two steps, each 100 ms: ranges on the main thread
and a recompute on autograd's, runtime calls with correlation ids on
both, a sync in the trunk, one in the optimizer and one outside the step,
a launch with no runtime call, and idle stretches inside and outside the
steps.  Every number of :meth:`ProgramTrace.parts` and of
:func:`readings` is computed by hand below."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from hbench import program_trace as PT  # noqa: E402

MS = 1_000_000
MAIN, AUTOGRAD = 1, 2


def _step(t):
    """One step's (ops, calls, spans) from ``t`` ms on."""
    def at(*x):
        return [t * MS + int(v * MS) for v in x]

    spans = [("feed_wait", MAIN, *at(2, 8)), ("train_step", MAIN, *at(10, 90)),
             ("upload", MAIN, *at(10, 20)), ("trunk", MAIN, *at(20, 40)),
             ("backward", MAIN, *at(40, 70)),
             ("recompute", AUTOGRAD, *at(45, 55)),
             ("optimizer", MAIN, *at(70, 85))]
    c = t * 10      # correlation ids of this step
    calls = [("cudaLaunchKernel", MAIN, *at(5, 5.5), c + 7),
             ("cudaMemcpyAsync", MAIN, *at(12, 12.5), c + 1),
             ("cudaLaunchKernel", MAIN, *at(25, 25.5), c + 2),
             ("cudaLaunchKernel", MAIN, *at(30, 30.5), c + 3),
             ("cudaStreamSynchronize", MAIN, *at(35, 36), 0),
             ("cudaLaunchKernel", AUTOGRAD, *at(50, 50.5), c + 4),
             ("cudaLaunchKernel", AUTOGRAD, *at(60, 60.5), c + 5),
             ("cudaLaunchKernel", MAIN, *at(75, 75.5), c + 6),
             ("cudaFree", MAIN, *at(80, 81), 0),
             ("cudaStreamSynchronize", MAIN, *at(95, 96), 0)]
    ops = [("k_feed", *at(6, 7), c + 7), ("Memcpy HtoD", *at(13, 15), c + 1),
           ("conv", *at(26, 45), c + 2), ("norm", *at(45, 50), c + 3),
           ("conv_recompute", *at(51, 58), c + 4),
           ("conv_grad", *at(61, 64), c + 5), ("adam", *at(76, 80), c + 6),
           ("lost", *at(90, 92), c + 9)]
    return ops, calls, spans


@pytest.fixture(scope="module")
def trace():
    ops, calls, spans = [], [], []
    for t in (0, 100):
        o, c, s = _step(t)
        ops += o
        calls += c
        spans += s
    return PT.ProgramTrace(ops, calls, spans, (0, 200 * MS))


# each step by hand: busy [6,7] [13,15] [26,50] [51,58] [61,64] [76,80]
# [90,92] = 43 ms of 100; idle [0,6] [7,13] [15,26] [50,51] [58,61] [64,76]
# [80,90] [92,100]: outside 6 + 1 + 2 + 8, upload 3 + 5, trunk 6, recompute
# 1 (the main thread in the backward, autograd's in a recompute), backward
# 3 + 6, optimizer 6 + 5, train_step's own 5
WANT = {"train_step": dict(host_ms=5, device_ms=0, launches=0, syncs=0,
                           idle_ms=5),
        "upload": dict(host_ms=10, device_ms=2, launches=1, syncs=0,
                       idle_ms=8),
        "trunk": dict(host_ms=20, device_ms=24, launches=2, syncs=1,
                      idle_ms=6),
        "backward": dict(host_ms=30, device_ms=3, launches=1, syncs=0,
                         idle_ms=9),
        "recompute": dict(host_ms=10, device_ms=7, launches=1, syncs=0,
                          idle_ms=1),
        "optimizer": dict(host_ms=15, device_ms=4, launches=1, syncs=1,
                          idle_ms=11)}


def _close(got, want):
    assert set(got) == set(want)
    for part, fields in want.items():
        for k, v in fields.items():
            assert got[part][k] == pytest.approx(v, abs=1e-9), (part, k)


def test_parts_by_hand(trace):
    parts = trace.parts()
    assert len(parts["steps"]) == 2
    for step in parts["steps"]:
        _close(step, WANT)
    # outside the steps: the feed's launch, the sync after the step and
    # the idle stretches of the loop, over both steps
    _close({"outside": parts["outside"]},
           {"outside": dict(host_ms=0, device_ms=2, launches=2, syncs=2,
                            idle_ms=34)})
    _close({"unlinked": parts["unlinked"]},
           {"unlinked": dict(host_ms=0, device_ms=4, launches=2, syncs=0,
                             idle_ms=0)})


def test_parts_and_outside_add_up_to_the_windows_idle(trace):
    parts = trace.parts()
    idle = sum(v["idle_ms"] for s in parts["steps"] for v in s.values())
    idle += parts["outside"]["idle_ms"]
    window_ms = (trace.window[1] - trace.window[0]) * 1e-6
    assert trace.busy_ns() == 2 * 43 * MS
    assert idle == pytest.approx(window_ms - trace.busy_ns() * 1e-6)
    assert sum(e - s for s, e in trace.idle()) == 2 * 57 * MS


def test_readings_by_hand(trace):
    stamps = [(-5 * MS, 3 * MS), (20 * MS, 32 * MS), (50 * MS, 90 * MS),
              (195 * MS, 205 * MS)]
    got = PT.readings(trace.parts(), stamps, trace.window)
    assert got == pytest.approx({
        "step_launches.train": 6, "step_syncs.train": 2,
        "idle_forward_ms.train": 14, "idle_backward_ms.train": 10,
        "idle_optimizer_ms.train": 11, "recompute_device_ms.train": 7,
        "feed_assemble_ms.train": 26})


def test_readings_of_a_trace_without_program_ranges_are_none():
    """A program without spans (an older port) reads nothing and raises
    nothing."""
    ops, calls, _ = _step(0)
    tr = PT.ProgramTrace(ops, calls, [], (0, 100 * MS))
    parts = tr.parts()
    assert parts["steps"] == []
    assert parts["outside"]["idle_ms"] == pytest.approx(57)
    assert set(PT.readings(parts).values()) == {None}


class _Event:
    def __init__(self, name, device, start, dur, tid=MAIN, corr=0,
                 user=False):
        self._v = dict(name=name, device=device, start=start, dur=dur,
                       tid=tid, corr=corr, user=user)

    def name(self):
        return self._v["name"]

    def device_type(self):
        return self._v["device"]

    def start_ns(self):
        return self._v["start"]

    def duration_ns(self):
        return self._v["dur"]

    def start_thread_id(self):
        return self._v["tid"]

    def correlation_id(self):
        return self._v["corr"]

    def is_user_annotation(self):
        return self._v["user"]


def test_collect_keeps_ranges_calls_and_device_work_only():
    """A ``wssdl::`` or ``bench::`` range mirrored on the device's timeline
    counts in neither ``ops`` nor the busy time; the program's ranges lose
    their prefix; runtime calls keep thread and correlation id."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _Event("wssdl::train_step", cpu, 0, 50 * MS),
        _Event("wssdl::train_step", cuda, 0, 50 * MS),
        _Event("bench::train_step", cuda, 0, 50 * MS),
        _Event("bench::train_step", cpu, 0, 50 * MS, user=True),
        _Event("aten::add", cpu, 1 * MS, 1 * MS, corr=3),
        _Event("cudaLaunchKernel", cpu, 1 * MS, MS // 2, tid=AUTOGRAD,
               corr=11),
        _Event("add_kernel", cuda, 2 * MS, 3 * MS, corr=11)]
    tr = PT.collect(events, (0, 50 * MS))
    assert tr.ops == [("add_kernel", 2 * MS, 5 * MS, 11)]
    assert tr.spans == [("train_step", MAIN, 0, 50 * MS)]
    assert tr.calls == [("cudaLaunchKernel", AUTOGRAD, MS, 3 * MS // 2, 11)]
    assert tr.busy_ns() == 3 * MS
    # autograd's launch outside any range of its own: the main thread's
    step = tr.parts()["steps"][0]
    assert step["train_step"]["launches"] == 1
    assert step["train_step"]["idle_ms"] == pytest.approx(47)
