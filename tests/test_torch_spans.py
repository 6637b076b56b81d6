"""The port's spans (``utils/logging.py:span``) and the ``Prefetcher``'s
stamps on the CPU: a ResNet-18 BN combined step (full width, a 96x128
canvas, 1 supervised + 2 weak images, RPN 32 -> 16 proposals, 16 ROIs an
image) under a CPU-only profiler records each part of ``train_step``
nested in it, once a step (``optimizer`` twice: the moments' reset before
the backward and the update after it), and ``recompute`` once a
checkpointed block only under remat, and ``stem`` never; a VGG16 step
records ``stem`` once, inside ``trunk``; the profiler changes no loss, no
parameter, no running statistic and no moment; with no profiler on,
``span`` is one shared null context and opens no range; the stamps are one
a batch drawn, bounded, ordered and on ``time.time_ns()``'s clock, the
clock of the profiler's events."""

import copy
import time
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data import loader
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.train.engine import Engine
from wssdl_bus_tpu_torch.utils import logging as port_logging
from wssdl_bus_tpu_torch.utils.logging import SPAN_PREFIX, span

CANVAS = (96, 128)
STEPS = 2
FORWARD = ("upload", "prep", "trunk", "anchor_targets", "proposals",
           "roi_targets", "pool", "head", "losses")
BLOCKS = 8          # ResNet-18's residual blocks, one checkpoint each


def _cfg():
    return Config().with_overrides([
        "ANCHOR_SCALES", "(2, 4, 8)", "TRAIN.RPN_PRE_NMS_TOP_N", "32",
        "TRAIN.RPN_POST_NMS_TOP_N", "16", "TRAIN.BATCH_SIZE", "16"])


def _batch(seed):
    rng = np.random.RandomState(seed)
    h, w = CANVAS
    gts = np.zeros((3, 20, 5), np.float32)
    gts[0, 0] = [30, 20, 80, 60, 2]
    gts[0, 1] = [0, 0, w - 1, h - 1, 0]     # whole-image background box
    return {"data": rng.uniform(-1, 1, (3, h, w, 3)).astype(np.float32),
            "gt_boxes": gts, "num_gt_boxes": np.array([2, 0, 0], np.int32),
            "im_info": np.array([[h, w, 1, 2], [h, w, 1, 2], [h, w, 1, 1]],
                                np.float32)}


def _steps(model, remat, profiled):
    """``STEPS`` combined steps of a copy of ``model`` under ``remat``
    -> (losses, state dict, Adam's moments, the profiler's events or
    None)."""
    torch.set_num_threads(2)
    model = copy.deepcopy(model)
    model.remat = remat
    eng = Engine(model, _cfg(), CANVAS, device="cpu", seed=5)
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled else None
    losses = []
    if prof is not None:
        prof.__enter__()
    try:
        for s in range(STEPS):
            losses.append(eng.train_step(_batch(s), 1e-3, s))
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    events = None if prof is None else [
        (e.name()[len(SPAN_PREFIX):], e.start_thread_id(), e.start_ns(),
         e.end_ns()) for e in prof.profiler.kineto_results.events()
        if e.name().startswith(SPAN_PREFIX)]
    opt = eng.opt.state_dict()
    return ([torch.stack(list(x)) for x in losses],
            {k: v.clone() for k, v in eng.model.state_dict().items()},
            {k: v.clone() for k, v in opt["mu"].items()}
            | {"nu." + k: v.clone() for k, v in opt["nu"].items()}, events)


@pytest.fixture(scope="module")
def runs():
    torch.manual_seed(0)
    model = build_detector("Resnet_train", device="cpu", depth=18,
                           norm="BN")
    return {(remat, profiled): _steps(model, remat, profiled)
            for remat in (False, True) for profiled in (False, True)}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_each_part_once_a_step_nested_in_train_step(runs, remat):
    events = runs[remat, True][3]
    steps = sorted((s, e, t) for n, t, s, e in events if n == "train_step")
    assert len(steps) == STEPS
    want = dict.fromkeys(FORWARD + ("backward",), 1)
    want.update(optimizer=2, recompute=BLOCKS if remat else 0)
    for start, end, tid in steps:
        inside = [n for n, t, s, e in events
                  if start < s and e <= end and t == tid]
        assert {n: inside.count(n) for n in want} == want
        assert set(inside) <= set(want)
    # the parts follow one another in the step's order, recompute within
    # the backward
    first = [(s, e, n) for n, t, s, e in events
             if n in FORWARD + ("backward",)][:len(FORWARD) + 1]
    assert [n for *_, n in sorted(first)] == list(FORWARD) + ["backward"]
    back = [(s, e) for n, t, s, e in events if n == "backward"]
    for n, t, s, e in events:
        if n == "recompute":
            assert any(bs <= s and e <= be for bs, be in back)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_the_profiler_changes_no_number(runs, remat):
    off, on = runs[remat, False], runs[remat, True]
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a, b)
    for i in (1, 2):
        assert off[i].keys() == on[i].keys()
        for k in off[i]:
            assert torch.equal(off[i][k], on[i][k]), k


def test_stem_once_a_vgg16_step_inside_trunk_and_never_on_resnet(runs):
    for *_, events in runs.values():
        if events is not None:
            assert "stem" not in {n for n, *_ in events}
    torch.set_num_threads(2)
    torch.manual_seed(0)
    eng = Engine(build_detector("VGGnet_train", device="cpu"), _cfg(),
                 CANVAS, device="cpu", seed=5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.train_step(_batch(0), 1e-3, 0)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(SPAN_PREFIX):
            ranges.setdefault(e.name()[len(SPAN_PREFIX):], []).append(
                (e.start_ns(), e.end_ns()))
    assert len(ranges["stem"]) == 1
    (s0, s1), ((t0, t1),) = ranges["stem"][0], ranges["trunk"]
    assert t0 <= s0 <= s1 <= t1


def test_span_without_a_profiler_is_one_null_context():
    with mock.patch.object(port_logging, "_RecordFunctionFast",
                           side_effect=AssertionError("a range opened")):
        a, b = span("trunk"), span("head")
        with a:
            pass
    assert a is b
    assert type(a).__name__ == "nullcontext"


def test_span_under_a_profiler_opens_a_named_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert span("trunk") is not span("trunk")
        with span("trunk"):
            torch.ones(2)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count(SPAN_PREFIX + "trunk") == 1


class _Layer:
    """A data layer whose every batch takes ``delay`` seconds."""

    def __init__(self, delay=0.0):
        self.delay, self.calls = delay, 0

    def forward(self):
        time.sleep(self.delay)
        self.calls += 1
        return {"n": self.calls}

    def close(self):
        pass


def test_prefetcher_stamps_one_a_batch_ordered_and_bounded():
    before = time.time_ns()
    layer = _Layer()
    pf = loader.Prefetcher(layer, depth=2)
    for _ in range(loader.WINDOW + 7):
        pf.forward()
    pf.close()
    after = time.time_ns()
    stamps = list(pf.stamps)
    assert layer.calls >= loader.WINDOW + 7
    assert len(stamps) == loader.WINDOW     # the newest WINDOW of them
    assert all(before <= s <= e <= after for s, e in stamps)
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(stamps, stamps[1:]))

    layer = _Layer(0.01)
    pf = loader.Prefetcher(layer, depth=2)
    for _ in range(3):
        pf.forward()
    pf.close()
    assert len(pf.stamps) == layer.calls
    assert all(e - s >= 1e7 for s, e in pf.stamps)


def test_prefetcher_stamps_share_the_profilers_clock():
    """A stamp and a range opened right after it lie within a few ms on
    the profiler's clock; a consumed batch was stamped before the wait for
    it ended."""
    layer = _Layer(0.02)
    pf = loader.Prefetcher(layer, depth=1)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            stamp = time.time_ns()
            with span("clock"):
                pass
            got = pf.forward()
    finally:
        pf.close()
    ev = {e.name()[len(SPAN_PREFIX):]: (e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events()
          if e.name().startswith(SPAN_PREFIX)}
    assert 0 <= ev["clock"][0] - stamp < 50_000_000
    drawn = list(pf.stamps)[got["n"] - 1]
    assert drawn[1] <= ev["feed_wait"][1]

