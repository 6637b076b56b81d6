"""Reduction of a ``torch.profiler`` trace of the card to what the
per-layer readers need: every device operation (kernel, copy, set) with
its name and time, the union of their intervals (busy seconds), the idle
gaps between them, and the benchmark's own host spans (``bench::*``
``record_function`` ranges) that say what the host did during a gap."""

from __future__ import annotations

import contextlib
import time

import torch

SPAN_PREFIX = "bench::"


class Trace:
    """The reduced trace: ``ops`` [(name, start_s, dur_s)] on the device,
    ``spans`` [(name, start_s, end_s)] on the host, ``window_s`` the
    traced window's length by the host's clock, ``busy_s`` the union of
    the device intervals."""

    def __init__(self, ops, spans, window_s):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.spans = spans
        self.window_s = window_s
        merged = []
        for _, s, d in self.ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], s + d)
            else:
                merged.append([s, s + d])
        self.intervals = merged
        self.busy_s = sum(e - s for s, e in merged)

    def kernel_seconds(self, *needles) -> tuple:
        """(launches, seconds) of the device operations whose name holds
        any of ``needles``."""
        hits = [d for n, _, d in self.ops if any(k in n for k in needles)]
        return len(hits), sum(hits)

    def top_ops(self, k: int = 10):
        by = {}
        for n, _, d in self.ops:
            by[n] = by.get(n, 0.0) + d
        return sorted(by.items(), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The ``k`` longest gaps between device intervals, each named by
        the innermost benchmark span that covers its start."""
        gaps = [(s1, s0 - s1) for (_, s1), (s0, _) in
                zip(self.intervals, self.intervals[1:])]
        out = []
        for start, length in sorted(gaps, key=lambda g: -g[1])[:k]:
            cover = [sp for sp in self.spans if sp[1] <= start < sp[2]]
            name = (min(cover, key=lambda sp: sp[2] - sp[1])[0] if cover
                    else "host")
            out.append((name, length))
        return out


@contextlib.contextmanager
def traced(record):
    """Trace the card and the host while the block runs; ``record`` (a
    list) receives one :class:`Trace` afterwards.  The block should end
    with the device synchronised."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        if e.name().startswith(SPAN_PREFIX):
            # a host span is mirrored on the device's timeline as an
            # annotation: it is no device operation
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append((e.name(), start, start + dur))
        elif e.device_type() == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation():
            ops.append((e.name(), start, dur))
    record.append(Trace(ops, spans, window))


def span(name: str):
    """A host span the trace keeps (a ``record_function`` range)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)
