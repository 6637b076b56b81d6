"""The port's own spans on the card's timeline: for each part of a
training step (the ``wssdl::`` ranges of the port's
``utils/logging.py:span``) its host time, the device time and launches of
the work it launched, the host syncs it made and the idle card time it
left; and the ``Prefetcher``'s stamps of each batch's assembly.

``step_parts.py`` traces a cell's steps with :func:`traced` and prints
:meth:`ProgramTrace.parts` and :func:`readings`.  A run (``run.py``) does
not: its trace (``trace.py``) keeps neither the program's ranges nor the
runtime calls, so no metric of ``BENCHMARK.json`` reads these yet.

What belongs to a part, on the profiler's clock (epoch nanoseconds, the
clock of ``time.time_ns()``):

* a device operation (kernel, copy, set), its time and its launch: to the
  innermost range open on the launching thread when its runtime call was
  made (the two share a correlation id); where that thread had none open
  (autograd's, outside a recompute), to the innermost range of the main
  thread (the thread of the ``train_step`` ranges) at that moment;
* a sync (a runtime call that blocks the host, ``SYNCS``): the same;
* idle card time (the window less the union of the device operations): to
  the innermost range of the main thread open then, or to the innermost
  range of another thread opened within it (a recompute in the backward);
* host time: a range's length less its children's on its own thread.

What lies outside every ``train_step`` range is ``outside``: the
benchmark's own loop (the feed's wait, the draws, events).
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time

SPAN_PREFIX = "wssdl::"
MIRRORS = (SPAN_PREFIX, "bench::")   # host ranges, not device work
STEP = "train_step"
FORWARD = ("upload", "prep", "trunk", "anchor_targets", "proposals",
           "roi_targets", "pool", "head", "losses")
BACKWARD = ("backward", "recompute")
OPTIMIZER = ("optimizer",)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaFree")
RUNTIME = re.compile(r"cu(da)?[A-Z]")   # cudaLaunchKernel, cuLaunchKernel
FIELDS = ("host_ms", "device_ms", "launches", "syncs", "idle_ms")


class _Nest:
    """The innermost of some nested ranges [(name, tid, start, end)] at any
    moment: the ranges' ends cut the time line into pieces, each with one
    innermost range (the latest started) or None."""

    def __init__(self, spans):
        self.bounds = sorted({t for sp in spans for t in sp[2:]})
        self.inner = []
        for a in self.bounds[:-1]:
            cover = [sp for sp in spans if sp[2] <= a < sp[3]]
            self.inner.append(max(cover, key=lambda sp: (sp[2], -sp[3]))
                              if cover else None)

    def at(self, t):
        i = bisect.bisect_right(self.bounds, t) - 1
        return self.inner[i] if 0 <= i < len(self.inner) else None


def zeros():
    """One part's numbers, all nought."""
    return dict.fromkeys(FIELDS, 0.0) | {"launches": 0, "syncs": 0}


class ProgramTrace:
    """The program's part of a trace, in nanoseconds on the profiler's
    clock: ``ops`` [(name, start, end, correlation)] on the device,
    ``calls`` [(name, tid, start, end, correlation)] of the CUDA runtime,
    ``spans`` [(name, tid, start, end)] of the program (the prefix
    dropped), ``window`` (start, end)."""

    def __init__(self, ops, calls, spans, window):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.calls, self.window = calls, window
        self.spans = sorted(spans, key=lambda sp: (sp[2], -sp[3]))
        steps = [sp for sp in self.spans if sp[0] == STEP]
        self.main = steps[0][1] if steps else None
        self.steps = [sp for sp in steps if sp[1] == self.main]
        self._starts = [sp[2] for sp in self.steps]
        by_tid = {}
        for sp in self.spans:
            by_tid.setdefault(sp[1], []).append(sp)
        self._by_tid = by_tid
        self._nests = {tid: _Nest(s) for tid, s in by_tid.items()}

    # -------------------------------------------------------------- #
    def busy_ns(self) -> int:
        """The union of the device operations within the window."""
        w0, w1 = self.window
        busy, end = 0, w0
        for _, s, e, _ in self.ops:
            s, e = max(s, end), min(e, w1)
            if e > s:
                busy += e - s
                end = e
        return busy

    def idle(self):
        """The stretches [(start, end)] of the window with no device
        operation running."""
        w0, w1 = self.window
        out, end = [], w0
        for _, s, e, _ in self.ops:
            if s > end and end < w1:
                out.append((end, min(s, w1)))
            end = max(end, e)
        if end < w1:
            out.append((end, w1))
        return out

    def step_of(self, t):
        """The index of the ``train_step`` range open at ``t``, or None."""
        i = bisect.bisect_right(self._starts, t) - 1
        return i if i >= 0 and t < self.steps[i][3] else None

    def owner(self, tid, t):
        """The range a launch or call at ``t`` on thread ``tid`` belongs
        to: the innermost open on ``tid``, else the main thread's."""
        nest = self._nests.get(tid)
        sp = nest.at(t) if nest is not None else None
        if sp is None and tid != self.main and self.main is not None:
            sp = self._nests[self.main].at(t)
        return sp

    def _idle_owner(self, t):
        if self.main is None:
            return None
        sp = self._nests[self.main].at(t)
        if sp is None:
            return None
        for tid, nest in self._nests.items():
            other = nest.at(t) if tid != self.main else None
            if other is not None and other[2] >= sp[2]:
                sp = max(sp, other, key=lambda x: x[2])
        return sp

    # -------------------------------------------------------------- #
    def parts(self) -> dict:
        """-> {"steps": for each ``train_step`` range in order, {part:
        {"host_ms", "device_ms", "launches", "syncs", "idle_ms"}};
        "outside": those numbers (host time aside) for what lies outside
        every step; "unlinked": the device operations whose runtime call
        the trace lacks}."""
        steps = [{} for _ in self.steps]
        outside, unlinked = zeros(), zeros()

        def bucket(sp, t):
            i = None if sp is None else self.step_of(t)
            if i is None:
                return outside
            return steps[i].setdefault(sp[0], zeros())

        for tid, spans in self._by_tid.items():      # host: own time
            stack, child = [], {}
            for sp in spans:
                while stack and stack[-1][3] <= sp[2]:
                    stack.pop()
                if stack:
                    child[stack[-1]] = child.get(stack[-1], 0) + \
                        sp[3] - sp[2]
                stack.append(sp)
            for sp in spans:
                i = self.step_of(sp[2])
                if i is not None:
                    b = steps[i].setdefault(sp[0], zeros())
                    b["host_ms"] += (sp[3] - sp[2] - child.get(sp, 0)) * 1e-6

        launch = {c[4]: c for c in self.calls if c[4]}
        for _, s, e, corr in self.ops:                # device, launches
            call = launch.get(corr)
            if call is None:
                b = unlinked
            else:
                b = bucket(self.owner(call[1], call[2]), call[2])
            b["device_ms"] += (e - s) * 1e-6
            b["launches"] += 1
        for name, tid, s, _, _ in self.calls:         # syncs
            if name in SYNCS:
                bucket(self.owner(tid, s), s)["syncs"] += 1

        bounds = sorted({t for sp in self.spans for t in sp[2:]}
                        | set(self.window))
        who = [self._idle_owner(a) for a in bounds]   # idle
        for x, y in self.idle():
            k = bisect.bisect_right(bounds, x) - 1
            while x < y:
                cut = bounds[k + 1] if k + 1 < len(bounds) else y
                nxt = min(y, cut)
                sp = who[k] if k >= 0 else None
                bucket(sp, x)["idle_ms"] += (nxt - x) * 1e-6
                x, k = nxt, k + 1
        return {"steps": steps, "outside": outside, "unlinked": unlinked}


def readings(parts: dict, stamps=(), window=None) -> dict:
    """The per-layer numbers of a traced window, each None where the trace
    has nothing to read: launches and syncs a step, idle ms a step left
    by the forward's parts, the backward's and the optimizer's, device ms
    a step launched by the recompute, and the worker's mean ms a batch
    (the ``Prefetcher``'s stamps that lie within ``window``)."""
    steps = parts["steps"]

    def mean(field, names=None):
        if not steps:
            return None
        return sum(v[field] for s in steps for k, v in s.items()
                   if names is None or k in names) / len(steps)

    inside = [e - s for s, e in stamps
              if window is None or window[0] <= s and e <= window[1]]
    return {"step_launches.train": mean("launches"),
            "step_syncs.train": mean("syncs"),
            "idle_forward_ms.train": mean("idle_ms", FORWARD),
            "idle_backward_ms.train": mean("idle_ms", BACKWARD),
            "idle_optimizer_ms.train": mean("idle_ms", OPTIMIZER),
            "recompute_device_ms.train": mean("device_ms", ("recompute",)),
            "feed_assemble_ms.train": (1e-6 * sum(inside) / len(inside)
                                       if inside else None)}


def collect(events, window) -> ProgramTrace:
    """A :class:`ProgramTrace` from a profiler's events
    (``prof.profiler.kineto_results.events()``) and the window (start,
    end) in ``time.time_ns()`` nanoseconds.  A ``wssdl::`` or ``bench::``
    range mirrored on the device's timeline is no device operation; a
    host event named as a CUDA runtime or driver function is a runtime
    call (operators are ``aten::...``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, calls, spans = [], [], []
    for e in events:
        name, s, d = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and not name.startswith(MIRRORS):
                ops.append((name, s, s + d, e.correlation_id()))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], e.start_thread_id(), s,
                          s + d))
        elif RUNTIME.match(name):
            calls.append((name, e.start_thread_id(), s, s + d,
                          e.correlation_id()))
    return ProgramTrace(ops, calls, spans, window)


@contextlib.contextmanager
def traced(record):
    """Trace the card and the host while the block runs; ``record`` (a
    list) receives one :class:`ProgramTrace` afterwards.  The window runs
    from the block's start to the card's synchronisation at its end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.time_ns()
        yield
        torch.cuda.synchronize()
        end = time.time_ns()
    record.append(collect(prof.profiler.kineto_results.events(),
                          (start, end)))
