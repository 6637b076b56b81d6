"""The parts of the port's training step on the card, for one cell (not
part of a run; ``hbench/program_trace.py`` says what belongs to a part):

    python3 h100_bench/step_parts.py --workload <name> --seed <n> \
        [--steps 4] [--seconds 20] [--out <file.json>]

One process makes the cell's set-up and first checked steps as a run
does, then ``--seconds`` of untraced steps (the rate before), ``--steps``
steps under the profiler, and ``--seconds`` of untraced steps again (the
rate after: whether the profiler leaves a cost behind).  It prints one
JSON line: for each part of a step its mean host ms, device ms, launches,
syncs and idle ms over the traced steps; what lies outside the steps; the
per-layer readings of ``program_trace.readings``; the window's idle time
against the parts' sum; the three rates; the cost of a span with no
profiler on; and whether 20 ranges each lie between the ``time.time_ns()``
stamps taken just before and after it (the two clocks agree), with each
range's offset from the first stamp.  ``--out`` also gets every step's
table.
"""

import argparse
import contextlib
import importlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter

import run as harness


def untraced(run, seconds: float, images: int) -> dict:
    """Steps until the first step boundary after ``seconds``, the card
    synchronised at both ends, as the measured window takes them."""
    import torch

    torch.cuda.synchronize()
    t0, steps = time.perf_counter(), 0
    while True:
        run.step()
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    return {"steps": steps, "seconds": s, "images_per_s": steps * images / s,
            "step_ms": 1e3 * s / steps}


def span_cost_us(n: int = 200_000) -> dict:
    """Microseconds a span costs with no profiler on: the port's gated
    ``span``, and a bare ``record_function`` for comparison."""
    import torch
    from wssdl_bus_tpu_torch.utils.logging import span

    out = {}
    for key, make in (("span", span),
                      ("record_function", torch.profiler.record_function)):
        t0 = time.perf_counter()
        for _ in range(n):
            with make("x"):
                pass
        out[key] = 1e6 * (time.perf_counter() - t0) / n
    return out


def card() -> str:
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    found = harness.find_cell(harness.load_json(harness.ROOT,
                                                "BENCHMARK.json"),
                              args.workload)
    sys.path.insert(0, harness.ROOT)
    kind = importlib.import_module(f"hbench.{found['mix']['kind']}")
    from hbench import program_trace as PT
    from wssdl_bus_tpu_torch.utils.logging import span

    out = {"workload": args.workload, "seed": args.seed, "card": card(),
           "torch": torch.__version__, "span_off_us": span_cost_us()}
    workdir = tempfile.mkdtemp(prefix="h100_bench_")
    run = None
    try:
        run = kind.Run(found["config"], found["mix"], args.seed, workdir)
        run.checked_steps()
        images = run.n_s + run.n_ws
        out["before"] = untraced(run, args.seconds, images)
        record = []
        t0 = time.perf_counter()
        with PT.traced(record):
            stamps = []
            for _ in range(20):
                t = time.time_ns()
                with span("clock"):
                    pass
                stamps.append((t, time.time_ns()))
            for _ in range(args.steps):
                run.step()
        tr = record[0]
        window_s = (tr.window[1] - tr.window[0]) * 1e-9
        out["traced"] = {"steps": args.steps, "seconds": window_s,
                         "step_ms": 1e3 * window_s / args.steps,
                         "with_profiler_s": time.perf_counter() - t0}
        out["span_after_profiler"] = type(span("x")).__name__
        out["after"] = untraced(run, args.seconds, images)
        feed = list(run.feed.stamps)
    finally:
        if run is not None:
            run.close()
        shutil.rmtree(workdir, ignore_errors=True)

    parts = tr.parts()
    steps = parts["steps"]
    names = sorted({k for s in steps for k in s})
    out["parts"] = {k: {f: sum(s.get(k, PT.zeros())[f] for s in steps)
                        / len(steps) for f in PT.FIELDS} for k in names}
    out["outside"], out["unlinked"] = parts["outside"], parts["unlinked"]
    out["readings"] = PT.readings(parts, feed, tr.window)
    window_ms = (tr.window[1] - tr.window[0]) * 1e-6
    idle_ms = window_ms - tr.busy_ns() * 1e-6
    out["idle"] = {"window_ms": window_ms, "idle_ms": idle_ms,
                   "device_idle": 100.0 * idle_ms / window_ms,
                   "parts_and_outside_ms": parts["outside"]["idle_ms"] + sum(
                       v["idle_ms"] for s in steps for v in s.values())}
    clock = [sp[2] for sp in tr.spans if sp[0] == "clock"]
    out["clock"] = {"ranges": len(clock),
                    "within_their_stamps": sum(
                        t0 <= c <= t1 for c, (t0, t1) in zip(clock, stamps)),
                    "offset_ms": sorted((c - t0) * 1e-6 for c, (t0, _) in
                                        zip(clock, stamps))}
    linked = {c[4] for c in tr.calls}
    out["ops"] = {"count": len(tr.ops),
                  "linked": sum(o[3] in linked for o in tr.ops),
                  "span_threads": sorted({sp[1] for sp in tr.spans}),
                  "call_threads": sorted({c[1] for c in tr.calls}),
                  "spans_per_step": sum(
                      tr.step_of(sp[2]) is not None for sp in tr.spans)
                  / max(len(steps), 1),
                  "calls": Counter(c[0] for c in tr.calls).most_common(12)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(out, by_step=steps), f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
