"""Run one cell of the H100 benchmark once.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the detector's PyTorch/CUDA port.
The cell is looked up in ``BENCHMARK.json``; its configuration file, its
traffic mix (``traffic/<name>.json``, whose ``kind`` names the driver in
``hbench/``), its limits (``checks/<workload>.json``) and one reader per
metric (``metrics/<metric>.py``) are found by name, so a cell, a mix or a
metric is added with files and entries alone.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``setup_parts`` (seconds of each part of set-up) and
``built`` (the kernels this run built: non-empty only in a checkout's
first run); the numbers compared with the reference come last, under
``checks``, and again as the last lines of standard error.  Without a
CUDA card the run fails and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".h100_bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "wssdl_bus_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    """The cell's entry, its configuration and traffic files, its limits
    and the names of the metrics it reports, traced and untraced."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def reported(m):    # an end-to-end metric without a list: every cell
        return workload in m.get("workloads", [workload])

    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise SystemExit(f"per-layer metric {m['name']!r} lists no "
                             "workloads")
    return {"cell": cell,
            "config": load_json(ROOT, conf["file"]),
            "mix": load_json(HERE, "traffic", cell["traffic"] + ".json"),
            "limits": load_json(HERE, "checks", workload + ".json")["limits"],
            "end_to_end": [m for m in bench["end_to_end"] if reported(m)],
            "per_layer": [m for m in bench["per_layer"]
                          if workload in m["workloads"]]}


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(ctx)``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics, ctx) -> dict:
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def judge(numbers: dict, limits: dict):
    """-> (correct, {name: {"value", "limit"}}) over the limits' names."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    bench = load_json(ROOT, "BENCHMARK.json")
    found = find_cell(bench, args.workload)
    chips = found["cell"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100_bench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    kind = importlib.import_module(f"hbench.{found['mix']['kind']}")
    workdir = tempfile.mkdtemp(prefix="h100_bench_")
    run = None
    try:
        try:
            run = kind.Run(found["config"], found["mix"], args.seed, workdir)
            rec = run.checked_steps()
            w = run.window(args.seconds,
                           found["mix"]["trace_steps"] if args.trace else 0)
        finally:
            if run is not None:
                run.close()
        setup_s = w["start"] - T_START
        parts, last = {}, T_START
        for part, t in run.marks:
            parts[part] = t - last
            print(f"setup {part} {t - last:.3f} s", file=sys.stderr)
            last = t
        ctx = kind.context(run, w, setup_s)
        metrics = read_metrics(found["per_layer"] if args.trace
                               else found["end_to_end"], ctx)
        result = {"attempted": w["attempted"], "failed": w["failed"],
                  "metrics": metrics,
                  "device": {"platform": "gpu",
                             "kind": torch.cuda.get_device_name(0),
                             "count": chips,
                             "memory_peak_bytes": max(w["peak_bytes"],
                                                      w["setup_peak_bytes"])}}
        if w["trace"] is not None:
            tr = w["trace"]
            result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
            result["breakdown"] = {"device_ops": [list(x) for x in
                                                  tr.top_ops()],
                                   "idle_gaps": [list(x) for x in
                                                 tr.idle_gaps()]}
        numbers = kind.reference_check(run, rec)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"h100_bench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    correct, checks = judge(numbers, found["limits"])
    info = dict(numbers["info"], **{k: v for k, v in numbers.items()
                                    if k != "info" and k not in checks})
    # a checkout's first run builds the kernels: its set-up is marked so,
    # with the builds' seconds apart
    result = {"correct": correct and w["failed"] == 0, **result,
              "setup_parts": parts, "built": run.built,
              "reference_info": info, "checks": checks}
    print(json.dumps(result))
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
