"""Readings of the comparison that decides ``correct``, over many seeds in
one process, for setting and testing its limits (not part of a run):

    python3 h100_bench/readings.py --workload <name> --seeds 1,2,3 \
        [--control bf16] [--tf32 0] \
        [--fault unchanged|half_batch|feed_altered|proposal_altered]

Each seed runs the cell's first checked steps (no measured window) and
the reference, and prints one JSON line of every number the comparison
takes.  ``--control bf16`` runs the program's bf16 compute path instead,
``--fault`` breaks the timed path as ``hbench/train_combined.py:Run``
says; both must come out beyond the limits.  ``--tf32 0`` runs the
program with TF32 off in cuDNN and in matmuls (f32 throughout, as the
reference), to tell TF32's rounding from other causes of a gap.
"""

import argparse
import importlib
import json
import shutil
import sys
import tempfile
import time

import run as harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--tf32", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    torch.backends.cudnn.allow_tf32 = bool(args.tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(args.tf32)
    found = harness.find_cell(harness.load_json(harness.ROOT,
                                                "BENCHMARK.json"),
                              args.workload)
    sys.path.insert(0, harness.ROOT)
    kind = importlib.import_module(f"hbench.{found['mix']['kind']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        workdir = tempfile.mkdtemp(prefix="h100_bench_")
        try:
            run = kind.Run(found["config"], found["mix"], seed, workdir,
                           device=args.device, control=args.control,
                           fault=args.fault)
            rec = run.checked_steps()
            run.close()
            numbers = kind.reference_check(run, rec)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        correct, _ = harness.judge(numbers, found["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "tf32": args.tf32,
                          "correct": correct,
                          "seconds": time.perf_counter() - t0, **numbers}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
