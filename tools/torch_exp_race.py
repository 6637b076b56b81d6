#!/usr/bin/env python3
"""Count PyTorch CPU ``exp`` results off by more than an ulp on the first
parallel call of a fresh process, with and without a serial warm-up call.

    python tools/torch_exp_race.py [--rounds 12] [--at-once 8]

Each round starts ``--at-once`` cold and ``--at-once`` warm processes
together.  A cold process calls ``torch.exp`` on a strided [2, 17100]
slice of f32 deltas (the proposal decode's ``exp(dw)``) as its first
parallel call; a warm one first imports ``wssdl_bus_tpu_torch``, whose
``__init__`` makes one small serial ``exp``/``log`` call.  A process is
bad when any element's relative error against float64 exceeds 1e-6.  On
a CPU build with MKL, PyTorch computes f32 ``exp`` through MKL's vector
math in blocks of 2048 values; a bad process shows one such block at
~1e-4 relative error (see ``wssdl_bus_tpu_torch/utils:warm_cpu_vector_math``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import sys
import numpy as np
import torch
if sys.argv[1] == "warm":
    import wssdl_bus_tpu_torch  # noqa: F401
x = (np.random.RandomState(0).randn(2, 17100, 4) * 0.2).astype(np.float32)
e = torch.exp(torch.from_numpy(x)[..., 2::4]).numpy()
true = np.exp(x[..., 2::4].astype(np.float64))
print(int((np.abs(e - true) / true > 1e-6).sum()))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--at-once", type=int, default=8)
    args = ap.parse_args()
    env = dict(os.environ, PYTHONPATH=REPO)
    bad = {"cold": 0, "warm": 0}
    runs = {"cold": 0, "warm": 0}
    for _ in range(args.rounds):
        procs = [(kind, subprocess.Popen(
            [sys.executable, "-c", _CHILD, kind], env=env,
            stdout=subprocess.PIPE, text=True))
            for _ in range(args.at_once) for kind in ("cold", "warm")]
        for kind, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"{kind} child failed")
            runs[kind] += 1
            bad[kind] += int(out.strip().splitlines()[-1]) > 0
    for kind in ("cold", "warm"):
        print(f"{kind}: {bad[kind]} of {runs[kind]} processes had values "
              f"off by > 1e-6 relative", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
