#!/usr/bin/env python3
"""Time builds of the ROI-pool backward (``csrc/roi_pool.cu``,
``wssdl_roi_pool_bwd`` / ``_bf16``) against each other on one card.

    python3 tools/torch_bwd_variants.py A.cu B.cu [...] [--rounds 4]

Each source is built with ``ops/_build.py``'s nvcc flags (``-I`` the
port's ``csrc/`` for its headers) into a private directory and called
through ctypes on the same inputs, shaped as the combined training step's
two launches: the supervised group (a [1, 38, 56, 512] post-ReLU map, 128
ROIs, a dense cotangent) and the weak group ([2, 38, 56, 512], 2 x 2000
ROIs, one nonzero cotangent row per image, as MIL leaves it), in f32 and
bf16.  Each build's dfeat is held against the plain version
(``ops/roi_pool.py:roi_pool_grad`` / ``_bf16``) on the card and any
difference reported (the exit code is then 1).  Times:
CUDA events over 50 back-to-back calls, the builds in turns (the order
reversed every other round), the median of the rounds; and torch.profiler's
device time per kernel name per launch.  The scratch is sized generously,
so builds whose scratch layout differs run side by side.  Prints the card's
name and power limit.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build(src: str, out_dir: str) -> ctypes.CDLL:
    from wssdl_bus_tpu_torch.ops import _build

    lib = os.path.join(out_dir, os.path.basename(src).replace(".cu", ".so"))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                    "-o", lib, src], check=True, capture_output=True)
    dll = ctypes.CDLL(lib)
    for name in ("wssdl_roi_pool_bwd", "wssdl_roi_pool_bwd_bf16"):
        fn = getattr(dll, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 4
    return dll


def inputs(seed: int = 0) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = {}
    for name, b, p, mil in (("sup", 1, 128, False), ("weak", 2, 2000, True)):
        feat = torch.randn((b, 38, 56, 512), generator=gen,
                           device="cuda").relu_()
        xy = torch.rand((b, p, 2), generator=gen, device="cuda") \
            * torch.tensor([860.0, 580.0], device="cuda")
        wh = torch.rand((b, p, 2), generator=gen, device="cuda") * 300 + 8
        rois = torch.cat([xy, (xy + wh).minimum(
            torch.tensor([895.0, 607.0], device="cuda"))], -1).contiguous()
        g = torch.randn((b, p, 49 * 512), generator=gen, device="cuda")
        if mil:
            g[:, 1:] = 0.0
        cases[name] = (feat, rois, g)
    return cases


def runner(dll, feat, rois, g):
    """-> a no-argument call of the build's backward on preallocated
    buffers, and its dfeat."""
    b, h, w, c = feat.shape
    p = rois.shape[1]
    bf16 = g.dtype == torch.bfloat16
    fn = dll.wssdl_roi_pool_bwd_bf16 if bf16 else dll.wssdl_roi_pool_bwd
    work = torch.empty((8 * b * p + b * (8 * h + 8) + 64,), dtype=torch.int32,
                       device="cuda")
    cell = torch.int16 if h * w <= 32767 else torch.int32
    table = torch.empty((b * p * 49 * c,), dtype=cell, device="cuda")
    dfeat = torch.empty_like(feat)
    stream = torch.cuda.current_stream().cuda_stream
    args = (feat.data_ptr(), rois.data_ptr(), g.data_ptr(), b, h, w, c, p, 7,
            7, 1.0 / 16.0, 0, work.data_ptr(), table.data_ptr(),
            dfeat.data_ptr(), stream)

    def call(keep=(work, table)):    # the scratch lives with the call
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
    return call, dfeat


def events_ms(call, iters: int = 50) -> float:
    for _ in range(3):
        call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_split(call, reps: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "_kernel" in e.key and e.count:
            name = e.key.split("_kernel")[0].rsplit("::", 1)[-1]
            out[name] = getattr(e, "device_time_total", 0) / e.count / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    tmp = tempfile.mkdtemp()
    dlls = {os.path.basename(s): build(s, tmp) for s in args.sources}
    names = list(dlls)
    from wssdl_bus_tpu_torch.ops.roi_pool import (roi_pool_grad,
                                                  roi_pool_grad_bf16)

    ok = True
    cases = inputs()
    for case, (feat, rois, g32) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            g = g32.to(dtype)
            calls = {n: runner(dlls[n], feat, rois, g) for n in names}
            plain = roi_pool_grad_bf16 if dtype == torch.bfloat16 \
                else roi_pool_grad
            want = plain(feat, rois, g)
            for n, (call, dfeat) in calls.items():
                call()
                torch.cuda.synchronize()
                bad = int((dfeat != want).sum())
                if bad:
                    print(f"{case} {dtype}: {n} differs from the plain "
                          f"version in {bad} of {want.numel()} elements")
                    ok = False
            times = {n: [] for n in names}
            for r in range(args.rounds):
                for n in (names if r % 2 == 0 else names[::-1]):
                    times[n].append(events_ms(calls[n][0]))
            for n in names:
                split = device_split(calls[n][0])
                print(f"{case:4s} {str(dtype)[6:]:8s} {n:24s} events "
                      f"{statistics.median(times[n]):.4f} ms (rounds "
                      f"{', '.join(f'{t:.4f}' for t in times[n])}); device "
                      + " + ".join(f"{k} {v:.4f}" for k, v in split.items()),
                      flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
