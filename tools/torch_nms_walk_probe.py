#!/usr/bin/env python3
"""Where the NMS walk's time goes: a private build of ``csrc/nms.cu`` whose
walk kernel stamps ``clock64()`` at its phase boundaries for image 0, and
the per-tile averages of the gaps between the stamps.

    python3 tools/torch_nms_walk_probe.py [--seed=0] [--sass=PATH]
        [variant ...]

The inputs are synthetic proposals: jittered copies of a few hundred
object boxes on a 608 x 816 canvas, score-sorted, 84% valid, at the served
[8, 4, 6000] and the training [3, 4, 12000] shapes.  The probe build is
checked against the plain version; the package's own build is not
touched.  ``--sass=PATH`` writes the first variant's SASS (cuobjdump) to
PATH.  Variants (text patches of that copy; default all):
  base       the kernel as it is;
  no_loads   the ORs read no stage (keep sets wrong).
Stamps a tile: its start, after warp 0's settle, after the barrier that
publishes the kept rows, after the wait for the tile row's first chunk,
after the barrier ending that chunk's ORs.  Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from wssdl_bus_tpu_torch.ops import _build  # noqa: E402
from wssdl_bus_tpu_torch.ops.nms import nms_mask  # noqa: E402

MAX_TILES = 4096
STAMPS = 5
PROBE_HEAD = f"""
__device__ long long g_probe[{MAX_TILES}][{STAMPS}];
extern "C" int wssdl_nms_probe_read(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}}
#define PROBE(cond, k) \\
  if (blockIdx.x == 0 && t < {MAX_TILES} && (cond)) \\
    g_probe[t][k] = clock64();

namespace {{
"""
PATCHES = [
    ("\nnamespace {\n", PROBE_HEAD),
    ("    if (tid < 32) {\n      // settle the tile",
     "    PROBE(tid == 0, 0)\n    if (tid < 32) {\n      // settle the tile"),
    ("      if ((kept >> lane) & 1ull)\n",
     "      PROBE(lane == 0, 1)\n      if ((kept >> lane) & 1ull)\n"),
    ("    __syncthreads();\n    // the kept rows' words",
     "    __syncthreads();\n    PROBE(tid == 0, 2)\n"
     "    // the kept rows' words"),
    ("      const u64* st = stage + slot * kTile * cw;\n",
     "      PROBE(tid == 0 && q0 == 0, 3)\n"
     "      const u64* st = stage + slot * kTile * cw;\n"),
    ("      __syncthreads();\n      if (tid == 0)\n",
     "      __syncthreads();\n      PROBE(tid == 0 && q0 == 0, 4)\n"
     "      if (tid == 0)\n"),
]
VARIANTS = {
    "base": [],
    "no_loads": [("acc |= st[s_list[kk] * wk + c];", "acc |= s_list[kk];")],
}
GAPS = [
    ("warp 0: settle", 0, 1),
    ("warp 0: list, next column words", 1, 2),
    ("wait for the tile row's first chunk", 2, 3),
    ("ORs of the first chunk and barrier", 3, 4),
]


def build(tmp, variants):
    """-> {variant: its library}, the nvcc runs in parallel."""
    with open(os.path.join(_build.CSRC_DIR, "nms.cu")) as fh:
        base = fh.read()
    procs = {}
    for v in variants:
        src = base
        for a, b in PATCHES + VARIANTS[v]:
            assert src.count(a) == 1, f"{v}: anchor not unique: {a!r}"
            src = src.replace(a, b)
        path = os.path.join(tmp, f"nms_{v}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        out = os.path.join(tmp, f"libnms_{v}.so")
        procs[v] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS,
                                      "-o", out, path],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    out)
    libs = {}
    for v, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{v}: {log}")
        libs[v] = bind(ctypes.CDLL(out))
    return libs


def bind(lib):
    lib.wssdl_nms_keep.restype = ctypes.c_int
    lib.wssdl_nms_keep.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.wssdl_nms_scratch_bytes.restype = ctypes.c_longlong
    lib.wssdl_nms_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.wssdl_nms_probe_read.argtypes = [ctypes.c_void_p]
    return lib


def proposals(rng, b, n):
    """[B, 4, N] score-sorted jittered copies of object boxes, [B, N]
    valid."""
    objs = 300
    xy = rng.uniform(0, [700, 500], (b, objs, 2))
    wh = np.exp(rng.uniform(np.log(20), np.log(300), (b, objs, 2)))
    pick = rng.randint(0, objs, (b, n))
    c = np.take_along_axis(xy, pick[..., None], 1)
    s = np.take_along_axis(wh, pick[..., None], 1) \
        * rng.uniform(0.75, 1.3, (b, n, 2))
    c = c + rng.normal(0, 0.12, (b, n, 2)) * s
    boxes = np.concatenate([c, c + s], -1).transpose(0, 2, 1)
    valid = rng.uniform(size=(b, n)) < 0.84
    return (torch.from_numpy(boxes.astype(np.float32).copy()),
            torch.from_numpy(valid))


def main() -> int:
    seed, sass = 0, None
    variants = []
    for a in sys.argv[1:]:
        if a.startswith("--seed="):
            seed = int(a.split("=", 1)[1])
        elif a.startswith("--sass="):
            sass = a.split("=", 1)[1]
        else:
            variants.append(a)
    variants = variants or list(VARIANTS)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    rng = np.random.RandomState(seed)
    cases = [(b, n, *proposals(rng, b, n)) for b, n in ((8, 6000),
                                                         (3, 12000))]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, variants)
        if sass:
            with open(sass, "w") as fh:
                subprocess.run([os.path.join(os.path.dirname(_build._nvcc()),
                                             "cuobjdump"), "-sass",
                                os.path.join(tmp, f"libnms_{variants[0]}.so")],
                               stdout=fh, check=True)
        for v, lib in libs.items():
            for b, n, boxes, valid in cases:
                report(v, lib, b, n, boxes, valid)
    print(f"[probe] {torch.cuda.get_device_name(0)}")
    return 0


def report(v, lib, b, n, boxes, valid):
    """Run variant v three times on one case; print its stamps' gaps."""
    want = nms_mask(boxes, valid, 0.7)
    boxes, valid = boxes.cuda(), valid.cuda()
    keep = torch.empty((b, n), dtype=torch.bool, device="cuda")
    scratch = torch.empty((lib.wssdl_nms_scratch_bytes(b, n),),
                          dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):
        err = lib.wssdl_nms_keep(boxes.data_ptr(), valid.data_ptr(), b, n,
                                 0.7, scratch.data_ptr(), keep.data_ptr(),
                                 stream)
        assert err == 0, f"cudaError {err}"
    torch.cuda.synchronize()
    same = torch.equal(keep.cpu(), want)
    stamps = np.zeros((MAX_TILES, STAMPS), np.int64)
    assert lib.wssdl_nms_probe_read(stamps.ctypes.data) == 0
    tiles = -(-int(valid[0].sum()) // 64)
    s = stamps[:tiles].astype(np.float64)
    step = np.diff(s[:, 0])
    print(f"{v} [{b},4,{n}]: == plain: {same}; image 0: "
          f"{int(valid[0].sum())} valid, {int(want[0].sum())} kept, {tiles} "
          f"tiles; cycles a tile (mean, median): step {step.mean():.0f} / "
          f"{np.median(step):.0f}")
    for name, a, z in GAPS:
        d = s[2:-2, z] - s[2:-2, a]
        d = d[s[2:-2, z] > 0]
        print(f"  {name:42s} {d.mean():8.0f} {np.median(d):8.0f}")


if __name__ == "__main__":
    sys.exit(main())
