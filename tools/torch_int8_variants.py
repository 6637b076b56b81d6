#!/usr/bin/env python3
"""Where the int8 conv kernel's time goes: build variants of
``csrc/int8_conv.cu`` with one part changed and time each on the card at
the layer shapes of VGG16's batch-8 int8 serving step.

    python3 tools/torch_int8_variants.py [variant ...]

Variants (each a text patch of a private copy of the sources; the
package's own build is untouched):
  base        the kernel as it is;
  fdiv        the requantize step divides with __fdiv_rn (the IEEE
              division instruction sequence) instead of quotient();
  recip       ... multiplies by the reciprocal alone (not exact: timing);
  wait2       the TMA path keeps two wgmma groups in flight, not one;
  no_halo     3x3/1 convs from 64 channels take the TMA path;
  no_epi      no epilogue on the TMA and halo paths (products alone);
  small_no_epi, small_no_abuild, small_no_patch
              the Cin = 3 path without its epilogue, its im2col build of
              A, or its input patch's loads.
Each shape is run with random int8 data, f32 out and int8 out; the base
variant is first compared with the plain version (bit for bit).  Times by
CUDA events, 10 launches after 2.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from wssdl_bus_tpu_torch.ops import _build  # noqa: E402
from wssdl_bus_tpu_torch.ops import int8_conv_cuda as W  # noqa: E402
from wssdl_bus_tpu_torch.ops.int8_conv import (int8_conv_plain,  # noqa: E402
                                               pack_weight)


def _never(line):
    """The statement that starts with ``line`` guarded by a condition no
    conv meets (relu is 0 or 1), so the code around it stays."""
    indent = len(line) - len(line.lstrip())
    return line, line[:indent] + "if (s.relu == 7) " + line[indent:]


_TMA_WAIT = """      if (k > 0) {
        wgmma_wait<1>();                    // stage `prev` has been read
        if (arrives) tma::mbar_arrive(empty0 + 8 * prev);
      }
      prev = st;"""
_TMA_END = """    if (arrives) tma::mbar_arrive(empty0 + 8 * prev);
    long long pix[2][2];"""
VARIANTS = {
    "base": [],
    "fdiv": [("rintf(quotient(y, s, r))", "rintf(__fdiv_rn(y, s))")],
    "recip": [("rintf(quotient(y, s, r))", "rintf(__fmul_rn(y, r))")],
    "wait2": [("    int prev = 0;\n", "    int prev = 0, prev2 = 0;\n"),
              (_TMA_WAIT, """      if (k > 1) {
        wgmma_wait<2>();
        if (arrives) tma::mbar_arrive(empty0 + 8 * prev2);
      }
      prev2 = prev;
      prev = st;"""),
              (_TMA_END, """    if (arrives) {
      if (kiters > 1) tma::mbar_arrive(empty0 + 8 * prev2);
      tma::mbar_arrive(empty0 + 8 * prev);
    }
    long long pix[2][2];""")],
    "no_halo": [("  return kh == 3 && kw == 3 && stride == 1 && cin == kCB &&",
                 "  return false && kh == 3 && kw == 3 && stride == 1 &&")],
    "no_epi": [_never("    store_tile<2, BN, kI8>(acc, pix, s, tc.co0,"),
               _never("    store_tile<2, 64, kI8>(acc, pix, s, co0,")],
    "small_no_epi": [_never("  store_tile<2, 64, kI8>(acc, pix, s, 0,")],
    "small_no_abuild": [("k0 < 32 * nk32;",
                         "k0 < (s.relu == 7 ? 32 * nk32 : 0);")],
    "small_no_patch": [("j < s.bn * ph * prow;",
                        "j < (s.relu == 7 ? s.bn * ph * prow : 0);")],
}
# VGG16's batch-8 layer shapes at the served 608 x 816 canvas: (H, W, Cin,
# Cout), each a 3x3 conv at stride 1
SHAPES = [(608, 816, 3, 64), (608, 816, 64, 64), (304, 408, 64, 128),
          (304, 408, 128, 128), (152, 204, 128, 256), (152, 204, 256, 256),
          (76, 102, 256, 512), (76, 102, 512, 512), (38, 51, 512, 512)]


def build(names):
    """-> {variant: the library's wssdl_int8_conv}, one nvcc per variant,
    all started together."""
    src = open(os.path.join(_build.CSRC_DIR, "int8_conv.cu")).read()
    tmp = tempfile.mkdtemp()
    for f in os.listdir(_build.CSRC_DIR):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(_build.CSRC_DIR, f), tmp)
    procs = {}
    for name in names:
        s = src
        for a, b in VARIANTS[name]:
            if a not in s:
                raise SystemExit(f"variant {name}: no patch target:\n{a}")
            s = s.replace(a, b)
        path = os.path.join(tmp, f"v_{name}.cu")
        open(path, "w").write(s)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(tmp, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{out}")
        fn = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so")).wssdl_int8_conv
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 18 \
            + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


TILE_PLAN = W.tile_plan


@functools.lru_cache(maxsize=None)
def tma_plan(b, h, w, cin, cout, k, stride):
    """tile_plan, but the halo path's shapes on the TMA path (no_halo);
    cached as tile_plan is, so that the host keeps ahead of the card."""
    if cin % 64:
        return TILE_PLAN(b, h, w, cin, cout, k, stride)
    _, _, (ho, wo) = W.conv_pads(h, w, k, k, stride)
    ntn = cout // (128 if cout % 128 == 0 else 64)
    return W.Plan(*W._best_patch(b, ho, wo, ntn, 256, stride,
                                 lambda *_: True, True)[1], 256, "tma")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("int8_variants: needs a CUDA card", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"int8_variants: unknown variants {sorted(unknown)}",
              file=sys.stderr)
        return 2
    fns = build(names)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[int8_variants] {smi}", flush=True)
    real_lib = W._lib
    g = torch.Generator().manual_seed(0)
    total = {}
    try:
        for h, w, cin, cout in SHAPES:
            xq = torch.randint(-127, 128, (8, h, w, cin), dtype=torch.int8,
                               generator=g).cuda()
            pk = pack_weight(torch.randint(-127, 128, (3, 3, cin, cout),
                                           dtype=torch.int8,
                                           generator=g)).cuda()
            sc = torch.full((cout,), 1e-5, device="cuda")
            bi = torch.randn(cout, generator=g).cuda()
            s_next = torch.tensor(0.05, device="cuda")
            line = []
            for name, fn in fns.items():
                W._lib = lambda fn=fn: fn
                W.tile_plan = tma_plan if name == "no_halo" else TILE_PLAN
                for out_scale in (None, s_next):
                    args = (xq, pk, 3, 3, sc, bi, 1, True, out_scale)
                    if name == "base":
                        assert torch.equal(W.int8_conv(*args),
                                           int8_conv_plain(*args))
                    ms = cuda_ms(lambda: W.int8_conv(*args))
                    out = "f32" if out_scale is None else "int8"
                    key = f"{name}/{out}"
                    total[key] = total.get(key, 0.0) + ms
                    line.append(f"{key} {ms:.4f}")
            print(f"[int8_variants] (8, {h}, {w}, {cin}) -> {cout}: "
                  + ", ".join(line), flush=True)
    finally:
        W._lib, W.tile_plan = real_lib, TILE_PLAN
    print("[int8_variants] summed over the 9 shapes (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in total.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
