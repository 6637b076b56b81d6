#!/usr/bin/env python3
"""Where the fused stem kernel's time goes: build variants of
``csrc/conv1.cu`` with parts switched off and time each on the card.

    python3 tools/torch_stem_variants.py [--sass=PATH] [variant ...]

Variants (each a text patch of a private copy of the sources; the
package's own build is untouched):
  base             the kernel as it is;
  no_conv11        the producer computes no conv1_1 (consumers alone);
  no_mma           the consumers run no products (producer alone);
  no_both          neither (the pipeline, patch loads and output stores);
  no_patch         no prefetch of the next tile's input patch;
  no_mma_no_patch  producer compute alone;
  wait_hint        mbarrier waits with a 10 ms suspend-time hint.
Each variant is first run on a small dyadic input and compared with the
plain version (variants that skip work print False there), then timed by
CUDA events at the served (8, 608, 816, 3) and training (3, 608, 896, 3)
shapes, twice in turns.  ``--sass=PATH`` writes the base variant's SASS
(cuobjdump) to PATH.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from wssdl_bus_tpu_torch.ops import _build  # noqa: E402
from wssdl_bus_tpu_torch.ops.conv1 import vgg_stem_plain  # noqa: E402
from wssdl_bus_tpu_torch.ops.conv2_pool import \
    pack_conv2_weights_bf16  # noqa: E402

NO_CONV11 = ("conv1.cu", "      conv1_1_tile(", "      if (0) conv1_1_tile(")
NO_MMA = ("vgg_stem.cuh", "  for (int tap = 0; tap < 9; ++tap) {",
          "  for (int tap = 0; tap < 0; ++tap) {")
NO_PATCH = ("conv1.cu", "      if (next < ntiles)          // in flight "
            "while this tile's a1 is made\n        load_patch(",
            "      if (0)\n        load_patch(")
PATCHES = {
    "base": [],
    "no_conv11": [NO_CONV11],
    "no_mma": [NO_MMA],
    "no_both": [NO_CONV11, NO_MMA],
    "no_patch": [NO_PATCH],
    "no_mma_no_patch": [NO_PATCH, NO_MMA],
    "wait_hint": [("vgg_stem.cuh", "shared::cta.b64 p, [%1], %2;",
                   "shared::cta.b64 p, [%1], %2, 10000000;")],
}


def build(variants, tmp):
    """-> {variant: the kernel's C entry point}; prints ptxas's report."""
    procs = {}
    for v in variants:
        d = os.path.join(tmp, v)
        os.makedirs(d)
        for f in ("conv1.cu", "vgg_stem.cuh"):
            with open(os.path.join(_build.CSRC_DIR, f)) as fh:
                s = fh.read()
            for pf, a, b in PATCHES[v]:
                if pf == f:
                    assert a in s, f"{v}: {a!r} not in {f}"
                    s = s.replace(a, b)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(s)
        out = os.path.join(d, "lib.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
               os.path.join(d, "conv1.cu")]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    out)
    fns = {}
    for v, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        print(v, [ln.strip() for ln in log.splitlines()
                  if "Used" in ln or "spill" in ln])
        fn = ctypes.CDLL(out).wssdl_vgg_stem_fused
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p, ctypes.c_void_p]
        fns[v] = fn
    return fns


def launch(fn, x, w1, b1, wpk, b2, out):
    b, h, w, _ = x.shape
    err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wpk.data_ptr(),
             b2.data_ptr(), b, h, w, out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"cudaError {err}"


def main() -> int:
    if not torch.cuda.is_available():
        print("stem_variants: needs a CUDA card", file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    variants = args or list(PATCHES)
    tmp = tempfile.mkdtemp()
    fns = build(variants, tmp)
    sass_path = [a.split("=", 1)[1] for a in sys.argv[1:]
                 if a.startswith("--sass=")]
    if sass_path and "base" in fns:
        sass = subprocess.run(
            ["cuobjdump", "-sass", os.path.join(tmp, "base", "lib.so")],
            capture_output=True, text=True).stdout
        with open(sass_path[0], "w") as fh:
            fh.write(sass)
    g = torch.Generator(device="cuda").manual_seed(0)

    def grid(*shape):
        return torch.randint(-8, 9, shape, device="cuda", generator=g) / 8.0

    x = torch.randint(-4, 5, (2, 48, 40, 3), device="cuda",
                      generator=g).float()
    ws = [grid(3, 3, 3, 64), grid(64), grid(3, 3, 64, 64), grid(64)]
    want = vgg_stem_plain(x, *ws)
    for v, fn in fns.items():
        got = torch.empty_like(want)
        launch(fn, x, ws[0], ws[1], pack_conv2_weights_bf16(ws[2]), ws[3],
               got)
        torch.cuda.synchronize()
        print(f"{v}: dyadic (2, 48, 40, 3) == plain: "
              f"{torch.equal(got, want)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for shape in [(8, 608, 816, 3), (3, 608, 896, 3)]:
        b, h, w, _ = shape
        x = torch.randn(shape, device="cuda", generator=g) * 50
        w1 = torch.randn(3, 3, 3, 64, device="cuda", generator=g) * 0.01
        b1 = torch.randn(64, device="cuda", generator=g) * 0.1
        w2 = torch.randn(3, 3, 64, 64, device="cuda", generator=g) * 0.06
        b2 = torch.randn(64, device="cuda", generator=g) * 0.1
        wpk = pack_conv2_weights_bf16(w2)
        out = torch.empty(b, h // 2, w // 2, 64, device="cuda")
        for _ in range(2):
            for v, fn in fns.items():
                launch(fn, x, w1, b1, wpk, b2, out)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    launch(fn, x, w1, b1, wpk, b2, out)
                end.record()
                torch.cuda.synchronize()
                print(f"{shape} {v:16s} {start.elapsed_time(end) / 10:.4f} "
                      "ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
