"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C functions (no PyTorch headers), so a
build takes seconds.  The shared library goes into ``_build/`` beside this
package's sources, named by a hash of the source and the flags: an edited
source builds anew, an unchanged one loads what is there.  Nothing here runs
at import time; the kernel wrappers call :func:`load` on their first launch,
and :func:`build_all` builds every source at once, one ``nvcc`` per file,
all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("nms", "roi_pool", "conv1", "conv2_pool", "int8_conv")

# -fmad=false: no contracted multiply-adds anywhere (the NMS keep set and the
# ROI quantisation must equal the plain PyTorch versions bit for bit); the
# kernels use no fast-math approximations either.  The fused stem's explicit
# fmaf calls (conv1_1 in the plain version's order) are not contractions and
# stay fused; the stem kernels' wgmma (inline PTX, no CUTLASS) is untouched
# by the flag.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    nvcc = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, every shared
    header in ``csrc/`` and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all(names=SOURCES, verbose: bool = False) -> dict:
    """Build every missing library in parallel; -> {name: ptxas report}.

    Raises RuntimeError with nvcc's output if any build fails.  The report
    is nvcc's stderr (``-Xptxas -v``: registers, shared memory and spills of
    each kernel), empty for a library that was already built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path):
            continue
        nvcc = nvcc or _nvcc()
        # build to a private name, then rename: a concurrent loader never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            os.remove(tmp)
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{out}")
        if verbose:
            print(f"[build] csrc/{name}.cu -> {os.path.basename(path)}\n{out}",
                  flush=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    path = _lib_path(name)
    if not os.path.exists(path):
        build_all((name,))
    return ctypes.CDLL(path)
