"""ctypes bindings for the port's native host-runtime kernels
(``native/wssdl_native.cc``, the port's own copy of the JAX package's
``native/wssdl_native.cc``; counterpart of ``wssdl_bus_tpu/native``).

The library is built with g++ at first use, with the flags of the JAX
package's ``native/Makefile``, into the git-ignored ``_build/`` beside the
port's sources, named by a hash of the source and the flags.  The build
writes a private name and renames it, under a file lock (processes) and a
thread lock (prefetch threads), so concurrent first users never load a
half-written library.  Without a compiler every function returns ``None``
and each caller keeps its PIL / scipy / numpy path, as the JAX package does.

  * ``nms``               greedy IoU NMS (the reference's cpu_nms.pyx)
  * ``bbox_overlaps``     dense IoU matrix, or unidirectional overlaps
  * ``resize_bilinear`` / ``rotate_bilinear`` / ``brightness_contrast``
                          the image-preparation hot loops
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "wssdl_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_lock = threading.Lock()
_FP = ctypes.POINTER(ctypes.c_float)


def lib_path() -> str:
    """The library's path, named by a hash of the source and the flags."""
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libwssdl_native-{digest.hexdigest()[:16]}.so")


def build() -> Optional[str]:
    """Build the library if it is missing; -> its path, or None when there
    is no compiler or the build fails.  Safe to call from several threads
    and processes at once."""
    path = lib_path()
    if os.path.exists(path):
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):        # another process built it meanwhile
            return path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cxx, *CXXFLAGS, "-o", tmp, SOURCE], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, path)
        except (OSError, subprocess.SubprocessError):
            return None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _load_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.wssdl_nms.restype = ctypes.c_int
        lib.wssdl_nms.argtypes = [_FP, ctypes.c_int, ctypes.c_float,
                                  ctypes.POINTER(ctypes.c_int)]
        for name in ("wssdl_bbox_overlaps", "wssdl_bbox_overlaps_ui"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [_FP, ctypes.c_int, _FP, ctypes.c_int, _FP]
        lib.wssdl_resize_bilinear.restype = None
        lib.wssdl_resize_bilinear.argtypes = [_FP, ctypes.c_int, ctypes.c_int,
                                              _FP, ctypes.c_int, ctypes.c_int]
        lib.wssdl_rotate_bilinear.restype = None
        lib.wssdl_rotate_bilinear.argtypes = [
            _FP, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            _FP]
        lib.wssdl_brightness_contrast.restype = None
        lib.wssdl_brightness_contrast.argtypes = [
            _FP, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int]
        _lib = lib
        return _lib


def _fp(arr: np.ndarray):
    return arr.ctypes.data_as(_FP)


def available() -> bool:
    return _load() is not None


def nms(dets: np.ndarray, thresh: float) -> Optional[list]:
    """Greedy NMS over score-desc-sorted dets [n, 5]; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    dets = np.ascontiguousarray(dets, np.float32)
    keep = np.empty((len(dets),), np.int32)
    n = lib.wssdl_nms(_fp(dets), len(dets), float(thresh),
                      keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return keep[:n].tolist()


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray,
                  unidirectional: bool = False) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    boxes = np.ascontiguousarray(boxes, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    out = np.empty((len(boxes), len(query)), np.float32)
    fn = lib.wssdl_bbox_overlaps_ui if unidirectional \
        else lib.wssdl_bbox_overlaps
    fn(_fp(boxes), len(boxes), _fp(query), len(query), _fp(out))
    return out


def resize_bilinear(im: np.ndarray, oh: int, ow: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    im = np.ascontiguousarray(im, np.float32)
    out = np.empty((oh, ow), np.float32)
    lib.wssdl_resize_bilinear(_fp(im), im.shape[0], im.shape[1], _fp(out),
                              oh, ow)
    return out


def rotate_bilinear(im: np.ndarray, degrees: float,
                    cval: float) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    im = np.ascontiguousarray(im, np.float32)
    out = np.empty_like(im)
    lib.wssdl_rotate_bilinear(_fp(im), im.shape[0], im.shape[1],
                              float(degrees), float(cval), _fp(out))
    return out


def brightness_contrast(im: np.ndarray, delta: float, factor: float,
                        apply_brightness: bool,
                        apply_contrast: bool) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    # a copy always: the kernel writes in place, and ascontiguousarray would
    # alias a caller's contiguous float32 array
    im = np.array(im, np.float32, copy=True, order="C")
    lib.wssdl_brightness_contrast(_fp(im), im.size, float(delta),
                                  float(factor), int(apply_brightness),
                                  int(apply_contrast))
    return im
