"""Greedy NMS keep-mask: the CUDA kernel ``csrc/nms.cu`` and its dispatch.

Port of the TPU kernel ``wssdl_bus_tpu/ops/nms_pallas.py:_nms_kernel``
(wrapper ``nms_keep_pallas``).  :func:`nms_keep` launches the kernel for CUDA
tensors and takes the plain version (``ops/nms.py:nms_mask``) for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wssdl_bus_tpu_torch.ops.nms import nms_mask


@functools.lru_cache(maxsize=None)
def _lib():
    from wssdl_bus_tpu_torch.ops import _build

    lib = _build.load("nms")
    lib.wssdl_nms_keep.restype = ctypes.c_int
    lib.wssdl_nms_keep.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.wssdl_nms_scratch_bytes.restype = ctypes.c_longlong
    lib.wssdl_nms_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def nms_keep(boxes_t: torch.Tensor, valid: torch.Tensor,
             thresh: float) -> torch.Tensor:
    """Greedy NMS keep-mask for a batch of score-sorted box sets.

    Args:
      boxes_t: [B, 4, N] f32, x1/y1/x2/y2 rows, columns score-descending.
      valid: [B, N] bool; invalid boxes are never kept and never suppress.
      thresh: IoU threshold; overlap >= thresh suppresses.
    Returns [B, N] bool.  One kernel launch serves the whole batch.
    """
    if boxes_t.device.type == "cpu" and valid.device.type == "cpu":
        return nms_mask(boxes_t, valid, thresh)
    if boxes_t.device.type != "cuda" or valid.device != boxes_t.device:
        raise ValueError(f"nms_keep: boxes_t on {boxes_t.device}, valid on "
                         f"{valid.device}; want both on one CUDA device or "
                         "both on the CPU")
    b, four, n = boxes_t.shape
    if four != 4 or valid.shape != (b, n):
        raise ValueError(f"boxes_t {tuple(boxes_t.shape)} / valid "
                         f"{tuple(valid.shape)}: want [B, 4, N] / [B, N]")
    if boxes_t.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"nms_keep takes f32 boxes and bool valid, got "
                        f"{boxes_t.dtype} / {valid.dtype}")
    if not (boxes_t.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep takes contiguous tensors")
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes_t.device)
    if b == 0 or n == 0:
        return keep
    lib = _lib()
    # the kernels' scratch (csrc/nms.cu): the listed valid boxes and the
    # mask store of every image
    scratch = torch.empty((lib.wssdl_nms_scratch_bytes(b, n),),
                          dtype=torch.uint8, device=boxes_t.device)
    with torch.cuda.device(boxes_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wssdl_nms_keep(boxes_t.data_ptr(), valid.data_ptr(), b, n,
                                 float(thresh), scratch.data_ptr(),
                                 keep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError {err}")
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0
