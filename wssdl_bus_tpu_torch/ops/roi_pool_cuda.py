"""ROI max-pool: the CUDA kernels of ``csrc/roi_pool.cu`` and their dispatch.

Port of the TPU kernels ``wssdl_bus_tpu/ops/roi_pool_pallas.py``
``_fc_fwd_kernel`` (wrappers ``roi_pool_fc_image`` / ``roi_pool_fc``, the VGG
path) and ``_fwd_kernel`` (``roi_pool_image`` / ``roi_pool_grouped``) in the
forward, ``_bwd_kernel`` (the f32 VJP ``_fc_vjp_bwd``) and ``_fc_bwd_kernel``
(the VJP of the bf16 output) in the backward.  One forward kernel serves
both layouts: its output [B, P, Ph, Pw, C] is contiguous NHWC, so the flat
fc6 operand [B, P, Ph*Pw*C] is a view of the same bytes.

The forward has two paths, picked by :func:`forward_plan` from the shapes
alone: the shared-memory path (each block stages a slice of channels of one
image's map with TMA and pools a block of ROIs from it) wherever a 4-channel
slice fits a block's shared memory, the direct path (one block per (ROI,
bin), windows read from global memory) for larger maps.  Each wrapper
counts its launches in ``.launches`` and by path in ``.paths``.

``out_dtype=torch.bfloat16`` is the JAX package's bf16 output option: the
forward's values are ``bf16(max(feat))``, and the backward receives a bf16
cotangent and routes by the bf16-rounded feat (``ops/roi_pool.py:
roi_pool_grad_bf16``); feat stays f32 and gets an f32 dfeat.  Its kernels
are the f32 kernels' bf16 instances, with their own launch counters
(:func:`roi_pool_fc_bf16`, :func:`roi_pool_fc_backward_bf16`).

:func:`roi_pool_fc` is differentiable with respect to ``feat``: for CUDA
tensors a ``torch.autograd.Function`` whose forward launches the forward
kernel and whose backward launches the backward kernel of its output
dtype, saving only (feat, rois), never the pooled output.  For CPU tensors
it is :func:`roi_pool_fc_plain`, the same function with the plain forward
(``ops/roi_pool.py:roi_pool``) and the plain backward
(``ops/roi_pool.py:roi_pool_grad`` / ``roi_pool_grad_bf16``).  Neither
falls back to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wssdl_bus_tpu_torch.ops.roi_pool import (channel_block, roi_pool,
                                              roi_pool_grad,
                                              roi_pool_grad_bf16,
                                              rois_with_batch_index)

_FLAVORS = {"gpu": 0, "cpu": 1}
_SHORT_CELLS = 32767   # csrc/roi_pool.cu kShortCells
OUT_DTYPES = (torch.float32, torch.bfloat16)

# The forward's shared-memory path (csrc/roi_pool.cu, launch_forward_smem)
SMEM_PER_BLOCK = 232448   # bytes of shared memory a block may use on sm_90
SMEM_PER_SM = 233472      # an SM's shared memory; each block reserves 1 KB
SMS = 132                 # the H100 SXM's streaming multiprocessors
THREADS = 1024            # kFwdThreads: two blocks an SM at most
SLICES = (16, 8, 4)       # f32 channels a block stages, widest first
BOX_MAX = 256             # kBoxMax: a TMA box's largest dimension


def staged_tile_bytes(h: int, w: int, cs: int) -> int:
    """Shared-memory bytes of one image's ``cs``-channel slice as
    ``csrc/roi_pool.cu:fwd_tile`` lays it out: TMA boxes of at most 256 rows
    and columns (bands of whole rows, or pieces of each row of a map wider
    than 256), each in its own 128-byte aligned region."""
    if w <= BOX_MAX:
        nbx, bw = 1, w
        nby = -(-h // BOX_MAX)
        bh = -(-h // nby)
    else:
        nby, bh = h, 1
        nbx = -(-w // BOX_MAX)
        bw = -(-w // nbx)
    return nby * nbx * (-(-bh * bw * cs * 4 // 128) * 128)


def forward_plan(b: int, h: int, w: int, c: int, p: int, pooled_h: int = 7,
                 pooled_w: int = 7) -> tuple[int, int]:
    """The forward's path for [b, h, w, c] x [b, p, 4] (b, c, p >= 1):
    (channels a slice, ROIs a block) of the shared-memory path, or (0, 0)
    for the direct path.

    The shared-memory path takes 7 x 7 bins and the widest slice of 16, 8,
    4 channels (at most c) whose tile, with its block's bin edges, fits a
    block's shared memory.  Each block stages its whole slice, so blocks
    are few and large: the ROIs are cut into the number of blocks nearest
    one wave of resident blocks (132 SMs, one block of 16 channels or two
    of fewer an SM), at least one, more only where the edges would not
    fit."""
    if (pooled_h, pooled_w) != (7, 7):
        return 0, 0
    for cs in SLICES:
        if cs > c:
            continue
        tile = 128 + staged_tile_bytes(h, w, cs) + 16   # + the barrier
        edges = (pooled_h + pooled_w) * 4                # bytes a ROI
        if tile + edges > SMEM_PER_BLOCK:
            continue
        resident = min(SMEM_PER_SM // (tile + 1024), 2048 // THREADS)
        grid_x = -(-c // cs) * b
        n = min(p, max(1, round(SMS * resident / grid_x)))
        rblk = -(-p // n)
        rblk = min(rblk, (SMEM_PER_BLOCK - tile) // edges)
        return cs, rblk
    return 0, 0


@functools.lru_cache(maxsize=None)
def _lib():
    """(forward, backward) C entry points by output dtype."""
    from wssdl_bus_tpu_torch.ops import _build

    lib = _build.load("roi_pool")
    fwd_args = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 \
        + [ctypes.c_float] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    bwd_args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 4
    fns = {}
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        fwd = getattr(lib, f"wssdl_roi_pool_fwd{suffix}")
        bwd = getattr(lib, f"wssdl_roi_pool_bwd{suffix}")
        for fn, args in ((fwd, fwd_args), (bwd, bwd_args)):
            fn.restype = ctypes.c_int
            fn.argtypes = args
        fns[dtype] = (fwd, bwd)
    return fns


def _plain_forward(feat, rois, pooled_h, pooled_w, spatial_scale, flavor,
                   out_dtype):
    b, p, _ = rois.shape
    out = roi_pool(feat, rois_with_batch_index(rois), pooled_h, pooled_w,
                   spatial_scale, flavor)
    return out.reshape(b, p, pooled_h * pooled_w * feat.shape[-1]) \
        .to(out_dtype)


class _RoiPoolFc(torch.autograd.Function):
    """The pool with its backward: the kernels, whose forward launches
    count on the wrapper ``counter``, or with ``plain`` the plain versions.
    Saves (feat, rois) only, never the pooled output."""

    @staticmethod
    def forward(ctx, feat, rois, pooled_h, pooled_w, spatial_scale, flavor,
                out_dtype, plain, counter):
        ctx.save_for_backward(feat, rois)
        ctx.args = (pooled_h, pooled_w, spatial_scale, flavor)
        ctx.bf16 = out_dtype == torch.bfloat16
        ctx.plain = plain
        if plain:
            return _plain_forward(feat, rois, *ctx.args, out_dtype)
        return _launch_forward(feat, rois, *ctx.args, out_dtype,
                               counter=counter)

    @staticmethod
    def backward(ctx, grad):
        feat, rois = ctx.saved_tensors
        if ctx.plain:
            bwd = roi_pool_grad_bf16 if ctx.bf16 else roi_pool_grad
        else:
            bwd = roi_pool_fc_backward_bf16 if ctx.bf16 \
                else roi_pool_fc_backward
        dfeat = bwd(feat, rois, grad.contiguous(), *ctx.args)
        return dfeat, None, None, None, None, None, None, None, None


def roi_pool_fc_plain(feat: torch.Tensor, rois: torch.Tensor,
                      pooled_h: int = 7, pooled_w: int = 7,
                      spatial_scale: float = 1.0 / 16.0,
                      flavor: str = "gpu",
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of :func:`roi_pool_fc`, on any device, with the
    plain backward (``ops/roi_pool.py:roi_pool_grad``, or
    ``roi_pool_grad_bf16`` for a bf16 output) under autograd."""
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    return _RoiPoolFc.apply(feat, rois, pooled_h, pooled_w, spatial_scale,
                            flavor, out_dtype, True, None)


def _check_cuda(feat, rois, flavor, out_dtype=torch.float32):
    if feat.device.type != "cuda" or rois.device != feat.device:
        raise ValueError(f"roi_pool_fc: feat on {feat.device}, rois on "
                         f"{rois.device}; want both on one CUDA device or "
                         "both on the CPU")
    if feat.dtype != torch.float32 or rois.dtype != torch.float32:
        raise TypeError(f"roi_pool_fc takes f32 feat and rois, got "
                        f"{feat.dtype} / {rois.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if not (feat.is_contiguous() and rois.is_contiguous()):
        raise ValueError("roi_pool_fc takes contiguous feat and rois")
    b, h, w, c = feat.shape
    if rois.ndim != 3 or rois.shape[0] != b or rois.shape[2] != 4:
        raise ValueError(f"rois {tuple(rois.shape)}: want [{b}, P, 4]")
    if c % 4 or feat.data_ptr() % 16:
        raise ValueError(f"roi_pool_fc needs C % 4 == 0 and a 16-byte "
                         f"aligned feat (C = {c})")
    if flavor not in _FLAVORS:
        raise ValueError(f"flavor must be 'gpu' or 'cpu', got {flavor!r}")


def _launch_forward(feat, rois, pooled_h, pooled_w, spatial_scale, flavor,
                    out_dtype, plan=None, counter=None):
    """The forward kernel on :func:`forward_plan`'s path; ``plan`` (cs,
    rblk) overrides it, for measurements only (``chip_smoke.py``).  The
    launch counts on ``counter`` (a wrapper with ``.launches`` and
    ``.paths``; by default the wrapper of ``out_dtype``)."""
    b, h, w, c = feat.shape
    p = rois.shape[1]
    out = torch.empty((b, p, pooled_h * pooled_w * c), dtype=out_dtype,
                      device=feat.device)
    if b == 0 or p == 0 or c == 0:
        return out
    cs, rblk = plan or forward_plan(b, h, w, c, p, pooled_h, pooled_w)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()[out_dtype][0](
            feat.data_ptr(), rois.data_ptr(), b, h, w, c, p, pooled_h,
            pooled_w, float(spatial_scale), _FLAVORS[flavor], cs, rblk,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"roi_pool kernel launch failed: cudaError {err}")
    wrapper = counter or (roi_pool_fc_bf16 if out_dtype == torch.bfloat16
                          else roi_pool_fc)
    wrapper.launches += 1
    wrapper.paths["smem" if cs else "direct"] += 1
    return out


def _pool(feat, rois, pooled_h, pooled_w, spatial_scale, flavor, out_dtype,
          counter):
    """The differentiable pool of every wrapper: the plain versions for CPU
    tensors, else the kernels, their forward launches counted on
    ``counter``."""
    if feat.device.type == "cpu" and rois.device.type == "cpu":
        return roi_pool_fc_plain(feat, rois, pooled_h, pooled_w,
                                 spatial_scale, flavor, out_dtype)
    _check_cuda(feat, rois, flavor, out_dtype)
    return _RoiPoolFc.apply(feat, rois, pooled_h, pooled_w, spatial_scale,
                            flavor, out_dtype, False, counter)


def roi_pool_fc(feat: torch.Tensor, rois: torch.Tensor, pooled_h: int = 7,
                pooled_w: int = 7, spatial_scale: float = 1.0 / 16.0,
                flavor: str = "gpu",
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched ROI max pooling written as the flat fc6 operand,
    differentiable with respect to ``feat``.

    Args:
      feat: [B, H, W, C] f32 NHWC, contiguous, C % 4 == 0 on CUDA.
      rois: [B, P, 4] f32 (x1, y1, x2, y2) in input-image coordinates; ROI
        p of image b pools against feat[b].
      out_dtype: torch.float32, or torch.bfloat16 for the bf16 option.
    Returns [B, P, Ph*Pw*C] in ``out_dtype``, NHWC (ph, pw, c) flatten
    order.  The f32 launches count on ``roi_pool_fc.launches``, the bf16
    ones on ``roi_pool_fc_bf16.launches``, and by path (:func:`forward_plan`)
    on each wrapper's ``.paths``.
    """
    counter = roi_pool_fc_bf16 if out_dtype == torch.bfloat16 else roi_pool_fc
    return _pool(feat, rois, pooled_h, pooled_w, spatial_scale, flavor,
                 out_dtype, counter)


roi_pool_fc.launches = 0
roi_pool_fc.paths = {"smem": 0, "direct": 0}


def roi_pool_fc_bf16(feat: torch.Tensor, rois: torch.Tensor,
                     pooled_h: int = 7, pooled_w: int = 7,
                     spatial_scale: float = 1.0 / 16.0,
                     flavor: str = "gpu") -> torch.Tensor:
    """:func:`roi_pool_fc` with ``out_dtype=torch.bfloat16``."""
    return roi_pool_fc(feat, rois, pooled_h, pooled_w, spatial_scale,
                       flavor, torch.bfloat16)


roi_pool_fc_bf16.launches = 0
roi_pool_fc_bf16.paths = {"smem": 0, "direct": 0}


def _launch_backward(feat, rois, grad, pooled_h, pooled_w, spatial_scale,
                     flavor):
    """dfeat f32 from the backward kernel of ``grad``'s dtype."""
    _check_cuda(feat, rois, flavor)
    b, h, w, c = feat.shape
    p = rois.shape[1]
    if grad.device != feat.device or grad.dtype not in OUT_DTYPES:
        raise TypeError(f"grad must be f32 or bf16 on {feat.device}, got "
                        f"{grad.dtype} on {grad.device}")
    if grad.numel() != b * p * pooled_h * pooled_w * c \
            or grad.shape[:2] != (b, p):
        raise ValueError(f"grad {tuple(grad.shape)}: want [{b}, {p}, "
                         f"{pooled_h * pooled_w * c}]")
    if not grad.is_contiguous() or grad.data_ptr() % 16:
        raise ValueError("grad must be contiguous and 16-byte aligned")
    dfeat = torch.empty_like(feat)
    if b == 0:
        return dfeat
    # the kernels' scratch (csrc/roi_pool.cu, wssdl_roi_pool_bwd): row flags,
    # the compacted row list, each image's first position, the rows' marks,
    # the map rows' flags and counts, the channel blocks' flags; the argmax
    # table of cell indices y * w + x, int16 where they all fit
    nblk = c // channel_block(c) if c else 0
    work = torch.empty((4 * b * p + b + 1 + b * (5 * h + 1)
                        + -(-b * p * nblk // 4),), dtype=torch.int32,
                       device=feat.device)
    cell_dtype = torch.int16 if h * w <= _SHORT_CELLS else torch.int32
    table = torch.empty((max(b * p * pooled_h * pooled_w * c, 8),),
                        dtype=cell_dtype, device=feat.device)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()[grad.dtype][1](
            feat.data_ptr(), rois.data_ptr(), grad.data_ptr(), b, h, w, c, p,
            pooled_h, pooled_w, float(spatial_scale), _FLAVORS[flavor],
            work.data_ptr(), table.data_ptr(), dfeat.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"roi_pool backward kernel launch failed: "
                           f"cudaError {err}")
    return dfeat


def roi_pool_fc_backward(feat: torch.Tensor, rois: torch.Tensor,
                         grad: torch.Tensor, pooled_h: int = 7,
                         pooled_w: int = 7, spatial_scale: float = 1.0 / 16.0,
                         flavor: str = "gpu") -> torch.Tensor:
    """dfeat [B, H, W, C] of :func:`roi_pool_fc` for the f32 cotangent
    ``grad`` [B, P, Ph*Pw*C] (or its [B, P, Ph, Pw, C] view): the CUDA
    kernel for CUDA tensors, ``ops/roi_pool.py:roi_pool_grad`` for CPU
    tensors."""
    if all(t.device.type == "cpu" for t in (feat, rois, grad)):
        return roi_pool_grad(feat, rois, grad, pooled_h, pooled_w,
                             spatial_scale, flavor)
    if grad.dtype != torch.float32:
        raise TypeError(f"roi_pool_fc_backward takes an f32 grad, got "
                        f"{grad.dtype}")
    dfeat = _launch_backward(feat, rois, grad, pooled_h, pooled_w,
                             spatial_scale, flavor)
    roi_pool_fc_backward.launches += 1
    return dfeat


roi_pool_fc_backward.launches = 0


def roi_pool_fc_backward_bf16(feat: torch.Tensor, rois: torch.Tensor,
                              grad: torch.Tensor, pooled_h: int = 7,
                              pooled_w: int = 7,
                              spatial_scale: float = 1.0 / 16.0,
                              flavor: str = "gpu") -> torch.Tensor:
    """dfeat [B, H, W, C] (feat's dtype) of :func:`roi_pool_fc` with a bf16
    output, for the bf16 cotangent ``grad``: routing by the bf16-rounded
    feat.  The CUDA kernel for CUDA tensors (f32 feat), ``ops/roi_pool.py:
    roi_pool_grad_bf16`` for CPU tensors."""
    if all(t.device.type == "cpu" for t in (feat, rois, grad)):
        return roi_pool_grad_bf16(feat, rois, grad, pooled_h, pooled_w,
                                  spatial_scale, flavor)
    if grad.dtype != torch.bfloat16:
        raise TypeError(f"roi_pool_fc_backward_bf16 takes a bf16 grad, got "
                        f"{grad.dtype}")
    dfeat = _launch_backward(feat, rois, grad, pooled_h, pooled_w,
                             spatial_scale, flavor)
    roi_pool_fc_backward_bf16.launches += 1
    return dfeat


roi_pool_fc_backward_bf16.launches = 0


def roi_pool_grouped(feat: torch.Tensor, rois: torch.Tensor,
                     pooled_h: int = 7, pooled_w: int = 7,
                     spatial_scale: float = 1.0 / 16.0,
                     flavor: str = "gpu") -> torch.Tensor:
    """Batched ROI max pooling with per-image ROI groups, the ResNet head's
    pool (``roi_pool_image`` / ``roi_pool_grouped`` of the JAX package, its
    Pallas ``_fwd_kernel`` and ``_bwd_kernel``): [B, H, W, C] x [B, P, 4]
    -> [B, P, Ph, Pw, C] f32, differentiable with respect to ``feat``.

    The forward kernel's output is contiguous NHWC, so this is the same
    launch as :func:`roi_pool_fc`'s, viewed 5-D; its launches count on
    ``roi_pool_grouped.launches`` / ``.paths`` (not on ``roi_pool_fc``'s),
    the backward's on ``roi_pool_fc_backward.launches``.  CPU tensors take
    :func:`roi_pool_grouped_plain`."""
    b, p, _ = rois.shape
    return _pool(feat, rois, pooled_h, pooled_w, spatial_scale, flavor,
                 torch.float32, roi_pool_grouped).view(
        b, p, pooled_h, pooled_w, feat.shape[-1])


roi_pool_grouped.launches = 0
roi_pool_grouped.paths = {"smem": 0, "direct": 0}


def roi_pool_grouped_plain(feat: torch.Tensor, rois: torch.Tensor,
                           pooled_h: int = 7, pooled_w: int = 7,
                           spatial_scale: float = 1.0 / 16.0,
                           flavor: str = "gpu") -> torch.Tensor:
    """The plain version of :func:`roi_pool_grouped` on any device:
    :func:`roi_pool_fc_plain` (plain forward, plain backward) viewed
    5-D."""
    b, p, _ = rois.shape
    return roi_pool_fc_plain(feat, rois, pooled_h, pooled_w, spatial_scale,
                             flavor).view(b, p, pooled_h, pooled_w,
                                          feat.shape[-1])
