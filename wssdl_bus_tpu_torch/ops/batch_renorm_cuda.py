"""Training-mode BatchRenorm (+ ReLU): the CUDA kernels of
``csrc/batch_renorm.cu`` and their dispatch.

Port-only: the JAX package's ``BatchRenorm`` (``wssdl_bus_tpu/models/
layers.py``) has no Pallas kernel, XLA fuses it on the TPU.
:func:`batch_renorm_train` is a ``torch.autograd.Function`` whose forward
takes two passes over ``x`` (the statistics, then the output) and whose
backward takes two over ``x`` and the cotangent (the sums, then ``dx``),
each pass followed or preceded by a small per-channel launch: three
launches a forward, three a backward, counted in
``batch_renorm_train.launches`` and by kernel in
``batch_renorm_train.by_kernel``.  It saves ``x`` and six per-channel
vectors, never the output, ``x - mean`` or a ReLU mask.

A CUDA tensor must be f32 and channels_last (the layout the card's modules
run in) and launches the kernels or raises; a CPU tensor takes the plain
version (``ops/batch_renorm.py``), the same arithmetic in PyTorch ops.
Neither falls back to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wssdl_bus_tpu_torch.ops.batch_renorm import (
    VECS, batch_renorm_backward_plain, batch_renorm_forward_plain)

SMS = 132              # the H100 SXM's streaming multiprocessors
THREADS = 256          # csrc/batch_renorm.cu kThreads
BLOCKS_PER_SM = 4      # kMinBlocks: the blocks an SM holds at once
BATCH = 8              # kBatch: rows the statistics pass loads at once
KERNELS = ("stats", "finalize", "apply", "grad_sums", "grad_finalize",
           "grad_x")


def plan(rows: int, channels: int, vec: int) -> tuple[int, int, int, int]:
    """(cs, lanes, tiles, rpt) of the passes over an [rows, channels]
    tensor read ``vec`` channels a thread: blocks of ``cs`` channel groups
    (at most 256 channels) by ``lanes`` rows, and ``tiles`` row tiles of
    ``rpt`` rows (the last one may hold fewer).  The tiles are as many as
    make four blocks an SM with the channel slices (one wave, all
    resident), fewer only where a lane would get less than ``BATCH`` rows
    of its tile."""
    groups = channels // vec
    cs = min(groups, THREADS // vec)
    lanes = THREADS // cs
    slices = -(-groups // cs)
    tiles = -(-SMS * BLOCKS_PER_SM // slices)
    tiles = max(1, min(tiles, rows // (lanes * BATCH)))
    rpt = -(-rows // tiles)
    return cs, lanes, -(-rows // rpt), rpt


@functools.lru_cache(maxsize=None)
def _lib():
    from wssdl_bus_tpu_torch.ops import _build

    lib = _build.load("batch_renorm")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.wssdl_batch_renorm_fwd.restype = i
    lib.wssdl_batch_renorm_fwd.argtypes = [p] * 5 + [i, f, f, f, i, ll] \
        + [i] * 5 + [ll] + [p] * 4
    lib.wssdl_batch_renorm_bwd.restype = i
    lib.wssdl_batch_renorm_bwd.argtypes = [p] * 3 + [i, ll] + [i] * 5 \
        + [ll] + [p] * 6
    return lib


def _rows_channels(x: torch.Tensor) -> tuple[int, int]:
    if x.ndim != 4:
        raise ValueError(f"batch_renorm_train takes a 4-D NCHW tensor on "
                         f"the card, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"batch_renorm_train takes f32, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("batch_renorm_train takes a channels_last tensor "
                         "on the card")
    c = x.shape[1]
    rows = x.numel() // c if c else 0
    if rows == 0 or c == 0:
        raise ValueError(f"batch_renorm_train: empty input "
                         f"{tuple(x.shape)}")
    return rows, c


def _vec(c: int, *tensors) -> int:
    """4 channels a thread (16-byte loads) where every tensor allows it."""
    return 4 if c % 4 == 0 and all(t.data_ptr() % 16 == 0
                                   for t in tensors) else 1


def _count(*names):
    for n in names:
        batch_renorm_train.by_kernel[n] += 1
    batch_renorm_train.launches += len(names)


def _forward_cuda(x, gamma, beta, ra_mean, ra_var, update: bool,
                  momentum: float, eps: float, relu: bool):
    rows, c = _rows_channels(x)
    for name, t in (("gamma", gamma), ("beta", beta), ("ra_mean", ra_mean),
                    ("ra_var", ra_var)):
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != (c,) or not t.is_contiguous()):
            raise ValueError(f"batch_renorm_train: {name} must be a "
                             f"contiguous f32 [{c}] on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    vec = _vec(c, x)
    cs, lanes, tiles, rpt = plan(rows, c, vec)
    part = torch.empty(tiles * 2 * c, dtype=torch.float32, device=x.device)
    vecs = torch.empty((len(VECS), c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().wssdl_batch_renorm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            ra_mean.data_ptr(), ra_var.data_ptr(), int(update),
            float(momentum), float(1.0 - momentum), float(eps), int(relu),
            rows, c, vec, cs, lanes, tiles, rpt, part.data_ptr(),
            vecs.data_ptr(), y.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"batch_renorm forward launch failed: "
                           f"cudaError {err}")
    _count("stats", "finalize", "apply")
    return y, vecs


def _backward_cuda(x, dy, vecs, relu: bool):
    rows, c = _rows_channels(x)
    dy = dy.contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    vec = _vec(c, x, dy)
    cs, lanes, tiles, rpt = plan(rows, c, vec)
    part = torch.empty(tiles * 2 * c, dtype=torch.float32, device=x.device)
    coef = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().wssdl_batch_renorm_bwd(
            x.data_ptr(), dy.data_ptr(), vecs.data_ptr(), int(relu), rows,
            c, vec, cs, lanes, tiles, rpt, part.data_ptr(), coef.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), dx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"batch_renorm backward launch failed: "
                           f"cudaError {err}")
    _count("grad_sums", "grad_finalize", "grad_x")
    return dx, dgamma, dbeta


def _route(x: torch.Tensor, cuda, plain):
    if x.device.type == "cuda":
        return cuda
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"batch_renorm_train runs on CUDA or the CPU, got "
                     f"{x.device}")


class _BatchRenorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, ra_mean, ra_var, update, momentum, eps,
                relu):
        fwd = _route(x, _forward_cuda, batch_renorm_forward_plain)
        y, vecs = fwd(x, gamma, beta, ra_mean, ra_var, update, momentum,
                      eps, relu)
        ctx.save_for_backward(x, vecs)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, vecs = ctx.saved_tensors
        bwd = _route(x, _backward_cuda, batch_renorm_backward_plain)
        dx, dgamma, dbeta = bwd(x, dy, vecs, ctx.relu)
        return dx, dgamma, dbeta, None, None, None, None, None, None


def batch_renorm_train(x, gamma, beta, ra_mean, ra_var, update: bool = True,
                       momentum: float = 0.99, eps: float = 1e-3,
                       relu: bool = False) -> torch.Tensor:
    """Training-mode BatchRenorm of ``x`` [N, C, H, W] f32 (+ ReLU):
    ``ops/batch_renorm.py:batch_renorm_forward_plain``'s function,
    differentiable in ``x``, ``gamma`` and ``beta``, with the running
    statistics ``ra_mean`` / ``ra_var`` read and, where ``update`` holds,
    updated in place."""
    return _BatchRenorm.apply(x, gamma, beta, ra_mean, ra_var, bool(update),
                              float(momentum), float(eps), bool(relu))


batch_renorm_train.launches = 0
batch_renorm_train.by_kernel = dict.fromkeys(KERNELS, 0)
