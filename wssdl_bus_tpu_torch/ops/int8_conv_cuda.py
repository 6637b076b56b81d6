"""The int8 convolution: the CUDA kernel ``csrc/int8_conv.cu``, its tile
plan and its dispatch.

No TPU kernel is replaced: the JAX package's int8 conv is XLA's s8 x s8 ->
s32 convolution (``wssdl_bus_tpu/models/quantize.py:127``).
:func:`int8_conv` launches the kernel for CUDA tensors and takes the plain
version (``ops/int8_conv.py:int8_conv_plain``) for CPU tensors; it never
falls back from one to the other.  The kernel equals the plain version bit
for bit (``ops/int8_conv.py``), with f32 or int8 output.

:func:`tile_plan` picks the kernel's path and M tile, a patch of ``bn``
images x ``bh`` rows x ``bw`` columns of output pixels, from the shape
alone; ``tests/test_torch_int8_conv.py`` emulates the kernel's index
algebra (tiles, TMA boxes, taps, the halo path's planes and descriptors,
the Cin = 3 path's staged patch) over it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from wssdl_bus_tpu_torch.ops.int8_conv import (K_STEP, conv_pads,
                                               int8_conv_plain)

PLAN_SMS = 132       # the H100's SMs: the TMA path's tiles run in waves
PATCH_MAX = 8192     # csrc/int8_conv.cu kPatchMax: the Cin = 3 path's patch
SMALL_KPAD = 192     # csrc/int8_conv.cu kSmallKpad
HALO_TH, HALO_TW = 8, 16    # csrc/int8_conv.cu kHaloTH / kHaloTW


class Plan(NamedTuple):
    bw: int          # output columns of the M tile
    bh: int          # output rows
    bn: int          # images
    rows: int        # the tile's M rows (>= bw * bh * bn)
    path: str        # "tma", "halo" or "small" (csrc/int8_conv.cu)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _best_patch(b, ho, wo, ntn, rows, stride, fits, waves):
    """The patch of at most ``rows`` pixels with the fewest tiles (weighed
    in waves of PLAN_SMS on the persistent TMA path), then the fewest
    images, then the widest; -> (cost, (bw, bh, bn))."""
    best = None
    for bw in range(1, min(wo, rows, 256 // stride) + 1):
        for bh in range(1, min(ho, rows // bw, 256 // stride) + 1):
            bn = min(rows // (bw * bh), b, 256)
            if not fits(bw, bh, bn):
                continue
            tiles = _cdiv(wo, bw) * _cdiv(ho, bh) * _cdiv(b, bn) * ntn
            cost = _cdiv(tiles, PLAN_SMS) * rows if waves else tiles * rows
            key = (cost, tiles, bn, -bw)
            if best is None or key < best[0]:
                best = (key, (bw, bh, bn))
    return best[0][0], best[1]


@functools.lru_cache(maxsize=None)
def tile_plan(b: int, h: int, w: int, cin: int, cout: int, k: int,
              stride: int) -> Plan:
    """The kernel's path and M tile for a k x k / stride conv of [b, h, w,
    cin] to ``cout`` channels.  3x3 at stride 1 from 64 channels to 64 or
    128: the halo path, a warpgroup's tile 8 x 16 pixels of one image
    (128 rows); else Cin % 64 == 0: the TMA path, 256 rows (two
    warpgroups of 2 x m64); Cin < 16: the Cin = 3 path, 256 rows too (a
    thread a row), the staged patch within PATCH_MAX bytes."""
    _, _, (ho, wo) = conv_pads(h, w, k, k, stride)
    if (k, stride, cin) == (3, 1, K_STEP) and cout in (64, 128):
        return Plan(HALO_TW, HALO_TH, 1, HALO_TW * HALO_TH, "halo")
    if cin % K_STEP == 0:
        ntn = cout // (128 if cout % 128 == 0 else 64)
        return Plan(*_best_patch(b, ho, wo, ntn, 256, stride,
                                 lambda *_: True, True)[1], 256, "tma")
    if cin < 16 and cout == 64 and _cdiv(k * k * cin, K_STEP) * K_STEP \
            <= SMALL_KPAD:
        def fits(bw, bh, bn):
            return bn * ((bh - 1) * stride + k) * ((bw - 1) * stride + k) \
                * cin <= PATCH_MAX
        return Plan(*_best_patch(b, ho, wo, 1, 256, stride, fits, False)[1],
                    256, "small")
    raise ValueError(f"int8_conv: no kernel path for Cin {cin}, Cout {cout}, "
                     f"{k}x{k} (Cin % 64 == 0, or Cin < 16 with Cout 64 and "
                     f"K <= {SMALL_KPAD})")


@functools.lru_cache(maxsize=None)
def _lib():
    from wssdl_bus_tpu_torch.ops import _build

    fn = _build.load("int8_conv").wssdl_int8_conv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 18 \
        + [ctypes.c_void_p]
    return fn


def int8_conv(xq: torch.Tensor, packed: torch.Tensor, kh: int, kw: int,
              scale: torch.Tensor, bias: torch.Tensor, stride: int = 1,
              relu: bool = False,
              out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """``[relu](float(acc) * scale + bias)`` of the TF "SAME" s8 x s8 -> s32
    conv of ``xq`` (int8 NHWC [B, H, W, Cin], contiguous) with ``packed``
    (``ops/int8_conv.py:pack_weight`` of an int8 HWIO [kh, kw, Cin, Cout]
    kernel); scale, bias f32 [Cout] -> f32 NHWC [B, ceil(H/s), ceil(W/s),
    Cout], or with ``out_scale`` (the next layer's input scale, a 0-d f32
    tensor on xq's device, read by the kernel there) its int8 quantization
    ``ops/int8_conv.py:quantize``.  One kernel launch per call on a CUDA
    tensor."""
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, packed, kh, kw, scale, bias, stride, relu,
                               out_scale)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv: xq on {xq.device}; want a CUDA device "
                         "or the CPU")
    if xq.dtype != torch.int8 or xq.ndim != 4 or not xq.is_contiguous() \
            or xq.data_ptr() % 16:
        raise ValueError(f"int8_conv: want a contiguous, 16-byte aligned "
                         f"int8 NHWC xq, got {xq.dtype} {tuple(xq.shape)}")
    b, h, w, cin = xq.shape
    cout, kpad = packed.shape
    if packed.dtype != torch.int8 or not packed.is_contiguous() \
            or packed.data_ptr() % 16 or packed.device != xq.device \
            or kpad % K_STEP \
            or kpad < kh * kw * cin or cout % 64 or kh != kw:
        raise ValueError(f"int8_conv: packed weights {packed.dtype} "
                         f"{tuple(packed.shape)} on {packed.device} do not "
                         f"fit a {kh}x{kw}x{cin} kernel (Cout % 64 == 0, "
                         f"Kpad % {K_STEP} == 0)")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != xq.device \
                or tuple(t.shape) != (cout,) or not t.is_contiguous():
            raise ValueError(f"int8_conv: {name} must be a contiguous f32 "
                             f"[{cout}] on {xq.device}")
    if out_scale is not None and (
            out_scale.dtype != torch.float32 or out_scale.numel() != 1
            or out_scale.device != xq.device):
        raise ValueError(f"int8_conv: out_scale must be one f32 on "
                         f"{xq.device}")
    plan = tile_plan(b, h, w, cin, cout, kh, stride)
    (pt, _), (pl, _), (ho, wo) = conv_pads(h, w, kh, kw, stride)
    out = torch.empty((b, ho, wo, cout), dtype=torch.float32
                      if out_scale is None else torch.int8, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(xq.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                     bias.data_ptr(), None if out_scale is None
                     else out_scale.data_ptr(), out.data_ptr(), b, h, w, cin,
                     ho, wo, cout, kh, kw, stride, pt, pl, kpad, int(relu),
                     plan.bw, plan.bh, plan.bn, plan.rows, stream)
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: cudaError {err}")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
