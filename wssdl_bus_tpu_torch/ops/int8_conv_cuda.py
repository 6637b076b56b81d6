"""The int8 convolution: the CUDA kernel ``csrc/int8_conv.cu`` and its
dispatch.

No TPU kernel is replaced: the JAX package's int8 conv is XLA's s8 x s8 ->
s32 convolution (``wssdl_bus_tpu/models/quantize.py:127``).
:func:`int8_conv` launches the kernel for CUDA tensors and takes the plain
version (``ops/int8_conv.py:int8_conv_plain``) for CPU tensors; it never
falls back from one to the other.  The kernel equals the plain version bit
for bit (``ops/int8_conv.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wssdl_bus_tpu_torch.ops.int8_conv import (K_STEP, conv_pads,
                                               int8_conv_plain)


@functools.lru_cache(maxsize=None)
def _lib():
    from wssdl_bus_tpu_torch.ops import _build

    fn = _build.load("int8_conv").wssdl_int8_conv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 \
        + [ctypes.c_void_p]
    return fn


def int8_conv(xq: torch.Tensor, packed: torch.Tensor, kh: int, kw: int,
              scale: torch.Tensor, bias: torch.Tensor, stride: int = 1,
              relu: bool = False) -> torch.Tensor:
    """``[relu](float(acc) * scale + bias)`` of the TF "SAME" s8 x s8 -> s32
    conv of ``xq`` (int8 NHWC [B, H, W, Cin], contiguous) with ``packed``
    (``ops/int8_conv.py:pack_weight`` of an int8 HWIO [kh, kw, Cin, Cout]
    kernel); scale, bias f32 [Cout] -> f32 NHWC [B, ceil(H/s), ceil(W/s),
    Cout].  One kernel launch per call on a CUDA tensor."""
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, packed, kh, kw, scale, bias, stride, relu)
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
            or kpad < kh * kw * cin or cout % 64:
        raise ValueError(f"int8_conv: packed weights {packed.dtype} "
                         f"{tuple(packed.shape)} on {packed.device} do not "
                         f"fit a {kh}x{kw}x{cin} kernel (Cout % 64 == 0, "
                         f"Kpad % {K_STEP} == 0)")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != xq.device \
                or tuple(t.shape) != (cout,) or not t.is_contiguous():
            raise ValueError(f"int8_conv: {name} must be a contiguous f32 "
                             f"[{cout}] on {xq.device}")
    (pt, _), (pl, _), (ho, wo) = conv_pads(h, w, kh, kw, stride)
    out = torch.empty((b, ho, wo, cout), dtype=torch.float32,
                      device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(xq.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                     bias.data_ptr(), out.data_ptr(), b, h, w, cin, ho, wo,
                     cout, kh, kw, stride, pt, pl, kpad, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: cudaError {err}")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
