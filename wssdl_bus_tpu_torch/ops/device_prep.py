"""Device-side preparation of the training feed (counterpart of
``wssdl_bus_tpu/ops/device_prep.py``).

The host stages each training image as raw uint8 ([B, Hr, Wr], decoded,
flipped, and for weak images rotated and cropped, every random draw
already made: ``data/minibatch.py:_pack_raw``) plus one row of parameters
([B, 8] f32: ``IH, IW, OH, OW, DELTA, FACTOR, CMEAN``).  The step finishes
the blob on the device, in ``prep_image``'s order (``data/augment.py``):
brightness shift and clip, contrast about the post-brightness mean and
clip, mean subtraction, the bilinear resize of the top-left (IH, IW)
region to (OH, OW), zero beyond (OH, OW), x255 for VGG and the gray
channel broadcast to 3.  The upload is the uint8 image, about 1/21 of the
f32 3-channel canvas it replaces.

The resize is ``jax.image.scale_and_translate(..., method="linear",
antialias=True)`` with translation 0, which ``F.interpolate`` is not: its
scale comes per image from the parameters at run time, and a downscale
widens the triangle kernel.  :func:`resize_weights` builds the weight
matrices as ``jax/_src/image/scale.py:compute_weight_mat`` does, on the
device, and the resize is two batched f32 products (rows, then columns).
Those products are exact f32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default.

Numerics against the host path: unrotated images are staged exactly (the
decode is uint8) and the resize matches the native/PIL half-pixel resize
to ~4e-6 of the [0, 1] range on an upscale, so supervised images match the
host blob to float rounding.  A rotated weak image is re-quantised to uint8
(at most 1/510 of the range, times the contrast factor afterwards).
"""

from __future__ import annotations

import torch

# the prep-parameter row ([B, 8] float32), built by
# data/minibatch.py:_pack_raw
IH, IW, OH, OW, DELTA, FACTOR, CMEAN, _PAD = range(8)
N_PREP = 8

_F32_EPS = float(torch.finfo(torch.float32).eps)


def resize_weights(in_size: int, out_size: int,
                   scale: torch.Tensor) -> torch.Tensor:
    """Per-image linear antialiased resize weights [B, in_size, out_size]
    for scales ``scale`` [B] f32 (output = input x scale): the triangle
    kernel widened by max(1 / scale, 1), half-pixel sample points, each
    output column normalised by its sum (0 where the sum is ~0), and 0 for
    a sample point outside [-0.5, in_size - 0.5]."""
    dev = scale.device
    inv = (1.0 / scale.to(torch.float32))[:, None, None]          # [B,1,1]
    kernel_scale = torch.clamp(inv, min=1.0)
    out_i = torch.arange(out_size, dtype=torch.float32, device=dev)
    in_i = torch.arange(in_size, dtype=torch.float32, device=dev)
    sample_f = (out_i[None, None, :] + 0.5) * inv - 0.5           # [B,1,out]
    x = torch.abs(sample_f - in_i[None, :, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def prep_device_batch(raw: torch.Tensor, prep: torch.Tensor, out_hw,
                      pixel_mean: float, net_divisor: float) -> torch.Tensor:
    """raw [B, Hr, Wr] uint8 + prep [B, 8] f32 -> [B, H, W, 3] float32,
    contiguous: the layout of the host ``data`` blob
    (``data/minibatch.py:_pack``).

    ``pixel_mean`` is cfg.PIXEL_MEAN / 255; ``net_divisor`` the final
    factor (255 for VGG, 255 / cfg.PIXEL_STD for ResNet)."""
    b, hr, wr = raw.shape
    h, w = out_hw
    prep = prep.to(torch.float32)

    def col(k):
        return prep[:, k, None, None]

    x = raw.to(torch.float32) * (1.0 / 255.0)
    # brightness (delta 0 when off: clip(x + 0) == x on [0, 1])
    x = torch.clamp(x + col(DELTA), 0.0, 1.0)
    # contrast about the post-brightness mean (factor 1 when off)
    x = torch.clamp((x - col(CMEAN)) * col(FACTOR) + col(CMEAN), 0.0, 1.0)
    x = x - pixel_mean
    # the resize of the top-left (IH, IW) region: with translation 0 the
    # sample points depend on the scale only; the host's edge-replicated
    # padding supplies the taps past the image
    wh = resize_weights(hr, h, prep[:, OH] / prep[:, IH])         # [B,Hr,H]
    ww = resize_weights(wr, w, prep[:, OW] / prep[:, IW])         # [B,Wr,W]
    y = torch.bmm(torch.bmm(wh.transpose(1, 2), x), ww)           # [B,H,W]
    rows = torch.arange(h, dtype=torch.float32, device=raw.device)
    cols = torch.arange(w, dtype=torch.float32, device=raw.device)
    inside = ((rows[None, :, None] < col(OH))
              & (cols[None, None, :] < col(OW)))
    y = torch.where(inside, y * net_divisor, torch.zeros_like(y))
    return y[..., None].expand(b, h, w, 3).contiguous()


def net_divisor_for(net_name: str, pixel_std: float) -> float:
    """``augment.prep_image``'s final scale (VGG x255, ResNet
    /(PIXEL_STD/255)) as one multiplier."""
    if net_name[:6] == "Resnet":
        return 255.0 / pixel_std
    return 255.0
