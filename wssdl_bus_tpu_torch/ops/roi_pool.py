"""ROI max pooling with the reference TF op's exact semantics, plain PyTorch.

The plain version of the CUDA kernel in ``csrc/roi_pool.cu`` (wrappers in
``ops/roi_pool_cuda.py``), and the counterpart of the JAX package's
``ops/roi_pool.py:roi_pool``.  Semantics (see ``tests/oracles.py``):

  * ROI corners quantised with round-half-away-from-zero, ``floor(x + 0.5)``
    on the f32 product ``v * spatial_scale``;
  * malformed ROIs forced to 1x1 (``max(end - start + 1, 1)``);
  * bin edges per ``flavor``: ``"gpu"`` (default) the reference CUDA
    kernel's floor/ceil edges, ``"cpu"`` its CPU kernel's truncated edges,
    both as exact integer arithmetic and clipped to the feature extent;
  * empty bins output 0.

Formulation: per chunk of ROIs, bin windows become boolean masks along H and
W, and the pool is two masked max reductions (rows, then columns).  Max is
exact, so this equals the kernel bit for bit.
"""

from __future__ import annotations

import torch

_CHUNK_BYTES = 1 << 28   # bound on the [R, Ph, H, W, C] row-stage temporary


def _bin_masks(start_q, size_q, pooled: int, limit: int, flavor: str):
    """Per-ROI [R, pooled, limit] window masks along one axis, and the
    [R, pooled] non-empty flags.  start_q/size_q: [R] int64, size >= 1.
    Every operand of the floor divisions is non-negative."""
    k = torch.arange(pooled, device=start_q.device)[None, :]
    lo = (k * size_q[:, None]) // pooled + start_q[:, None]
    if flavor == "gpu":
        hi = ((k + 1) * size_q[:, None] + (pooled - 1)) // pooled \
            + start_q[:, None]
    elif flavor == "cpu":
        hi = ((k + 1) * size_q[:, None]) // pooled + start_q[:, None]
    else:
        raise ValueError(f"flavor must be 'gpu' or 'cpu', got {flavor!r}")
    lo = lo.clamp(0, limit)
    hi = hi.clamp(0, limit)
    idx = torch.arange(limit, device=start_q.device)
    mask = (idx[None, None, :] >= lo[..., None]) & (idx < hi[..., None])
    return mask, hi > lo


def rois_with_batch_index(rois: torch.Tensor) -> torch.Tensor:
    """[B, P, 4] per-image ROIs -> the reference's [B*P, 5] roi blob
    (batch_idx, x1, y1, x2, y2)."""
    b, p, _ = rois.shape
    idx = torch.arange(b, dtype=rois.dtype, device=rois.device)
    return torch.cat([idx[:, None, None].expand(b, p, 1), rois],
                     dim=-1).reshape(b * p, 5)


def quantize_rois(rois: torch.Tensor, spatial_scale: float):
    """[R, 4] (x1, y1, x2, y2) -> (rsw, rsh, roi_w, roi_h), each [R] int64."""
    q = torch.floor(rois * spatial_scale + 0.5).to(torch.int64)
    rsw, rsh, rew, reh = q.unbind(dim=1)
    return rsw, rsh, (rew - rsw + 1).clamp_min(1), (reh - rsh + 1).clamp_min(1)


def roi_pool(feat: torch.Tensor, rois: torch.Tensor, pooled_h: int = 7,
             pooled_w: int = 7, spatial_scale: float = 1.0 / 16.0,
             flavor: str = "gpu") -> torch.Tensor:
    """ROI max pooling.

    Args:
      feat: [B, H, W, C] feature maps (NHWC).
      rois: [R, 5] rows of (batch_idx, x1, y1, x2, y2) in input-image coords.
      flavor: 'gpu' (reference CUDA bin edges, default) or 'cpu'.
    Returns [R, pooled_h, pooled_w, C] in feat's dtype.
    """
    _, h, w, c = feat.shape
    r = rois.shape[0]
    out = feat.new_zeros((r, pooled_h, pooled_w, c))
    if r == 0:
        return out
    b_idx = rois[:, 0].to(torch.int64)
    rsw, rsh, roi_w, roi_h = quantize_rois(rois[:, 1:5], spatial_scale)
    h_mask, h_ok = _bin_masks(rsh, roi_h, pooled_h, h, flavor)  # [R, Ph, H]
    w_mask, w_ok = _bin_masks(rsw, roi_w, pooled_w, w, flavor)  # [R, Pw, W]
    empty = ~(h_ok[:, :, None] & w_ok[:, None, :])              # [R, Ph, Pw]
    neg_inf = torch.tensor(float("-inf"), dtype=feat.dtype,
                           device=feat.device)
    step = max(1, _CHUNK_BYTES // (pooled_h * h * w * c * feat.element_size()))
    for s in range(0, r, step):
        e = min(s + step, r)
        fb = feat[b_idx[s:e]]                                   # [R, H, W, C]
        rows = torch.where(h_mask[s:e, :, :, None, None], fb[:, None],
                           neg_inf).amax(dim=2)                 # [R, Ph, W, C]
        cols = torch.where(w_mask[s:e, None, :, :, None], rows[:, :, None],
                           neg_inf).amax(dim=3)                 # [R, Ph, Pw, C]
        out[s:e] = torch.where(empty[s:e, :, :, None],
                               torch.zeros((), dtype=feat.dtype,
                                           device=feat.device), cols)
    return out
