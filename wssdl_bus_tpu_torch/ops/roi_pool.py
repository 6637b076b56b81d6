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

:func:`roi_pool_grad` is the backward: the plain version of the CUDA kernel
``wssdl_roi_pool_bwd`` and the counterpart of the Pallas kernel
``wssdl_bus_tpu/ops/roi_pool_pallas.py:_bwd_kernel``, whose placement and
order of sums it follows (not ``amax``'s autograd, which splits ties).
:func:`roi_pool_grad_bf16` is the backward of the bf16 output option
(``_fc_bwd_kernel``).
"""

from __future__ import annotations

import torch

_CHUNK_BYTES = 1 << 28   # bound on the [R, Ph, H, W, C] row-stage temporary


def bin_edges(start_q, size_q, pooled: int, limit: int, flavor: str):
    """Per-ROI bin edges along one axis: (lo, hi), each [R, pooled] int64,
    bin k spanning [lo, hi) clipped to [0, limit].  start_q/size_q: [R]
    int64, size >= 1.  Every operand of the floor divisions is
    non-negative."""
    k = torch.arange(pooled, device=start_q.device)[None, :]
    lo = (k * size_q[:, None]) // pooled + start_q[:, None]
    if flavor == "gpu":
        hi = ((k + 1) * size_q[:, None] + (pooled - 1)) // pooled \
            + start_q[:, None]
    elif flavor == "cpu":
        hi = ((k + 1) * size_q[:, None]) // pooled + start_q[:, None]
    else:
        raise ValueError(f"flavor must be 'gpu' or 'cpu', got {flavor!r}")
    return lo.clamp(0, limit), hi.clamp(0, limit)


def _bin_masks(start_q, size_q, pooled: int, limit: int, flavor: str):
    """Per-ROI [R, pooled, limit] window masks along one axis, and the
    [R, pooled] non-empty flags."""
    lo, hi = bin_edges(start_q, size_q, pooled, limit, flavor)
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


def active_rows(grad: torch.Tensor) -> torch.Tensor:
    """[B, P, ...] cotangent -> [B, P] bool: the ROIs whose cotangent row
    has a nonzero (or NaN) entry.  The others contribute nothing to the
    backward and are skipped; in the weak group only the MIL-selected ROI
    of each bag has one."""
    return (grad != 0).flatten(2).any(dim=2)


def roi_pool_grad(feat: torch.Tensor, rois: torch.Tensor, grad: torch.Tensor,
                  pooled_h: int = 7, pooled_w: int = 7,
                  spatial_scale: float = 1.0 / 16.0,
                  flavor: str = "gpu") -> torch.Tensor:
    """The VJP of batched ROI max pooling with respect to ``feat``.

    Args:
      feat: [B, H, W, C] the forward's feature maps.
      rois: [B, P, 4] (x1, y1, x2, y2); ROI p of image b pooled feat[b].
      grad: the cotangent, [B, P, Ph*Pw*C] (the flat fc6 operand's) or any
        shape with the same B, P and element order [B, P, Ph, Pw, C].
    Returns dfeat [B, H, W, C].

    Placement, as the Pallas kernel's: for a non-empty bin (i, j) and a
    channel, w* is the first column of the bin whose column maximum (over
    the bin's rows) equals the bin maximum, h* the first row of the bin
    attaining that column maximum; the bin's whole cotangent goes to
    (h*, w*).  Order of sums, also the kernel's: ROIs ascending; within a
    ROI, bin rows i ascending; within a row, the cotangents of the bins
    that share a column are summed in j order first, and that sum is added
    to the cell.  ROIs with an all-zero cotangent row are skipped."""
    b, h, w, c = feat.shape
    p = rois.shape[1]
    g = grad.reshape(b, p, pooled_h, pooled_w, c)
    dfeat = torch.zeros_like(feat)
    if b == 0 or p == 0:
        return dfeat
    rsw, rsh, roi_w, roi_h = quantize_rois(rois.reshape(-1, 4),
                                           spatial_scale)
    hlo, hhi = bin_edges(rsh, roi_h, pooled_h, h, flavor)     # [B*P, Ph]
    wlo, whi = bin_edges(rsw, roi_w, pooled_w, w, flavor)     # [B*P, Pw]
    ar_h = torch.arange(h, device=feat.device)
    ar_w = torch.arange(w, device=feat.device)
    neg_inf = torch.tensor(float("-inf"), dtype=feat.dtype,
                           device=feat.device)
    for bi, r in active_rows(g).nonzero().tolist():
        q = bi * p + r
        f = feat[bi]
        # rows stage: each row bin's column maxima and their first rows
        hm = (ar_h >= hlo[q][:, None]) & (ar_h < hhi[q][:, None])  # [Ph, H]
        rows = torch.where(hm[:, :, None, None], f[None], neg_inf)
        h_star = rows.argmax(dim=1)                          # [Ph, W, C]
        col_max = rows.gather(1, h_star[:, None]).squeeze(1)  # [Ph, W, C]
        # columns stage: each bin's first column attaining the bin max
        wm = (ar_w >= wlo[q][:, None]) & (ar_w < whi[q][:, None])  # [Pw, W]
        cols = torch.where(wm[None, :, :, None], col_max[:, None], neg_inf)
        w_star = cols.argmax(dim=2)                          # [Ph, Pw, C]
        nonempty = ((hhi[q] > hlo[q])[:, None]
                    & (whi[q] > wlo[q])[None, :])            # [Ph, Pw]
        g_q = g[bi, r] * nonempty[:, :, None].to(g.dtype)    # [Ph, Pw, C]
        for i in range(pooled_h):
            g_rows = torch.zeros((w, c), dtype=g.dtype, device=g.device)
            for j in range(pooled_w):
                g_rows = g_rows + (ar_w[:, None] == w_star[i, j][None, :]) \
                    * g_q[i, j][None, :]
            # one add per (column, channel), at the column's first max row
            dfeat[bi].scatter_add_(0, h_star[i][None], g_rows[None])
    return dfeat


def roi_pool_grad_bf16(feat: torch.Tensor, rois: torch.Tensor,
                       grad: torch.Tensor, pooled_h: int = 7,
                       pooled_w: int = 7, spatial_scale: float = 1.0 / 16.0,
                       flavor: str = "gpu") -> torch.Tensor:
    """The VJP of the pool with a bf16 output (the Pallas kernel
    ``_fc_bwd_kernel``'s semantics, plain version of the CUDA kernel's bf16
    instance): :func:`roi_pool_grad`'s placement and order of sums, ranking
    ``bf16(feat)`` (rounding makes ties the f32 map did not have: they go to
    the first column, then the first row), with the cotangent upcast to f32
    and dfeat accumulated in f32, returned in feat's dtype."""
    feat_cast = feat.to(torch.bfloat16).to(torch.float32)
    return roi_pool_grad(feat_cast, rois, grad.to(torch.float32), pooled_h,
                         pooled_w, spatial_scale, flavor).to(feat.dtype)
