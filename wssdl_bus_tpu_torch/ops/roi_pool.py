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


# The Pallas backward kernels' window and mask: bin row i is read as the
# ``span(h, pooled_h)`` map rows from ``sh = clip(lo, 0, h - span)``
# (``roi_pool_pallas.py:_bin_window`` / ``_spans``), and a cell outside the
# bin is masked by ADDING -1e30, not replaced: a NaN stays NaN, +inf stays
# +inf.
_BIG = 1e30
BWD_C_BLOCK = 256   # roi_pool_pallas.py:_c_block(c, backward=True)


def span(limit: int, pooled: int) -> int:
    """Map rows (or columns) of a bin's window in the Pallas kernels."""
    return min(limit // pooled + 2, limit)


def channel_block(c: int) -> int:
    """Channels of one channel block of the f32 backward (``_bwd_kernel``
    runs over ``c // channel_block(c)`` of them)."""
    return min(c, BWD_C_BLOCK)


def argmax_nan_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.argmax``: the first NaN along ``dim`` if there is one, else
    the first maximum."""
    nan = torch.isnan(x)
    return torch.where(nan.any(dim), nan.to(torch.uint8).argmax(dim),
                       x.argmax(dim))


def active_rows(grad: torch.Tensor) -> torch.Tensor:
    """[B, P, ...] cotangent -> [B, P] bool: the ROIs whose cotangent row
    has a nonzero (or NaN) entry: the bf16 kernel's rule
    (``_fc_bwd_call``'s ``any(g != 0)``).  The others contribute nothing to
    the backward and are skipped; in the weak group only the MIL-selected
    ROI of each bag has one."""
    return (grad != 0).flatten(2).any(dim=2)


def active_blocks(grad: torch.Tensor) -> torch.Tensor:
    """[B, P, ..., C] cotangent -> [B, P, C // channel_block(C)] bool: the
    f32 kernel's rule (``_bwd_kernel``'s ``sum(abs(g)) > 0`` per channel
    block): a block of a ROI is active when it has a nonzero entry and no
    NaN.  Channels past the last whole block are never active."""
    b, p, c = grad.shape[0], grad.shape[1], grad.shape[-1]
    cb = channel_block(c)
    nblk = c // cb
    g = grad.reshape(b, p, -1, c)[..., :nblk * cb].reshape(b, p, -1, nblk,
                                                           cb)
    return (g != 0).any(4).any(2) & ~torch.isnan(g).any(4).any(2)


def live_rows(grad: torch.Tensor) -> torch.Tensor:
    """[B, P, ..., C] cotangent -> 0-d int64: the ROIs with an active
    channel block (:func:`active_blocks`), the rows the f32 kernel's scan
    lists and its later passes read."""
    return active_blocks(grad).any(2).sum()


def _pool_grad(feat, rois, g, active, pooled_h, pooled_w, spatial_scale,
               flavor):
    """dfeat of the Pallas backward kernels, op for op.  ``g`` [B, P, Ph,
    Pw, C] f32, ``active`` [B, P, C] bool: the channels of each ROI whose
    cotangent the kernel reads (the others add nothing)."""
    b, h, w, c = feat.shape
    p = rois.shape[1]
    dfeat = torch.zeros_like(feat)
    if b == 0 or p == 0 or c == 0:
        return dfeat
    rsw, rsh, roi_w, roi_h = quantize_rois(rois.reshape(-1, 4),
                                           spatial_scale)
    hlo, hhi = bin_edges(rsh, roi_h, pooled_h, h, flavor)     # [B*P, Ph]
    wlo, whi = bin_edges(rsw, roi_w, pooled_w, w, flavor)     # [B*P, Pw]
    span_h = span(h, pooled_h)
    ar_s = torch.arange(span_h, device=feat.device)
    ar_w = torch.arange(w, device=feat.device)
    zero = torch.zeros((), dtype=feat.dtype, device=feat.device)
    big = torch.tensor(-_BIG, dtype=feat.dtype, device=feat.device)
    for bi, r in active.any(2).nonzero().tolist():
        q = bi * p + r
        nonempty = ((hhi[q] > hlo[q])[:, None]
                    & (whi[q] > wlo[q])[None, :])            # [Ph, Pw]
        # g * ne, the kernels' product (an inf or NaN times 0 is NaN)
        g_q = torch.where(active[bi, r], g[bi, r], zero) \
            * nonempty[:, :, None].to(g.dtype)                # [Ph, Pw, C]
        # each bin row's window: span_h rows from sh, -1e30 added outside
        # the bin
        sh = hlo[q].clamp(max=h - span_h)                     # [Ph]
        rows = sh[:, None] + ar_s                             # [Ph, S]
        off_h = torch.where((rows >= hlo[q][:, None])
                            & (rows < hhi[q][:, None]), zero, big)
        win = feat[bi][rows] + off_h[:, :, None, None]       # [Ph, S, W, C]
        # rows stage: each column's first max row over the window
        h_star = argmax_nan_first(win, 1)                    # [Ph, W, C]
        col_max = win.gather(1, h_star[:, None])[:, 0]       # [Ph, W, C]
        # columns stage, over all W: each bin's first max column
        off_w = torch.where((ar_w >= wlo[q][:, None])
                            & (ar_w < whi[q][:, None]), zero, big)  # [Pw, W]
        w_star = argmax_nan_first(col_max[:, None] + off_w[None, :, :, None],
                                  2)                         # [Ph, Pw, C]
        g_rows = torch.zeros((pooled_h, w, c), dtype=g.dtype,
                             device=g.device)
        for j in range(pooled_w):
            # a select, not a product: the kernels' one-hot products run as
            # selects (interpret mode), so a NaN or inf cotangent reaches
            # its chosen cell only
            g_rows = g_rows + torch.where(
                ar_w[None, :, None] == w_star[:, j, None, :],
                g_q[:, j, None, :], zero)
        for i in range(pooled_h):
            # one add per (column, channel), at the column's first max row
            dfeat[bi].scatter_add_(0, (h_star[i] + sh[i])[None],
                                   g_rows[i][None])
    return dfeat


def roi_pool_grad(feat: torch.Tensor, rois: torch.Tensor, grad: torch.Tensor,
                  pooled_h: int = 7, pooled_w: int = 7,
                  spatial_scale: float = 1.0 / 16.0,
                  flavor: str = "gpu") -> torch.Tensor:
    """The VJP of batched ROI max pooling with respect to ``feat``: what
    the Pallas kernel ``_bwd_kernel`` computes.

    Args:
      feat: [B, H, W, C] the forward's feature maps.
      rois: [B, P, 4] (x1, y1, x2, y2); ROI p of image b pooled feat[b].
      grad: the cotangent, [B, P, Ph*Pw*C] (the flat fc6 operand's) or any
        shape with the same B, P and element order [B, P, Ph, Pw, C].
    Returns dfeat [B, H, W, C].

    Placement: bin row i reads the ``span`` map rows from
    ``sh = min(lo_i, H - span)``, masked by adding -1e30 outside the bin.
    For each column, h* is the first row of that span attaining its
    maximum; for bin (i, j), w* is the first of all W columns whose masked
    column maximum is the largest.  A NaN is the largest value, so a NaN
    anywhere in the span rows routes the bin there, even outside the bin
    or the ROI; without NaNs (and values within +-2^96), h* and w* lie in
    the bin: its first max column, then that column's first max row.  The
    bin's whole cotangent goes to (h*, w*).  Order of sums: ROIs ascending;
    within a ROI, bin rows i ascending; within a row, the cotangents of the
    bins that share a column are summed in j order first, and that sum is
    added to the cell.  Per channel block of ``channel_block(C)`` channels,
    a ROI whose cotangent there is all zero or holds a NaN is skipped; a
    non-finite sum spreads NaN over its span rows, as the kernel's
    one-hot products do."""
    b, p = rois.shape[:2]
    c = feat.shape[-1]
    g = grad.reshape(b, p, pooled_h, pooled_w, c)
    cb = channel_block(c) if c else 1
    blk = active_blocks(g)                                   # [B, P, nblk]
    active = torch.zeros((b, p, c), dtype=torch.bool, device=g.device)
    active[..., :blk.shape[2] * cb] = blk.repeat_interleave(cb, dim=2)
    return _pool_grad(feat, rois, g, active, pooled_h, pooled_w,
                      spatial_scale, flavor)


def roi_pool_grad_bf16(feat: torch.Tensor, rois: torch.Tensor,
                       grad: torch.Tensor, pooled_h: int = 7,
                       pooled_w: int = 7, spatial_scale: float = 1.0 / 16.0,
                       flavor: str = "gpu") -> torch.Tensor:
    """The VJP of the pool with a bf16 output (the Pallas kernel
    ``_fc_bwd_kernel``'s semantics, plain version of the CUDA kernel's bf16
    instance): :func:`roi_pool_grad`'s placement and order of sums, ranking
    ``bf16(feat)`` (rounding makes ties the f32 map did not have: they go to
    the first column, then the first row), with the cotangent upcast to f32
    and dfeat accumulated in f32, returned in feat's dtype.  A ROI is
    active when any entry of its cotangent row is nonzero or NaN, over all
    channels."""
    b, p = rois.shape[:2]
    c = feat.shape[-1]
    g = grad.to(torch.float32).reshape(b, p, pooled_h, pooled_w, c)
    active = active_rows(g)[..., None].expand(b, p, c)
    feat_cast = feat.to(torch.bfloat16).to(torch.float32)
    return _pool_grad(feat_cast, rois, g, active, pooled_h, pooled_w,
                      spatial_scale, flavor).to(feat.dtype)
