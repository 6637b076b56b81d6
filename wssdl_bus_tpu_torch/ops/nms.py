"""Greedy non-maximum suppression, plain PyTorch.

The plain version of the CUDA kernel in ``csrc/nms.cu`` (wrapper
``ops/nms_cuda.py:nms_keep``), and the counterpart of the JAX package's
``ops/nms.py:nms_mask``.  Semantics match the reference's Cython kernel
(``lib/nms/cpu_nms.pyx:17-68``): boxes arrive sorted by descending score, and
a box is kept iff it is valid and no KEPT earlier box overlaps it with
IoU >= thresh under the +1 pixel-extent convention.

Formulation: the greedy keep set is the unique fixpoint of

    kept[i] = valid[i] and not any(j < i : kept[j] and iou(i, j) >= thresh)

so a dense [N, N] boolean suppression matrix and a Jacobi iteration
``kept <- valid & ~any(M & kept)`` reach it; trip t settles every box whose
suppression chain is at most t deep.  The IoU is computed with exactly the
kernel's f32 operations, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

_ROW_CHUNK = 1024   # rows of the [N, N] IoU built at once (bounds memory)


def _area(b: torch.Tensor) -> torch.Tensor:
    return (b[2] - b[0] + 1.0) * (b[3] - b[1] + 1.0)


def _suppression_matrix(boxes_t: torch.Tensor, valid: torch.Tensor,
                        thresh: float) -> torch.Tensor:
    """[N, N] bool: M[i, j] = j < i, valid[j] and iou(i, j) >= thresh."""
    n = boxes_t.shape[1]
    area = _area(boxes_t)
    cols = torch.arange(n, device=boxes_t.device)
    out = torch.empty((n, n), dtype=torch.bool, device=boxes_t.device)
    for r0 in range(0, n, _ROW_CHUNK):
        r1 = min(r0 + _ROW_CHUNK, n)
        r = boxes_t[:, r0:r1, None]                      # [4, R, 1]
        iw = (torch.minimum(r[2], boxes_t[2]) - torch.maximum(r[0], boxes_t[0])
              + 1.0).clamp_min(0.0)
        ih = (torch.minimum(r[3], boxes_t[3]) - torch.maximum(r[1], boxes_t[1])
              + 1.0).clamp_min(0.0)
        inter = iw * ih
        iou = inter / (area[r0:r1, None] + area[None, :] - inter)
        earlier = cols[None, :] < cols[r0:r1, None]
        out[r0:r1] = (iou >= thresh) & earlier & valid[None, :]
    return out


def nms_mask(boxes_t: torch.Tensor, valid: torch.Tensor,
             thresh: float) -> torch.Tensor:
    """Greedy NMS keep-mask over score-sorted boxes, one image at a time.

    Args:
      boxes_t: [B, 4, N] f32, x1/y1/x2/y2 rows, columns score-descending.
      valid: [B, N] bool; invalid boxes are never kept and never suppress.
      thresh: IoU threshold; overlap >= thresh suppresses.
    Returns [B, N] bool keep mask, on the inputs' device.
    """
    b, four, n = boxes_t.shape
    if four != 4 or valid.shape != (b, n):
        raise ValueError(f"boxes_t {tuple(boxes_t.shape)} / valid "
                         f"{tuple(valid.shape)}: want [B, 4, N] / [B, N]")
    keep = torch.zeros((b, n), dtype=torch.bool, device=boxes_t.device)
    for i in range(b):
        m = _suppression_matrix(boxes_t[i], valid[i], thresh)
        kept = valid[i].clone()
        while True:
            new = valid[i] & ~(m & kept[None, :]).any(dim=1)
            if torch.equal(new, kept):
                break
            kept = new
        keep[i] = kept
    return keep
