"""Serving surface shared by the predict CLI and the HTTP server
(counterpart of ``wssdl_bus_tpu/serve/__init__.py:222-248``).

Only :func:`report_detections` is ported so far; the serving artifact
(export / load), the CLIs and the HTTP server come with later slices.
"""

from __future__ import annotations

from wssdl_bus_tpu_torch.evaluate.detect import apply_nms_per_class

# copy of wssdl_bus_tpu/data/dataset.py CLASSES
CLASS_NAMES = ("__background__", "benign", "malignant")


def report_detections(scores, boxes, cfg, thresh: float = 0.5,
                      class_names=CLASS_NAMES) -> "tuple[list, dict]":
    """(scores [N, C], pred_boxes [N, 4C]) -> ``(entries, kept)``: report
    entries ``{"class", "score", "box"}`` sorted by score, plus the
    per-class ``{class_index: [n, 5]}`` arrays behind them.  Applies the
    reference post-processing (0.05 score floor, per-class NMS, optional
    class-agnostic second pass, test_bus.py:359-386), then the caller's
    report threshold."""
    dets = apply_nms_per_class(scores, boxes, len(class_names), 0.05,
                               cfg.TEST.NMS,
                               cls_agnostic=cfg.TEST.CLS_AGNOSTIC_NMS)
    kept = {j: dets[j][dets[j][:, 4] >= thresh]
            for j in range(1, len(class_names))}
    out = []
    for j in range(1, len(class_names)):
        for x1, y1, x2, y2, s in kept[j]:
            out.append({"class": class_names[j], "score": float(s),
                        "box": [float(x1), float(y1), float(x2),
                                float(y2)]})
    out.sort(key=lambda d: -d["score"])
    return out, kept
