"""VOC AP + CorLoc + FROC metrics engine: the port's copy of
``wssdl_bus_tpu/evaluate/voc_eval.py`` (numpy only).

Re-implements ``voc_eval_bus`` (the reference detector's
``lib/datasets/voc_eval_bus.py:69-281``) and the
orchestration in ``bus._do_python_eval`` (``bus.py:263-392``):

  * per-class VOC AP with the 07 11-point method (forced on, bus.py:291);
  * CorLoc: fraction of GT-containing images where some detection scoring
    >= 0.5 overlaps a GT with IoU > 0.5 (voc_eval_bus.py:160-206);
  * FROC points over score thresholds 1.0 -> 0 step 0.05 (bus.py:366-390);
  * the ``bus_test_normal`` FP-counting mode (bus.py:303-322).

One intentional difference: the reference round-trips detections through VOC
results .txt files written INTO the dataset tree (bus.py:245-261); we keep the
dataset read-only and evaluate in memory, writing ``eval.txt``,
``froc_curve_pts.npy``, ``num_fp_per_img.npy`` and ``all_arr_ok.npy`` to the
run's output directory with the same contents.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np


def voc_ap(rec, prec, use_07_metric=True):
    """(voc_eval_bus.py:36-67)"""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else np.max(prec[rec >= t])
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])


def _iou_1_to_many(bb, BBGT):
    ixmin = np.maximum(BBGT[:, 0], bb[0])
    iymin = np.maximum(BBGT[:, 1], bb[1])
    ixmax = np.minimum(BBGT[:, 2], bb[2])
    iymax = np.minimum(BBGT[:, 3], bb[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inters = iw * ih
    uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
           + (BBGT[:, 2] - BBGT[:, 0] + 1.0) * (BBGT[:, 3] - BBGT[:, 1] + 1.0)
           - inters)
    return inters / uni


class _ClassEval:
    """Threshold-independent per-class precompute, shared by the single
    evaluation (``voc_eval_class``) and the 21-threshold FROC sweep
    (``froc_sweep``) so the sweep never re-sorts, re-rounds or re-computes
    IoUs (the reference re-runs the whole engine per threshold,
    bus.py:366-390 — quadratic in practice).

    Rounding/sort/IoU semantics are bit-identical to the reference's
    per-call path: scores ``%.3f``- and coordinates ``%.1f``-rounded through
    the results-file round trip (bus.py:254-261), detections sorted by
    ``np.argsort(-confidence)``, IoUs in float64 with the +1 area
    convention.
    """

    def __init__(self, dets_per_image, gt_per_image, imagenames,
                 ovthresh=0.5):
        self.imagenames = list(imagenames)
        self.ovthresh = ovthresh
        # flatten + round + sort by confidence (voc_eval_bus.py:149-158)
        image_ids, confidence, BB = [], [], []
        for name in imagenames:
            dets = dets_per_image.get(name)
            if dets is None or len(dets) == 0:
                continue
            for row in dets:
                image_ids.append(name)
                confidence.append(float(f"{float(row[4]):.3f}"))
                BB.append([float(f"{row[0] + 1:.1f}"),
                           float(f"{row[1] + 1:.1f}"),
                           float(f"{row[2] + 1:.1f}"),
                           float(f"{row[3] + 1:.1f}")])
        self.npos = sum(int(np.sum(~np.asarray(gt_per_image[n][1], bool)))
                        for n in imagenames)
        self.nd = len(image_ids)
        self.gt = {n: (np.array(gt_per_image[n][0], float),
                       np.asarray(gt_per_image[n][1], bool))
                   for n in imagenames}
        # GT-containing images in name order (their ordinal indexes arr_ok);
        # note the reference reports ni=0 when there are no detections at
        # all (early return, voc_eval_bus.py:150-158)
        self._gt_images = [n for n in imagenames
                           if self.gt[n][0].shape[0] > 0]
        self.ni = len(self._gt_images)
        if not self.nd:
            return

        confidence = np.array(confidence)
        sorted_ind = np.argsort(-confidence)
        self.sorted_scores = np.sort(-confidence)
        self.BB = np.array(BB, float)[sorted_ind]
        self.image_ids = [image_ids[i] for i in sorted_ind]

        # per-detection max-IoU/argmax vs the image's GT (incl. difficult),
        # computed once image-by-image with the exact _iou_1_to_many math
        self.ovmax = np.full(self.nd, -np.inf)
        self.jmax = np.zeros(self.nd, np.int64)
        det_rows = {n: [] for n in imagenames}
        for d, name in enumerate(self.image_ids):
            det_rows[name].append(d)
        self._det_rows = {n: np.asarray(r, np.int64)
                          for n, r in det_rows.items()}
        for name in imagenames:
            rows = self._det_rows[name]
            BBGT = self.gt[name][0]
            if rows.size == 0 or BBGT.shape[0] == 0:
                continue
            iou = np.stack([_iou_1_to_many_multi(self.BB[rows], g)
                            for g in BBGT], axis=1)  # [nd_i, M_i]
            self.ovmax[rows] = iou.max(axis=1)
            self.jmax[rows] = iou.argmax(axis=1)

        # per-image best qualifying score for CorLoc: the most confident
        # detection overlapping ANY GT of this class with IoU > ovthresh
        # (stored as the NEGATED score so threshold comparisons are the
        # reference's `sorted_scores <= -score_thresh` form)
        self._best_ok_neg = {}
        for name in imagenames:
            rows = self._det_rows[name]
            if rows.size == 0 or self.gt[name][0].shape[0] == 0:
                continue
            ok = self.ovmax[rows] > ovthresh
            if ok.any():
                self._best_ok_neg[name] = self.sorted_scores[rows][ok].min()

    # ---------------------------------------------------------------- #
    def corloc(self, score_thresh):
        """(ni, nok, arr_ok) — voc_eval_bus.py:160-206."""
        nok = 0
        arr_ok = np.zeros((max(200, len(self.imagenames)),))
        for i, name in enumerate(self._gt_images):
            best = self._best_ok_neg.get(name)
            if best is not None and best <= -score_thresh:
                arr_ok[i] = True
                nok += 1
        return self.ni, nok, arr_ok

    def froc_fps(self, score_thresh):
        """Count of detections with score >= thresh and max-IoU <= ovthresh
        (the `fp_froc` sum, voc_eval_bus.py:248-266)."""
        cut = np.searchsorted(self.sorted_scores, -score_thresh,
                              side="right")
        return int(np.sum(self.ovmax[:cut] <= self.ovthresh))


def voc_eval_class(dets_per_image: dict, gt_per_image: dict, imagenames,
                   ovthresh=0.5, use_07_metric=True, score_thresh=0.5,
                   _pre: _ClassEval = None):
    """Evaluate one class.

    Args:
      dets_per_image: {imagename: [N_i, 5] array (x1,y1,x2,y2,score)} in
        ORIGINAL (1-based-written, here 0-based) image coordinates.  To match
        the reference exactly we apply the results-file writer's round trip
        (bus.py:254-261): +1 to coordinates, then scores formatted ``%.3f``
        and coordinates ``%.1f`` — threshold-boundary detections must
        classify identically to the reference, which re-reads the rounded
        text values (voc_eval_bus.py:148-152).
      gt_per_image: {imagename: ([M_i, 4] array of this class's GT boxes
        from the XML (1-based), [M_i] bool difficult flags)}.  Difficult
        objects stay in the overlap targets but are excluded from npos, and
        detections matching one count as neither TP nor FP
        (voc_eval_bus.py:134-141,238-246).
    Returns the reference's 8-tuple
      (rec, prec, ap, ni, nok, arr_ok, num_all_fps, num_fp_per_img).
    """
    if _pre is not None:
        # a _pre built with a different ovthresh would silently mix IoU
        # verdicts; dets/gt args are unused in this mode (pass None)
        if _pre.ovthresh != ovthresh:
            raise ValueError("shared _ClassEval was built with a different "
                             f"ovthresh ({_pre.ovthresh} != {ovthresh})")
        pre = _pre
    else:
        pre = _ClassEval(dets_per_image, gt_per_image, imagenames, ovthresh)
    if not pre.nd:
        return -1, -1, -1, 0, 0, np.zeros((200,)), 0, [0] * len(imagenames)

    image_ids, sorted_scores = pre.image_ids, pre.sorted_scores
    difficult = {n: pre.gt[n][1] for n in imagenames}
    det_mark = {n: [False] * len(pre.gt[n][0]) for n in imagenames}

    # CorLoc (voc_eval_bus.py:160-206)
    ni, nok, arr_ok = pre.corloc(score_thresh)

    # TP/FP sweep (voc_eval_bus.py:207-266) — greedy per-GT matching in
    # global confidence order, using the precomputed ovmax/jmax
    nd = pre.nd
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    fp_froc = np.zeros(nd)
    for d in range(nd):
        name = image_ids[d]
        ovmax, jmax = pre.ovmax[d], pre.jmax[d]
        if ovmax > ovthresh:
            # a detection matching a difficult GT is neither TP nor FP
            # (voc_eval_bus.py:238-246)
            if not difficult[name][jmax]:
                if not det_mark[name][jmax]:
                    tp[d] = 1.0
                    det_mark[name][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0
        if sorted_scores[d] <= -score_thresh and ovmax <= ovthresh:
            fp_froc[d] = 1.0

    num_all_fps = int(np.sum(fp_froc))
    per_img = OrderedDict((n, 0) for n in sorted(imagenames))
    for d in range(nd):
        if fp_froc[d]:
            per_img[image_ids[d]] += 1
    num_fp_per_img = list(per_img.values())

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(pre.npos, 1))  # npos excludes difficult (ref :138)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)
    return rec, prec, ap, ni, nok, arr_ok, num_all_fps, num_fp_per_img


def froc_sweep(dets_per_image, gt_per_image, imagenames, thresholds,
               ovthresh=0.5, _pre: _ClassEval = None):
    """FROC curve points for one class over all ``thresholds`` in ONE pass:
    -> list of (num_all_fps / max(ni,1), nok / max(ni,1)) matching what 21
    separate ``voc_eval_class`` calls produce (bus.py:366-390), without
    re-sorting / re-rounding / re-computing IoUs per threshold."""
    if _pre is not None:
        if _pre.ovthresh != ovthresh:
            raise ValueError("shared _ClassEval was built with a different "
                             f"ovthresh ({_pre.ovthresh} != {ovthresh})")
        pre = _pre
    else:
        pre = _ClassEval(dets_per_image, gt_per_image, imagenames, ovthresh)
    pts = []
    for thr in thresholds:
        if not pre.nd:
            pts.append((0.0, 0.0))  # reference early-return: ni = 0
            continue
        ni, nok, _ = pre.corloc(thr)
        fps = pre.froc_fps(thr)
        pts.append((float(fps) / max(ni, 1), float(nok) / max(ni, 1)))
    return pts


def _iou_1_to_many_multi(bb_many, gt_one):
    ixmin = np.maximum(bb_many[:, 0], gt_one[0])
    iymin = np.maximum(bb_many[:, 1], gt_one[1])
    ixmax = np.minimum(bb_many[:, 2], gt_one[2])
    iymax = np.minimum(bb_many[:, 3], gt_one[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inters = iw * ih
    uni = ((gt_one[2] - gt_one[0] + 1.0) * (gt_one[3] - gt_one[1] + 1.0)
           + (bb_many[:, 2] - bb_many[:, 0] + 1.0)
           * (bb_many[:, 3] - bb_many[:, 1] + 1.0) - inters)
    return inters / uni


def _gt_for_class(imdb, classname):
    """Per-image (boxes, difficult) of one class, straight from the XML
    (1-based).  Difficult objects are KEPT — they remain valid overlap
    targets; only npos and TP/FP marking treat them specially
    (voc_eval_bus.py:130-141)."""
    import xml.etree.ElementTree as ET

    out = {}
    for name in imdb.image_index[:imdb.num_images]:
        path = os.path.join(imdb.data_dir, "Annotations", name + ".xml")
        tree = ET.parse(path)
        boxes, difficult = [], []
        for obj in tree.findall("object"):
            if obj.find("name").text != classname:
                continue
            bb = obj.find("bndbox")
            boxes.append([int(bb.find("xmin").text), int(bb.find("ymin").text),
                          int(bb.find("xmax").text), int(bb.find("ymax").text)])
            difficult.append(int(obj.find("difficult").text) != 0)
        out[name] = (np.array(boxes).reshape(-1, 4),
                     np.array(difficult, bool))
    return out


def evaluate_bus_detections(imdb, all_boxes, output_dir):
    """AP / CorLoc / FROC over an all_boxes[cls][img] table
    (bus.py:263-392 + evaluate_detections:409-420).

    Returns the reference's corloc_list: [corloc_benign, corloc_malignant,
    corloc_overall] (or per-class FP counts for the *_normal split).
    """
    os.makedirs(output_dir, exist_ok=True)
    imagenames = imdb.image_index[:imdb.num_images]
    log_path = os.path.join(output_dir, "eval.txt")
    f_log = open(log_path, "w")

    def dets_for_class(ci):
        return {name: np.asarray(all_boxes[ci][i]).reshape(-1, 5)
                for i, name in enumerate(imagenames)}

    if "test_normal" in imdb.name:
        per_img_total = None
        for ci, cls in enumerate(imdb.classes):
            if cls == "__background__":
                continue
            *_, num_fp_per_img = voc_eval_class(
                dets_for_class(ci), _gt_for_class(imdb, cls), imagenames,
                score_thresh=0.5)
            arr = np.array(num_fp_per_img)
            per_img_total = arr if per_img_total is None else per_img_total + arr
        f_log.write(f"Number of all FPs = {int(per_img_total.sum())}\n")
        f_log.close()
        np.save(os.path.join(output_dir, "num_fp_per_img"), per_img_total)
        return [int(per_img_total.sum())]

    # parse each class's GT once (the reference caches the parsed
    # annotations in a pickle, voc_eval_bus.py:104-128; the FROC sweep below
    # re-evaluates 21 thresholds x classes and must not re-read the XMLs)
    gt_cache = {cls: _gt_for_class(imdb, cls)
                for cls in imdb.classes if cls != "__background__"}

    # one _ClassEval per class, shared by the AP/CorLoc evaluation AND the
    # FROC sweep below (the expensive flatten/round/sort/IoU precompute
    # runs exactly once per class)
    pre_cache = {cls: _ClassEval(dets_for_class(ci), gt_cache[cls],
                                 imagenames)
                 for ci, cls in enumerate(imdb.classes)
                 if cls != "__background__"}

    aps, nis, noks, corloc_list = [], [], [], []
    all_arr_ok = np.zeros((0,))
    for ci, cls in enumerate(imdb.classes):
        if cls == "__background__":
            continue
        rec, prec, ap, ni, nok, arr_ok, _, _ = voc_eval_class(
            None, None, imagenames, score_thresh=0.5, _pre=pre_cache[cls])
        aps.append(ap)
        nis.append(ni)
        noks.append(nok)
        corloc = float(nok) / ni if ni else 0.0
        corloc_list.append(corloc)
        f_log.write(f"AP for {cls} = {ap:.4f}\n")
        f_log.write(f"CorLoc for {cls} = {corloc:.4f}\n")
        all_arr_ok = np.concatenate((all_arr_ok, arr_ok))
    mean_ap = float(np.mean(aps))
    overall = float(np.sum(noks)) / max(np.sum(nis), 1)
    corloc_list.append(overall)
    f_log.write(f"Mean AP = {mean_ap:.4f}\n")
    f_log.write(f"CorLoc = {overall:.4f}\n")

    # FROC curves (bus.py:366-390) — one precompute pass per class instead
    # of the reference's 21 full re-evaluations (same points bit-for-bit;
    # tests/test_voc_eval.py compares against the per-threshold path)
    curve_pts = [[], [], []]  # [all, benign, malignant]
    thresholds = list(np.arange(1.0, -0.01, -0.05))
    for ci, cls in enumerate(imdb.classes):
        if cls == "__background__":
            continue
        curve_pts[ci] = froc_sweep(None, None, imagenames, thresholds,
                                   _pre=pre_cache[cls])
    for i in range(len(curve_pts[1])):
        curve_pts[0].append(((curve_pts[1][i][0] + curve_pts[2][i][0]) / 2,
                             (curve_pts[1][i][1] + curve_pts[2][i][1]) / 2))
    f_log.write(str(curve_pts))
    f_log.close()
    np.save(os.path.join(output_dir, "froc_curve_pts"),
            np.array(curve_pts, dtype=object), allow_pickle=True)
    np.save(os.path.join(output_dir, "all_arr_ok"), all_arr_ok)
    return corloc_list
