"""SNUBH_BUS dataset ("imdb") layer: the port's copy of
``wssdl_bus_tpu/data/dataset.py`` (numpy and PIL only; the JAX package is
not imported, so the copy is kept here).

Re-implements the reference detector's dataset stack (its
``lib/datasets/bus.py``, ``imdb.py`` and ``roi_data_layer/roidb.py``):

  * 3 classes: __background__ / benign / malignant (bus.py:28-29);
  * ``.tif`` grayscale images under TIFFImages/, VOC-style XML under
    Annotations/ with 0-based corrections and explicit background
    (normal-tissue) objects kept as class 0 (bus.py:176-223);
  * per-image BIRADS diagnosis label ``birads_diag = diag + 1`` (bus.py:216);
  * split files ImageSets/Main/<split>.txt (bus.py:68-80);
  * horizontal-flip augmentation doubling the index (imdb.py:106-123);
  * roidb preparation: image path/size, max_overlaps/max_classes
    (roidb.py:18-39).

The gt pickle cache (bus.py:89-108) is optional here and defaults OFF — the
reference writes into the dataset tree, which we never do.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np
from PIL import Image

CLASSES = ("__background__", "benign", "malignant")
CLASS_TO_IND = {c: i for i, c in enumerate(CLASSES)}

# Splits the reference registers (datasets/factory_bus.py:13-17).
SPLITS = (
    ["s_train", "s_train_10", "s_train_50", "s_train_100", "s_train_200",
     "s_train_400", "s_train_600",
     "ws_train", "ws_train_10", "ws_train_50", "ws_train_100", "ws_train_200",
     "ws_train_400", "ws_train_600",
     "train", "reduced_ws_train", "test", "test_normal",
     "s_train_datasetB", "test_datasetB"])


class BusDataset:
    """The ``bus`` imdb."""

    def __init__(self, image_set: str, data_dir: str,
                 cache_dir: Optional[str] = None):
        self.name = "bus_" + image_set
        self.image_set = image_set
        self.data_dir = data_dir
        self.cache_dir = cache_dir
        self.classes = CLASSES
        self.num_classes = len(CLASSES)
        self._image_ext = ".tif"
        self.image_index = self._load_image_set_index()
        self._roidb: Optional[List[dict]] = None

    # ------------------------------------------------------------------ #
    def _load_image_set_index(self) -> List[str]:
        path = os.path.join(self.data_dir, "ImageSets", "Main",
                            self.image_set + ".txt")
        with open(path) as f:
            return [x.strip() for x in f if x.strip()]

    def image_path_at(self, i: int) -> str:
        return os.path.join(self.data_dir, "TIFFImages",
                            self.image_index[i] + self._image_ext)

    @property
    def num_images(self) -> int:
        return len(self.image_index)

    def read_image(self, i: int) -> np.ndarray:
        """Grayscale uint8 [H, W] (replication to 3 channels happens at blob
        assembly, minibatch_bus.py:269-270)."""
        return np.asarray(Image.open(self.image_path_at(i)))

    # ------------------------------------------------------------------ #
    def _load_annotation(self, index: str) -> dict:
        """Parse one VOC-style XML (bus.py:176-223)."""
        path = os.path.join(self.data_dir, "Annotations", index + ".xml")
        tree = ET.parse(path)
        objs = [o for o in tree.findall("object")
                if int(o.find("difficult").text) == 0]
        n = len(objs)
        boxes = np.zeros((n, 4), np.uint16)
        gt_classes = np.zeros((n,), np.int32)
        overlaps = np.zeros((n, self.num_classes), np.float32)
        seg_areas = np.zeros((n,), np.float32)
        for ix, obj in enumerate(objs):
            bb = obj.find("bndbox")
            x1 = float(bb.find("xmin").text) - 1
            y1 = float(bb.find("ymin").text) - 1
            x2 = float(bb.find("xmax").text) - 1
            y2 = float(bb.find("ymax").text) - 1
            cls = CLASS_TO_IND[obj.find("name").text.lower().strip()]
            boxes[ix] = [x1, y1, x2, y2]
            gt_classes[ix] = cls
            overlaps[ix, cls] = 1.0
            seg_areas[ix] = (x2 - x1 + 1) * (y2 - y1 + 1)
        birads_diag = int(tree.findall("BIRADS")[0].find("diag").text) + 1
        return {"boxes": boxes, "gt_classes": gt_classes,
                "gt_overlaps": overlaps, "flipped": False,
                "seg_areas": seg_areas, "birads_diag": birads_diag}

    @property
    def roidb(self) -> List[dict]:
        if self._roidb is not None:
            return self._roidb
        cache_file = None
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            cache_file = os.path.join(self.cache_dir,
                                      self.name + "_gt_roidb.pkl")
            if os.path.exists(cache_file):
                with open(cache_file, "rb") as f:
                    self._roidb = pickle.load(f)
                return self._roidb
        self._roidb = [self._load_annotation(ix) for ix in self.image_index]
        if cache_file:
            with open(cache_file, "wb") as f:
                pickle.dump(self._roidb, f)
        return self._roidb

    # ------------------------------------------------------------------ #
    def append_flipped_images(self) -> None:
        """Double the roidb with horizontally flipped entries
        (imdb.py:106-123)."""
        roidb = self.roidb
        num = self.num_images
        widths = [Image.open(self.image_path_at(i)).size[0]
                  for i in range(num)]
        for i in range(num):
            boxes = roidb[i]["boxes"].copy()
            old_x1 = boxes[:, 0].copy()
            old_x2 = boxes[:, 2].copy()
            boxes[:, 0] = widths[i] - old_x2 - 1
            boxes[:, 2] = widths[i] - old_x1 - 1
            assert (boxes[:, 2] >= boxes[:, 0]).all()
            roidb.append({"boxes": boxes,
                          "gt_overlaps": roidb[i]["gt_overlaps"],
                          "gt_classes": roidb[i]["gt_classes"],
                          "flipped": True,
                          "birads_diag": roidb[i]["birads_diag"]})
        self.image_index = self.image_index * 2

    def evaluate_detections(self, all_boxes, output_dir, suffix=None):
        from wssdl_bus_tpu_torch.evaluate.voc_eval import \
            evaluate_bus_detections
        return evaluate_bus_detections(self, all_boxes, output_dir)

    def competition_mode(self, on: bool) -> None:
        """API parity with bus.competition_mode (bus.py:422-428).  There it
        toggles results-file salting/cleanup; we evaluate in memory and write
        only into the run's output dir, so both modes behave identically."""
        self._comp_mode = bool(on)

    # ------------------------------------------------------------------ #
    def evaluate_recall(self, candidate_boxes, thresholds=None,
                        limit: Optional[int] = None) -> dict:
        """Proposal recall metrics (imdb.py:125-215): greedy one-to-one
        matching of candidates to GT boxes, recall over IoU thresholds.

        candidate_boxes: list (per image) of [N_i, 4] proposal arrays.
        Returns {'ar', 'recalls', 'thresholds', 'gt_overlaps'}.
        """
        gt_overlaps = np.zeros(0)
        roidb = self.roidb
        for i in range(self.num_images):
            gt_inds = np.where(roidb[i]["gt_classes"] > 0)[0]
            gt = roidb[i]["boxes"][gt_inds].astype(np.float64)
            boxes = np.asarray(candidate_boxes[i], np.float64).reshape(-1, 4)
            if limit is not None:
                boxes = boxes[:limit]
            if len(boxes) == 0 or len(gt) == 0:
                gt_overlaps = np.hstack([gt_overlaps, np.zeros(len(gt))])
                continue
            ix1 = np.maximum(boxes[:, None, 0], gt[None, :, 0])
            iy1 = np.maximum(boxes[:, None, 1], gt[None, :, 1])
            ix2 = np.minimum(boxes[:, None, 2], gt[None, :, 2])
            iy2 = np.minimum(boxes[:, None, 3], gt[None, :, 3])
            iw = np.maximum(ix2 - ix1 + 1, 0)
            ih = np.maximum(iy2 - iy1 + 1, 0)
            inter = iw * ih
            ab = ((boxes[:, 2] - boxes[:, 0] + 1)
                  * (boxes[:, 3] - boxes[:, 1] + 1))
            ag = (gt[:, 2] - gt[:, 0] + 1) * (gt[:, 3] - gt[:, 1] + 1)
            overlaps = inter / (ab[:, None] + ag[None, :] - inter)
            _ov = np.zeros(len(gt))
            for _ in range(len(gt)):
                max_per_gt = overlaps.max(axis=0)
                gt_ind = max_per_gt.argmax()
                gt_ovr = max_per_gt.max()
                if gt_ovr < 0:
                    break
                box_ind = overlaps[:, gt_ind].argmax()
                _ov[gt_ind] = gt_ovr
                overlaps[box_ind, :] = -1
                overlaps[:, gt_ind] = -1
            gt_overlaps = np.hstack([gt_overlaps, _ov])
        gt_overlaps = np.sort(gt_overlaps)
        if thresholds is None:
            thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
        recalls = np.array([(gt_overlaps >= t).mean() if len(gt_overlaps)
                            else 0.0 for t in thresholds])
        return {"ar": float(recalls.mean()), "recalls": recalls,
                "thresholds": np.asarray(thresholds),
                "gt_overlaps": gt_overlaps}

    def create_roidb_from_box_list(self, box_list) -> List[dict]:
        """Proposal roidb from external box lists (imdb.py create_roidb_
        from_box_list): per-image boxes labeled by max-IoU against GT."""
        assert len(box_list) == self.num_images
        gt_roidb = self.roidb
        out = []
        for i in range(self.num_images):
            # keep the caller's coordinates (the reference passes boxes
            # through as-is, imdb.py:220-227 — casting to uint16 would wrap
            # negative or large values)
            boxes = np.asarray(box_list[i]).reshape(-1, 4)
            n = len(boxes)
            overlaps = np.zeros((n, self.num_classes), np.float32)
            gt = gt_roidb[i]
            # ALL GT boxes participate, including class-0 normal-tissue
            # boxes — a proposal matching one records its IoU in column 0
            # (imdb.py:224-232 uses gt_roidb[i]['boxes'] unfiltered)
            gt_inds = np.arange(len(gt["gt_classes"]))
            if n and len(gt_inds):
                gtb = gt["boxes"][gt_inds].astype(np.float64)
                b = boxes.astype(np.float64)
                ix1 = np.maximum(b[:, None, 0], gtb[None, :, 0])
                iy1 = np.maximum(b[:, None, 1], gtb[None, :, 1])
                ix2 = np.minimum(b[:, None, 2], gtb[None, :, 2])
                iy2 = np.minimum(b[:, None, 3], gtb[None, :, 3])
                iw = np.maximum(ix2 - ix1 + 1, 0)
                ih = np.maximum(iy2 - iy1 + 1, 0)
                inter = iw * ih
                ab = ((b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1))
                ag = ((gtb[:, 2] - gtb[:, 0] + 1)
                      * (gtb[:, 3] - gtb[:, 1] + 1))
                iou = inter / (ab[:, None] + ag[None, :] - inter)
                argmax = iou.argmax(axis=1)
                maxes = iou.max(axis=1)
                pos = maxes > 0
                overlaps[pos, gt["gt_classes"][gt_inds[argmax[pos]]]] = \
                    maxes[pos]
            out.append({"boxes": boxes,
                        "gt_classes": np.zeros((n,), np.int32),
                        "gt_overlaps": overlaps, "flipped": False,
                        "seg_areas": np.zeros((n,), np.float32),
                        "birads_diag": gt["birads_diag"]})
        return out


def prepare_roidb(imdb: BusDataset) -> List[dict]:
    """Attach derived metadata (roidb.py:18-39)."""
    roidb = imdb.roidb
    sizes = [Image.open(imdb.image_path_at(i)).size
             for i in range(imdb.num_images)]
    for i in range(len(imdb.image_index)):
        roidb[i]["image"] = imdb.image_path_at(i)
        roidb[i]["width"] = sizes[i][0]
        roidb[i]["height"] = sizes[i][1]
        gt_overlaps = roidb[i]["gt_overlaps"]
        roidb[i]["max_overlaps"] = gt_overlaps.max(axis=1)
        roidb[i]["max_classes"] = gt_overlaps.argmax(axis=1)
    return roidb


def get_training_roidb(imdb: BusDataset, use_flipped: bool = True):
    """Flip-augment + prepare (train_bus.py:1016-1034)."""
    if use_flipped:
        imdb.append_flipped_images()
    return prepare_roidb(imdb)


def get_imdb(name: str, data_dir: str, cache_dir: Optional[str] = None
             ) -> BusDataset:
    """Dataset factory (datasets/factory_bus.py:23-27)."""
    if not name.startswith("bus_"):
        raise KeyError(f"Unknown dataset: {name}")
    split = name[len("bus_"):]
    return BusDataset(split, data_dir, cache_dir)


def get_test_roidb(imdb: "BusDataset"):
    """Prepare a roidb for inference — no flip augmentation
    (reference ``get_test_roidb``, test_bus.py:416-430)."""
    return prepare_roidb(imdb)
