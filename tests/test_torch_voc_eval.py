"""The port's VOC evaluation (``evaluate/voc_eval.py``) and qualitative
overlays (``evaluate/visualize.py``) against the JAX package's, on the
synthetic SNUBH-layout imdb of ``tests/test_torch_dataset.py`` and seeded
synthetic detections: near-GT boxes (hits, misses at the IoU threshold,
duplicates), boxes in the void, scores across the FROC thresholds.

Exact: the returned list, every byte of ``eval.txt``, and the arrays in
``froc_curve_pts.npy`` / ``all_arr_ok.npy`` (``num_fp_per_img.npy`` on the
``test_normal`` split)."""

import os

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_dataset import SIZES, write_bus_imdb
from wssdl_bus_tpu.data import dataset as jax_dataset
from wssdl_bus_tpu.evaluate.visualize import \
    draw_detections as jax_draw_detections
from wssdl_bus_tpu.evaluate.voc_eval import voc_eval_class as jax_voc_eval
from wssdl_bus_tpu_torch.data import dataset
from wssdl_bus_tpu_torch.evaluate.visualize import (draw_detections,
                                                    save_qualitative)
from wssdl_bus_tpu_torch.evaluate.voc_eval import (froc_sweep, voc_ap,
                                                   voc_eval_class)


def synthetic_all_boxes(imdb, seed):
    """all_boxes[cls][img] [N, 5] float32: per image and class, jittered
    copies of the GT boxes (some far enough to miss), duplicates and void
    boxes, scores uniform in [0, 1)."""
    rng = np.random.RandomState(seed)
    roidb = imdb.roidb
    out = [[np.zeros((0, 5), np.float32) for _ in range(imdb.num_images)]
           for _ in range(imdb.num_classes)]
    for i in range(imdb.num_images):
        h, w = SIZES[i]
        for j in range(1, imdb.num_classes):
            rows = []
            for box in roidb[i]["boxes"].astype(np.float32):
                for scale in (1.0, 4.0, 25.0):
                    rows.append(box + rng.uniform(-scale, scale, 4))
            for _ in range(rng.randint(0, 4)):
                x, y = rng.uniform(0, w - 20), rng.uniform(0, h - 20)
                rows.append([x, y, x + rng.uniform(5, 40),
                             y + rng.uniform(5, 40)])
            dets = np.asarray(rows, np.float32)
            scores = rng.uniform(0, 1, (len(dets), 1)).astype(np.float32)
            out[j][i] = np.hstack([dets, scores])
    return out


def _evaluate(module, data_dir, split, all_boxes, out_dir):
    imdb = module.get_imdb(f"bus_{split}", data_dir)
    result = imdb.evaluate_detections(all_boxes, out_dir)
    files = {}
    for name in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, name)
        if name.endswith(".npy"):
            files[name] = np.load(path, allow_pickle=True)
        else:
            with open(path) as f:
                files[name] = f.read()
    return result, files


@pytest.mark.parametrize("split,masses", [("test", True),
                                          ("test_normal", False)])
@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_bus_detections_matches_jax(tmp_path, split, masses, seed):
    data = str(tmp_path / "data")
    write_bus_imdb(data, seed, split=split, masses=masses)
    all_boxes = synthetic_all_boxes(dataset.get_imdb(f"bus_{split}", data),
                                    seed)
    got, got_files = _evaluate(dataset, data, split, all_boxes,
                               str(tmp_path / "port"))
    want, want_files = _evaluate(jax_dataset, data, split, all_boxes,
                                 str(tmp_path / "jax"))
    assert got == want
    assert sorted(got_files) == sorted(want_files)
    if split == "test":
        assert sorted(got_files) == ["all_arr_ok.npy", "eval.txt",
                                     "froc_curve_pts.npy"]
        assert "AP for benign" in got_files["eval.txt"]
        assert "CorLoc for malignant" in got_files["eval.txt"]
        assert "Mean AP" in got_files["eval.txt"]
    else:
        assert "num_fp_per_img.npy" in got_files
    for name, g in got_files.items():
        w = want_files[name]
        if isinstance(w, str):
            assert g == w, name
        else:
            assert g.shape == w.shape and g.dtype == w.dtype, name
            np.testing.assert_array_equal(np.asarray(g.tolist(), float),
                                          np.asarray(w.tolist(), float))


def test_voc_eval_class_and_froc_match_jax(rng):
    gts = {"im0": (np.array([[10, 10, 50, 50], [100, 100, 160, 160]], float),
                   np.array([False, True])),
           "im1": (np.zeros((0, 4)), np.zeros((0,), bool))}
    dets = {"im0": np.array([[9, 9, 49, 49, 0.9], [11, 11, 51, 51, 0.8],
                             [300, 300, 320, 320, 0.7],
                             [99, 99, 159, 159, 0.6]], np.float32),
            "im1": np.array([[5, 5, 30, 30, 0.55]], np.float32)}
    names = ["im0", "im1"]
    got = voc_eval_class(dets, gts, names, score_thresh=0.5)
    want = jax_voc_eval(dets, gts, names, score_thresh=0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    pts = froc_sweep(dets, gts, names, list(np.arange(1.0, -0.01, -0.05)))
    assert len(pts) == 21 and pts[0] == (0.0, 0.0)
    assert voc_ap(np.array([0.5]), np.array([1.0])) == pytest.approx(6 / 11)


def test_qualitative_overlay(tmp_path, rng):
    """draw_detections gives the JAX package's pixels; save_qualitative
    writes a PNG of the image's size."""
    im = rng.randint(0, 255, (120, 160)).astype(np.uint8)
    dets = {1: np.array([[10, 12, 60, 70, 0.9], [5, 5, 20, 20, 0.3]],
                        np.float32),
            2: np.array([[80, 30, 150, 110, 0.7]], np.float32)}
    gt_boxes = np.array([[12, 14, 58, 66], [0, 60, 159, 119]], np.uint16)
    gt_classes = np.array([1, 0])
    got = draw_detections(im, dets, gt_boxes, gt_classes)
    want = jax_draw_detections(im, dets, gt_boxes, gt_classes)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    path = save_qualitative(im, dets, str(tmp_path / "qual"), "img0",
                            gt_boxes, gt_classes)
    assert path == str(tmp_path / "qual" / "img0.png")
    with Image.open(path) as saved:
        assert saved.size == (160, 120) and saved.mode == "RGB"
