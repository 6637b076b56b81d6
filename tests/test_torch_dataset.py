"""The port's data layer (``data/dataset.py``, ``data/targets.py``) against
the JAX package's on a synthetic SNUBH-layout imdb written to ``tmp_path``:
``TIFFImages/*.tif`` (grayscale uint8), ``Annotations/*.xml`` (a benign or
malignant mass, a ``__background__`` box, sometimes a difficult object, a
``<BIRADS><diag>`` field) and ``ImageSets/Main/<split>.txt``.

Everything is compared exactly: the roidb, the flipped roidb,
``prepare_roidb``, ``evaluate_recall``, ``create_roidb_from_box_list``, the
opt-in roidb cache and ``add_bbox_regression_targets``."""

import os

import numpy as np
import pytest
from PIL import Image

from wssdl_bus_tpu.config import Config as JaxConfig
from wssdl_bus_tpu.data import dataset as jax_dataset
from wssdl_bus_tpu.data.targets import \
    add_bbox_regression_targets as jax_add_targets
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data import dataset
from wssdl_bus_tpu_torch.data.targets import add_bbox_regression_targets

SIZES = [(150, 200), (120, 180), (170, 150), (140, 210), (160, 160)]


def speckle_with_mass(rng, h, w):
    """Grayscale uint8 speckle with one dark elliptical mass; -> (image,
    the mass's box x1, y1, x2, y2 in pixels)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tissue = 110.0 * np.exp(-yy / (1.5 * h))
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    ry, rx = rng.uniform(0.08, 0.2) * h, rng.uniform(0.08, 0.2) * w
    tissue[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0] *= 0.25
    im = np.clip(tissue * rng.rayleigh(1.0, (h, w)), 0, 255).astype(np.uint8)
    box = [max(int(cx - rx), 0), max(int(cy - ry), 0),
           min(int(cx + rx), w - 1), min(int(cy + ry), h - 1)]
    return im, box


def _object(name, box, difficult=0):
    x1, y1, x2, y2 = box
    return (f"  <object><name>{name}</name><difficult>{difficult}</difficult>"
            f"<bndbox><xmin>{x1 + 1}</xmin><ymin>{y1 + 1}</ymin>"
            f"<xmax>{x2 + 1}</xmax><ymax>{y2 + 1}</ymax></bndbox></object>\n")


def write_bus_imdb(root, seed, sizes=SIZES, split="test", masses=True,
                   difficult_every=3):
    """Write a SNUBH-layout imdb under ``root``; -> the image names.  Image
    k carries a benign (even k) or malignant (odd k) mass box when
    ``masses``, always a ``__background__`` box over the image's lower
    half, every ``difficult_every``-th image a difficult benign box, and
    ``<BIRADS><diag>k % 2</diag></BIRADS>``."""
    rng = np.random.RandomState(seed)
    for d in ("TIFFImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names = []
    for k, (h, w) in enumerate(sizes):
        name = f"{split}_{k:03d}"
        im, box = speckle_with_mass(rng, h, w)
        Image.fromarray(im).save(os.path.join(root, "TIFFImages",
                                              name + ".tif"))
        objs = ""
        if masses:
            objs += _object("benign" if k % 2 == 0 else "malignant", box)
        objs += _object("__background__", [0, h // 2, w - 1, h - 1])
        if difficult_every and k % difficult_every == difficult_every - 1:
            objs += _object("benign", [2, 2, w // 4, h // 4], difficult=1)
        with open(os.path.join(root, "Annotations", name + ".xml"), "w") as f:
            f.write(f"<annotation>\n{objs}  <BIRADS><diag>{k % 2}</diag>"
                    "</BIRADS>\n</annotation>\n")
        names.append(name)
    with open(os.path.join(root, "ImageSets", "Main", split + ".txt"),
              "w") as f:
        f.write("\n".join(names) + "\n")
    return names


def assert_roidb_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.fixture
def imdbs(tmp_path):
    write_bus_imdb(str(tmp_path), seed=0)
    return (dataset.get_imdb("bus_test", str(tmp_path)),
            jax_dataset.get_imdb("bus_test", str(tmp_path)))


def test_roidb_matches_jax(imdbs):
    port, jax = imdbs
    assert (port.name, port.classes, port.num_classes, port.image_index) == \
        (jax.name, jax.classes, jax.num_classes, jax.image_index)
    assert port.image_path_at(2) == jax.image_path_at(2)
    np.testing.assert_array_equal(port.read_image(1), jax.read_image(1))
    assert_roidb_equal(port.roidb, jax.roidb)
    # __background__ objects are class 0, birads_diag = diag + 1
    assert [0 in e["gt_classes"] for e in port.roidb] == [True] * 5
    assert [e["birads_diag"] for e in port.roidb] == [1, 2, 1, 2, 1]
    assert port.roidb[2]["boxes"].shape == (2, 4)   # difficult dropped


def test_flipped_and_prepared_roidb_match_jax(imdbs):
    port, jax = imdbs
    got = dataset.get_training_roidb(port, use_flipped=True)
    want = jax_dataset.get_training_roidb(jax, use_flipped=True)
    assert len(got) == 10 and port.image_index == jax.image_index
    assert_roidb_equal(got, want)
    assert [e["flipped"] for e in got] == [False] * 5 + [True] * 5


def test_test_roidb_and_cache_match_jax(tmp_path):
    write_bus_imdb(str(tmp_path), seed=1, split="test_normal", masses=False)
    cache = str(tmp_path / "cache")
    port = dataset.get_imdb("bus_test_normal", str(tmp_path), cache)
    jax = jax_dataset.get_imdb("bus_test_normal", str(tmp_path))
    assert_roidb_equal(dataset.get_test_roidb(port),
                       jax_dataset.get_test_roidb(jax))
    # the cache round trip: a second imdb reads the pickle
    again = dataset.get_imdb("bus_test_normal", str(tmp_path), cache)
    assert os.listdir(cache) == ["bus_test_normal_gt_roidb.pkl"]
    assert_roidb_equal(again.roidb, jax_dataset.get_imdb(
        "bus_test_normal", str(tmp_path)).roidb)
    with pytest.raises(KeyError):
        dataset.get_imdb("voc_2007_test", str(tmp_path))


def test_evaluate_recall_and_box_lists_match_jax(imdbs, rng):
    port, jax = imdbs
    cands = []
    for e in port.roidb:
        gt = e["boxes"].astype(np.float64)
        jitter = rng.uniform(-6, 6, (len(gt), 4))
        noise = rng.uniform(0, 140, (6, 2))
        extra = np.concatenate([noise, noise + rng.uniform(5, 60, (6, 2))],
                               1)
        cands.append(np.concatenate([gt + jitter, extra]))
    for limit in (None, 3):
        got = port.evaluate_recall(cands, limit=limit)
        want = jax.evaluate_recall(cands, limit=limit)
        assert got["ar"] == want["ar"]
        for k in ("recalls", "thresholds", "gt_overlaps"):
            np.testing.assert_array_equal(got[k], want[k])
    assert_roidb_equal(port.create_roidb_from_box_list(cands),
                       jax.create_roidb_from_box_list(cands))
    port.competition_mode(True)
    jax.competition_mode(True)


@pytest.mark.parametrize("normalize", [False, True])
def test_bbox_regression_targets_match_jax(imdbs, normalize):
    port, jax = imdbs
    over = ["TRAIN.BBOX_NORMALIZE_TARGETS", str(normalize),
            "TRAIN.BBOX_THRESH", "0.3"]
    got_db = dataset.prepare_roidb(port)
    want_db = jax_dataset.prepare_roidb(jax)
    # proposals that overlap the GT partly, so the deltas are not all zero
    for db in (got_db, want_db):
        for e in db:
            b = e["boxes"].astype(np.float32)
            e["boxes"] = np.concatenate([b, b + 3.0])
            e["max_overlaps"] = np.concatenate(
                [e["max_overlaps"], np.full(len(b), 0.6, np.float32)])
            e["max_classes"] = np.concatenate([e["max_classes"],
                                               e["max_classes"]])
    got = add_bbox_regression_targets(got_db, Config().with_overrides(over))
    want = jax_add_targets(want_db, JaxConfig().with_overrides(over))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_db, want_db):
        np.testing.assert_array_equal(g["bbox_targets"], w["bbox_targets"])
    assert any((e["bbox_targets"][:, 1:] != 0).any() for e in got_db)
