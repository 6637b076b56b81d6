"""The synthetic SNUBH-layout image database, and the reference's own
assembly of the joint minibatches from it.

:func:`write_imdb` writes, from a seed, what the detector's SNUBH reader
expects: ``TIFFImages/<id>.tif`` grayscale uint8, ``Annotations/<id>.xml``
(VOC boxes, 1-based, with benign / malignant masses and explicit
``__background__`` normal-tissue boxes on the supervised images, and the
BIRADS diagnosis on every image) and ``ImageSets/Main/<split>.txt``.

:class:`FeedReplica` assembles the minibatches a joint data layer built
on ``np.random.RandomState(seed)`` gives, from the files alone: the two
shuffled cursors (one permutation each at the start and at each epoch's
end), then per image the draws of the original ``prep_im_for_blob`` in
its order (weak images: rotation angle, crop margins; every image:
brightness delta, contrast factor), the shortest-side-600 /
longest-side-1000 scale, and the pixel arithmetic: brightness and contrast
clipped to [0, 1], mean subtraction, a linear resize (triangle kernel,
half-pixel centres, widened on a downscale), division by the pixel
standard deviation.  As the device-side preparation the detector runs,
a rotated and cropped weak image passes through uint8 (``rint``) before
the photometric steps.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
from PIL import Image

CLASSES = ("__background__", "benign", "malignant")


# --------------------------------------------------------------------- #
# the database
# --------------------------------------------------------------------- #
def _box(rng, h, w, lo, hi):
    bw, bh = rng.randint(lo, hi + 1, size=2)
    x1 = rng.randint(8, w - bw - 8)
    y1 = rng.randint(8, h - bh - 8)
    return [x1, y1, x1 + bw - 1, y1 + bh - 1]


def _overlaps(a, boxes):
    return any(not (a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1])
               for b in boxes)


def _image(rng, h, w, masses):
    """Speckle over a smooth background, with a dark ellipse per mass."""
    coarse = rng.randint(40, 111, size=(h // 8 + 1, w // 8 + 1),
                         dtype=np.uint8)
    im = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w] \
        + rng.randint(0, 26, size=(h, w), dtype=np.uint8)
    for x1, y1, x2, y2 in masses:
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        rx, ry = (x2 - x1) / 2, (y2 - y1) / 2
        yy, xx = np.mgrid[y1:y2 + 1, x1:x2 + 1]
        inside = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
        patch = im[y1:y2 + 1, x1:x2 + 1]
        patch[inside] = (patch[inside] * 0.35).astype(np.uint8)
    return im


def _xml(path, objects, diag):
    root = ET.Element("annotation")
    for name, (x1, y1, x2, y2) in objects:
        o = ET.SubElement(root, "object")
        ET.SubElement(o, "name").text = name
        ET.SubElement(o, "difficult").text = "0"
        bb = ET.SubElement(o, "bndbox")
        for k, v in zip(("xmin", "ymin", "xmax", "ymax"),
                        (x1 + 1, y1 + 1, x2 + 1, y2 + 1)):
            ET.SubElement(bb, k).text = str(v)
    ET.SubElement(ET.SubElement(root, "BIRADS"), "diag").text = str(diag)
    ET.ElementTree(root).write(path)


def write_imdb(root: str, seed: int, mix: dict) -> None:
    """Write the database for traffic ``mix`` (its ``imdb`` section) under
    ``root``: ``supervised`` images in split ``s_train``, ``weak`` in
    ``ws_train``, sizes cycled from ``sizes`` in a seeded order, so every
    seed has the same sizes."""
    spec = mix["imdb"]
    rng = np.random.RandomState(seed % 2 ** 32)
    for sub in ("TIFFImages", "Annotations", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    sizes = spec["sizes"]
    for split, count, supervised in (("s_train", spec["supervised"], True),
                                     ("ws_train", spec["weak"], False)):
        ids = []
        order = rng.permutation(count)
        for k in range(count):
            h, w = sizes[order[k] % len(sizes)]
            ident = f"{split}_{k:05d}"
            diag = int(rng.rand() < spec["malignant_share"])
            masses, objects = [], []
            for _ in range(rng.randint(spec["masses"][0],
                                       spec["masses"][1] + 1)):
                b = _box(rng, h, w, *spec["mass_px"])
                if not _overlaps(b, masses):
                    masses.append(b)
            if supervised:
                objects = [(CLASSES[1 + diag], b) for b in masses]
                tissue = []
                for _ in range(200):
                    if len(tissue) == spec["background_boxes"]:
                        break
                    b = _box(rng, h, w, *spec["background_px"])
                    if not _overlaps(b, masses + tissue):
                        tissue.append(b)
                objects += [(CLASSES[0], b) for b in tissue]
            Image.fromarray(_image(rng, h, w, masses)).save(
                os.path.join(root, "TIFFImages", ident + ".tif"))
            _xml(os.path.join(root, "Annotations", ident + ".xml"), objects,
                 diag)
            ids.append(ident)
        with open(os.path.join(root, "ImageSets", "Main", split + ".txt"),
                  "w") as f:
            f.write("\n".join(ids) + "\n")


# --------------------------------------------------------------------- #
# the reference's minibatches
# --------------------------------------------------------------------- #
def read_split(root: str, split: str, flipped: bool = True) -> list:
    """The split's entries (image path, width, height, boxes [G, 4] in
    0-based pixels, classes, BIRADS label = diagnosis + 1), then the
    horizontally mirrored copy of each when ``flipped``."""
    with open(os.path.join(root, "ImageSets", "Main", split + ".txt")) as f:
        ids = [x.strip() for x in f if x.strip()]
    out = []
    for ident in ids:
        tree = ET.parse(os.path.join(root, "Annotations", ident + ".xml"))
        boxes, classes = [], []
        for o in tree.findall("object"):
            if int(o.find("difficult").text):
                continue
            bb = o.find("bndbox")
            boxes.append([float(bb.find(k).text) - 1
                          for k in ("xmin", "ymin", "xmax", "ymax")])
            classes.append(CLASSES.index(o.find("name").text.strip()))
        path = os.path.join(root, "TIFFImages", ident + ".tif")
        w, h = Image.open(path).size
        out.append({"image": path, "width": w, "height": h, "flipped": False,
                    "boxes": np.array(boxes, np.float64).reshape(-1, 4),
                    "classes": np.array(classes, np.int64),
                    "label": int(tree.find("BIRADS").find("diag").text) + 1})
    if flipped:
        for e in list(out):
            b = e["boxes"].copy()
            b[:, 0], b[:, 2] = e["width"] - e["boxes"][:, 2] - 1, \
                e["width"] - e["boxes"][:, 0] - 1
            out.append(dict(e, boxes=b, flipped=True))
    return out


def rotate(im: np.ndarray, degrees: float, cval: float) -> np.ndarray:
    """Bilinear rotation of a float32 image about its centre by
    ``degrees`` counter-clockwise, same shape, ``cval`` for every tap
    outside the image, in float32 arithmetic step by step (the
    detector's native kernel's order of operations)."""
    f = np.float32
    h, w = im.shape
    rad = f(-f(degrees)) * f(np.pi) / f(180.0)
    c, s = f(np.cos(np.float64(rad))), f(np.sin(np.float64(rad)))
    cy, cx = f(0.5) * f(h - 1), f(0.5) * f(w - 1)
    dy = np.arange(h, dtype=f)[:, None] - cy
    dx = np.arange(w, dtype=f)[None, :] - cx
    sy = c * dy - s * dx + cy
    sx = s * dy + c * dx + cx
    inside = (sy >= -1) & (sy <= h) & (sx >= -1) & (sx <= w)
    y0, x0 = np.floor(sy), np.floor(sx)
    wy, wx = sy - y0, sx - x0
    y0, x0 = y0.astype(np.int64), x0.astype(np.int64)
    padded = np.pad(im.astype(f), 2, constant_values=f(cval))

    def at(yy, xx):
        return padded[np.clip(yy, -2, h + 1) + 2, np.clip(xx, -2, w + 1) + 2]

    one = f(1.0)
    top = at(y0, x0) * (one - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (one - wx) + at(y0 + 1, x0 + 1) * wx
    return np.where(inside, top * (one - wy) + bot * wy, f(cval)).astype(f)


def _scale(h, w, target, max_size):
    s = float(target) / min(h, w)
    if np.round(s * max(h, w)) > max_size:
        s = float(max_size) / max(h, w)
    return s


def resize_matrix(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """[n_in, n_out] weights of a linear resize by ``scale``: a triangle
    kernel widened by max(1 / scale, 1), sampled at half-pixel centres,
    each output normalised over the taps inside the image."""
    inv = 1.0 / scale
    width = max(inv, 1.0)
    centre = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(centre[None, :] - np.arange(n_in)[:, None]) / width
    wts = np.clip(1.0 - x, 0.0, None)
    total = wts.sum(0, keepdims=True)
    return np.where(total > 0, wts / np.where(total > 0, total, 1.0), 0.0)


class FeedReplica:
    """The joint minibatches of a data layer seeded with ``seed``; see the
    module docstring.  ``cfg``: the augmentation and budget settings
    (:func:`feed_settings`)."""

    def __init__(self, roidb_s, roidb_ws, seed: int, cfg: dict, canvas):
        self.s, self.ws, self.cfg, self.canvas = roidb_s, roidb_ws, cfg, canvas
        self.rng = np.random.RandomState(seed)
        self.perm = {"s": self.rng.permutation(len(roidb_s)),
                     "ws": self.rng.permutation(len(roidb_ws))}
        self.cur = {"s": 0, "ws": 0}

    def _next(self, key, k):
        n = len(self.perm[key])
        if self.cur[key] + k > n:
            self.perm[key] = self.rng.permutation(n)
            self.cur[key] = 0
        idx = self.perm[key][self.cur[key]:self.cur[key] + k]
        self.cur[key] += k
        return idx

    def _prep(self, entry, weak):
        c, rng = self.cfg, self.rng
        im = np.asarray(Image.open(entry["image"]))
        if entry["flipped"]:
            im = im[:, ::-1]
        im = im.astype(np.float32) / 255.0
        staged = False
        if weak:
            angle = rng.uniform(-c["rotation_max"], c["rotation_max"])
            im = rotate(im, angle, c["pixel_mean"] / 255.0)
            mh, mw = c["crop_margin"] * im.shape[0], \
                c["crop_margin"] * im.shape[1]
            u = rng.randint(0, int(mh) + 1)
            d = rng.randint(1, max(int(mh), 1) + 1)
            left = rng.randint(0, int(mw) + 1)
            r = rng.randint(1, max(int(mw), 1) + 1)
            im = im[u:-d, left:-r]
            staged = True
        delta = rng.uniform(-c["brightness_max"], c["brightness_max"])
        cmean = np.clip(im + delta, 0.0, 1.0).mean() if delta != 0.0 \
            else im.mean()
        factor = rng.uniform(*c["contrast_range"])
        h, w = im.shape
        s = _scale(h, w, c["scale"], c["max_size"])
        oh, ow = int(np.round(h * s)), int(np.round(w * s))
        x = np.rint(im * 255.0) / 255.0 if staged else im.astype(np.float64)
        x = np.clip(x + delta, 0.0, 1.0)
        x = np.clip((x - cmean) * factor + cmean, 0.0, 1.0)
        x = x - c["pixel_mean"] / 255.0
        x = resize_matrix(h, oh, oh / h).T @ x @ resize_matrix(w, ow, ow / w)
        return (x / (c["pixel_std"] / 255.0)).astype(np.float32), s

    def next(self) -> dict:
        """The next joint minibatch: data [B, H, W, 3], gt [B, G, 5],
        num_gt [B], im_info [B, 4] (resized h, w, scale, BIRADS label)."""
        c = self.cfg
        entries = ([(self.s[i], False) for i in self._next("s", c["n_s"])]
                   + [(self.ws[i], True) for i in self._next("ws",
                                                             c["n_ws"])])
        n = len(entries)
        data = np.zeros((n, *self.canvas, 3), np.float32)
        gt = np.zeros((n, c["max_gt"], 5), np.float32)
        num_gt = np.zeros((n,), np.int64)
        im_info = np.zeros((n, 4), np.float32)
        for i, (e, weak) in enumerate(entries):
            im, s = self._prep(e, weak)
            data[i, :im.shape[0], :im.shape[1]] = im[:, :, None]
            if not weak:
                k = len(e["classes"])
                gt[i, :k, :4] = e["boxes"] * s
                gt[i, :k, 4] = e["classes"]
                num_gt[i] = k
            im_info[i] = (im.shape[0], im.shape[1], s, e["label"])
        return {"data": data, "gt": gt, "num_gt": num_gt, "im_info": im_info}


def feed_settings(s: dict) -> dict:
    """The settings :class:`FeedReplica` reads, from a traffic mix's
    ``settings`` (the dotted keys the detector's configuration takes)."""
    return {"n_s": s["TRAIN.IMS_PER_BATCH"], "n_ws": s["TRAIN.WS_IMS_PER_BATCH"],
            "max_gt": s["TRAIN.MAX_GT_PER_IMAGE"],
            "scale": s["TRAIN.SCALES"][0], "max_size": s["TRAIN.MAX_SIZE"],
            "rotation_max": s["TRAIN.ROTATION_MAX_ANGLE"],
            "crop_margin": s["TRAIN.CROPPING_MAX_MARGIN"],
            "brightness_max": s["TRAIN.BRIGHTNESS_ADJUSTMENT_MAX_DELTA"],
            "contrast_range": (s["TRAIN.CONTRAST_ADJUSTMENT_LOWER_FACTOR"],
                               s["TRAIN.CONTRAST_ADJUSTMENT_UPPER_FACTOR"]),
            "pixel_mean": s["PIXEL_MEAN"], "pixel_std": s["PIXEL_STD"]}
