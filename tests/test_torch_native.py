"""The port's native host runtime (``wssdl_bus_tpu_torch/native``, its own
copy of the JAX package's ``native/wssdl_native.cc``) against the JAX
package's.

Where both libraries build (``wssdl_bus_tpu.native.available()`` and the
port's), the outputs must be equal bit for bit: the same C++ compiled with
the same flags.  Where they do not, the port's dispatching functions (its
native kernel, or its PIL / scipy / numpy path) are held to the JAX
package's oracles at the tolerances of ``tests/test_native.py``.  Nothing
skips either way.  The first build is safe under concurrency: threads and
two processes building into one empty directory all get one whole
library."""

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
from PIL import Image
from scipy import ndimage

from tests.oracles import iou_oracle, iou_ui_oracle, nms_oracle
from wssdl_bus_tpu import native as jax_native
from wssdl_bus_tpu_torch import native
from wssdl_bus_tpu_torch.data.augment import resize_bilinear, rotate_bilinear
from wssdl_bus_tpu_torch.evaluate.detect import nms_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both() -> bool:
    return jax_native.available() and native.available()


def _dets(rng, n):
    x1 = rng.uniform(0, 200, n)
    y1 = rng.uniform(0, 200, n)
    dets = np.stack([x1, y1, x1 + rng.uniform(5, 120, n),
                     y1 + rng.uniform(5, 120, n),
                     rng.uniform(0, 1, n)], axis=1).astype(np.float32)
    return dets[dets[:, 4].argsort()[::-1]]


@pytest.mark.parametrize("n", [1, 17, 300])
def test_nms(rng, n):
    dets = _dets(rng, n)
    for thr in (0.3, 0.5, 0.7):
        if _both():
            assert native.nms(dets, thr) == jax_native.nms(dets, thr)
        assert nms_numpy(dets, thr) == nms_oracle(dets, thr)


@pytest.mark.parametrize("unidirectional", [False, True])
def test_bbox_overlaps(rng, unidirectional):
    boxes = _dets(rng, 50)[:, :4]
    query = _dets(rng, 7)[:, :4]
    oracle = iou_ui_oracle if unidirectional else iou_oracle
    got = native.bbox_overlaps(boxes, query, unidirectional)
    if _both():
        np.testing.assert_array_equal(
            got, jax_native.bbox_overlaps(boxes, query, unidirectional))
    if got is not None:
        np.testing.assert_allclose(got, oracle(boxes, query), rtol=1e-5)


@pytest.mark.parametrize("oh,ow", [(120, 160), (23, 31), (608, 816)])
def test_resize(rng, oh, ow):
    im = rng.rand(57, 83).astype(np.float32)
    got = resize_bilinear(im, oh, ow)
    if _both():
        np.testing.assert_array_equal(
            got, jax_native.resize_bilinear(im, oh, ow))
    ref = np.asarray(Image.fromarray(im, mode="F")
                     .resize((ow, oh), Image.BILINEAR))
    np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.mark.parametrize("angle", [-4.3, 2.0, 0.0])
def test_rotate(rng, angle):
    im = rng.rand(64, 80).astype(np.float32)
    got = rotate_bilinear(im, angle, 0.25)
    if _both():
        np.testing.assert_array_equal(
            got, jax_native.rotate_bilinear(im, angle, 0.25))
    ref = ndimage.rotate(im, angle, reshape=False, order=1, mode="constant",
                         cval=0.25)
    np.testing.assert_allclose(got[3:-3, 3:-3], ref[3:-3, 3:-3], atol=1e-4)


def test_brightness_contrast(rng):
    im = rng.rand(40, 40).astype(np.float32)
    keep = im.copy()
    got = native.brightness_contrast(im, 0.1, 1.5, True, True)
    np.testing.assert_array_equal(im, keep)        # the input is not written
    if _both():
        np.testing.assert_array_equal(
            got, jax_native.brightness_contrast(im, 0.1, 1.5, True, True))
    if got is not None:
        ref = np.clip(im + 0.1, 0, 1)
        m = ref.mean()
        ref = np.clip((ref - m) * 1.5 + m, 0, 1)
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_library_is_the_ports_own_build():
    """The port builds its own copy into its ``_build/`` (never the JAX
    package's ``native/`` library), named by the source's hash."""
    path = native.lib_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libwssdl_native-")
    with open(native.SOURCE) as f:
        ours = f.read()
    with open(os.path.join(REPO, "native", "wssdl_native.cc")) as f:
        theirs = f.read()
    code = ours[ours.index("#include <algorithm>"):]
    assert code == theirs[theirs.index("#include <algorithm>"):]
    if native.available():
        assert os.path.exists(path)


_BUILD = """
import sys
from wssdl_bus_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
print(native.build())
"""


def test_concurrent_first_build(tmp_path, monkeypatch):
    """Eight threads, then two processes, each build into an empty
    directory at once: every caller gets the same path (or, without a
    compiler, None), the library loads, and no temporary file is left."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "threads"))
    got = []
    threads = [threading.Thread(target=lambda: got.append(native.build()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 8 and len(set(got)) == 1

    out_dir = str(tmp_path / "procs")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, out_dir],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1
    for path, d in ((got[0], "threads"), (outs[0], "procs")):
        if path in (None, "None"):
            continue
        ctypes.CDLL(path).wssdl_nms    # loads, and holds the entry point
        left = sorted(os.listdir(tmp_path / d))
        assert left == sorted([os.path.basename(path), "native.lock"])
