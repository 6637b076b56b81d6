"""The port's greedy NMS (``wssdl_bus_tpu_torch/ops/nms.py:nms_mask`` and the
CPU dispatch of ``ops/nms_cuda.py:nms_keep``) against the JAX package's
Pallas kernel in interpret mode, its XLA ``nms_mask`` at the full 6000-box
test budget, and the numpy oracle.  Keep sets must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import oracles
from wssdl_bus_tpu.ops.nms import nms_mask as jax_nms_mask
from wssdl_bus_tpu.ops.nms_pallas import nms_keep_pallas
from wssdl_bus_tpu_torch.ops.nms import nms_mask
from wssdl_bus_tpu_torch.ops.nms_cuda import nms_keep


def _rand_boxes(rng, n, scale=400.0):
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(5, scale / 2, (n, 2))
    return np.hstack([xy, xy + wh]).astype(np.float32)


def _sorted_case(n, scale=400.0, invalid_frac=0.1):
    rng = np.random.RandomState(n)
    boxes = _rand_boxes(rng, n, scale)
    scores = rng.uniform(size=n).astype(np.float32)
    order = np.argsort(-scores, kind="stable")
    valid = np.ones(n, bool)
    if n > 200:  # knock out some rows: invalid rows must be inert
        valid[rng.choice(n, int(n * invalid_frac), replace=False)] = False
    return boxes[order], scores[order], valid


def _oracle_keep(sb, scores, valid, thresh):
    vi = np.where(valid)[0]
    dets = np.hstack([sb[vi], scores[vi, None]])
    want = np.zeros(len(sb), bool)
    want[vi[oracles.nms_oracle(dets, thresh)]] = True
    return want


def _port(sb, valid, thresh):
    return nms_mask(torch.from_numpy(sb.T.copy())[None],
                    torch.from_numpy(valid)[None], thresh)[0].numpy()


@pytest.mark.parametrize("n,thresh", [(130, 0.7), (400, 0.5), (1111, 0.7)])
def test_nms_matches_pallas_and_oracle(n, thresh):
    sb, scores, valid = _sorted_case(n)
    want = _oracle_keep(sb, scores, valid, thresh)
    got = _port(sb, valid, thresh)
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(nms_keep_pallas(
        jnp.asarray(sb.T), jnp.asarray(valid), thresh, interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_nms_full_test_budget_matches_jax():
    """N = 6000 (TEST.RPN_PRE_NMS_TOP_N) on a crowded canvas, where chains
    of suppression run deep."""
    sb, _, valid = _sorted_case(6000, scale=800.0)
    want = np.asarray(jax_nms_mask(jnp.asarray(sb), jnp.asarray(valid), 0.7))
    got = _port(sb, valid, 0.7)
    assert 0 < got.sum() < valid.sum()
    np.testing.assert_array_equal(got, want)


def test_nms_threshold_is_inclusive():
    """IoU exactly 0.7 (inter 70, union 100 in f32) suppresses, like the
    reference's ``>=``."""
    sb = np.array([[0, 0, 9, 9], [0, 0, 9, 6], [20, 20, 29, 29],
                   [20, 20, 29, 25]], np.float32)
    valid = np.ones(4, bool)
    got = _port(sb, valid, 0.7)
    np.testing.assert_array_equal(got, [True, False, True, True])
    want = _oracle_keep(sb, np.array([4, 3, 2, 1], np.float32), valid, 0.7)
    np.testing.assert_array_equal(got, want)


def test_nms_keep_cpu_dispatch_batched():
    """The wrapper takes the plain version for CPU tensors, image by image
    over the batch, and does not count a kernel launch."""
    cases = [_sorted_case(n) for n in (300, 300)]
    cases[1][2][:] = False                      # an all-invalid image
    boxes_t = torch.stack([torch.from_numpy(c[0].T.copy()) for c in cases])
    valid = torch.stack([torch.from_numpy(c[2]) for c in cases])
    before = nms_keep.launches
    got = nms_keep(boxes_t, valid, 0.7).numpy()
    assert nms_keep.launches == before
    np.testing.assert_array_equal(got[0], _oracle_keep(*cases[0], 0.7))
    assert not got[1].any()
