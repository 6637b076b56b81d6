"""The port's proposal layer (``wssdl_bus_tpu_torch/ops/proposal.py``) against
the JAX package's ``ops/proposal.py:proposal_layer`` on the same synthetic
RPN outputs: the full TEST budget (38x50x9 anchors, 6000 -> 300, NMS 0.7),
a small budget, and a case full of exact score ties.  Order, boxes and the
valid mask must match exactly; boxes to within two f32 ulps at the canvas
scale (``exp`` may differ by an ulp between XLA and PyTorch, which moves a
~600 px wide box's corners by 3e-5 to 1.2e-4 px)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wssdl_bus_tpu.ops import boxes as jax_boxes
from wssdl_bus_tpu.ops.anchors import shifted_anchors as jax_anchors
from wssdl_bus_tpu.ops.proposal import proposal_layer as jax_proposal_layer
from wssdl_bus_tpu_torch.ops import boxes
from wssdl_bus_tpu_torch.ops.anchors import shifted_anchors
from wssdl_bus_tpu_torch.ops.proposal import proposal_layer, proposals_to_rois

A = 9
BOX_ATOL = 2 * float(np.spacing(np.float32(1024.0)))   # 2.4e-4 px


def _rpn_outputs(seed, b, h, w, tie_levels=None):
    """Softmaxed fg/bg probabilities [B, H, W, 2A] in the reference layout
    (bg channels first) and small box deltas [B, H, W, 4A].  With
    ``tie_levels`` the fg probabilities are snapped to that many values, so
    most scores tie exactly."""
    rng = np.random.RandomState(seed)
    fg = rng.uniform(0.0, 1.0, (b, h, w, A)).astype(np.float32)
    if tie_levels:
        fg = (np.floor(fg * tie_levels) / tie_levels).astype(np.float32)
    prob = np.concatenate([1.0 - fg, fg], axis=-1).astype(np.float32)
    deltas = (rng.randn(b, h, w, 4 * A) * 0.2).astype(np.float32)
    return prob, deltas


def _im_info(b, canvas):
    info = np.zeros((b, 4), np.float32)
    for i in range(b):
        # image extents below the canvas clip boxes differently per image
        info[i] = [canvas[0] - 37 * i, canvas[1] - 53 * i, 1.2 + 0.3 * i, 0]
    return info


def _compare(prob, deltas, info, anchors, pre, post):
    want = jax_proposal_layer(jnp.asarray(prob), jnp.asarray(deltas),
                              jnp.asarray(info), jnp.asarray(anchors),
                              num_anchors=A, pre_nms_top_n=pre,
                              post_nms_top_n=post, nms_thresh=0.7,
                              min_size=16.0)
    got = proposal_layer(torch.from_numpy(prob), torch.from_numpy(deltas),
                         torch.from_numpy(info), torch.from_numpy(anchors),
                         num_anchors=A, pre_nms_top_n=pre,
                         post_nms_top_n=post, nms_thresh=0.7, min_size=16.0)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=BOX_ATOL)
    return got


@pytest.mark.parametrize("b,h,w,pre,post,ties", [
    (2, 38, 50, 6000, 300, None),     # the full TEST budget
    (2, 12, 16, 200, 32, None),       # a small budget
    (2, 12, 16, 600, 64, 20),         # exact ties everywhere
])
def test_proposal_layer_matches_jax(b, h, w, pre, post, ties):
    canvas = (h * 16, w * 16)
    anchors = shifted_anchors(h, w)
    np.testing.assert_array_equal(anchors, jax_anchors(h, w))
    prob, deltas = _rpn_outputs(h * w + (ties or 0), b, h, w, ties)
    got = _compare(prob, deltas, _im_info(b, canvas), anchors, pre, post)
    assert got.boxes.shape == (b, post, 4)
    assert got.valid.any(dim=1).all()


def test_proposals_to_rois_layout():
    prob, deltas = _rpn_outputs(0, 2, 6, 8)
    props = proposal_layer(torch.from_numpy(prob), torch.from_numpy(deltas),
                           torch.from_numpy(_im_info(2, (96, 128))),
                           torch.from_numpy(shifted_anchors(6, 8)),
                           pre_nms_top_n=100, post_nms_top_n=10)
    rois = proposals_to_rois(props).numpy()
    assert rois.shape == (20, 5)
    np.testing.assert_array_equal(rois[:, 0], np.repeat([0.0, 1.0], 10))
    np.testing.assert_array_equal(rois[:, 1:], props.boxes.reshape(20, 4))


def test_box_geometry_matches_jax():
    """bbox_transform / bbox_transform_inv (two classes) / clip_boxes /
    iou_matrix against the JAX package's ops/boxes.py, +1 convention.
    Ratios, log and exp may differ by an ulp between XLA and PyTorch."""
    rng = np.random.RandomState(0)
    xy = rng.uniform(-50, 400, (64, 2))
    a = np.hstack([xy, xy + rng.uniform(0, 200, (64, 2))]).astype(np.float32)
    b = (a + rng.uniform(-30, 30, (64, 4))).astype(np.float32)
    b[:, 2:] = np.maximum(b[:, 2:], b[:, :2])
    deltas = (rng.randn(64, 8) * 0.3).astype(np.float32)
    ta, tb, td = (torch.from_numpy(x) for x in (a, b, deltas))
    np.testing.assert_allclose(boxes.bbox_transform(ta, tb).numpy(),
                               jax_boxes.bbox_transform(a, b),
                               rtol=1e-6, atol=1e-6)
    inv = boxes.bbox_transform_inv(ta, td)
    np.testing.assert_allclose(inv.numpy(),
                               jax_boxes.bbox_transform_inv(a, deltas),
                               rtol=0, atol=BOX_ATOL)
    np.testing.assert_array_equal(
        boxes.clip_boxes(inv, 300, 350).numpy(),
        jax_boxes.clip_boxes(np.asarray(inv), 300, 350))
    np.testing.assert_allclose(boxes.iou_matrix(ta, tb).numpy(),
                               jax_boxes.iou_matrix(a, b), rtol=1e-6,
                               atol=1e-7)
