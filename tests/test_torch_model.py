"""The port's VGG16 detector modules (``wssdl_bus_tpu_torch/models``) against
the JAX package's ``FasterRCNN.apply_trunk`` / ``apply_head`` on the same
converted weights, at full VGG16 width on a 192x256 canvas.

Tolerance: rtol 1e-4 plus atol 1e-5 of the reference's max |x|.  Both sides
compute in f32 (the JAX reference on the CPU is true f32, and so are
PyTorch's CPU convolutions), but they sum in different orders through 13
convolutions and 25088-long dot products, so results agree to f32 rounding
accumulated over the depth, not bit for bit."""

import jax
import numpy as np
import pytest
import torch

from wssdl_bus_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from wssdl_bus_tpu.models.detector import rpn_softmax as jax_rpn_softmax
from wssdl_bus_tpu_torch.models.convert import (he_tree, params_from_jax,
                                                params_to_jax)
from wssdl_bus_tpu_torch.models.detector import build_detector, rpn_softmax

CANVAS = (192, 256)
A = 9


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX init tree as numpy, He tree, port model with it)."""
    torch.set_num_threads(2)
    jm = JaxFasterRCNN(backbone="VGGnet")
    # parameter shapes do not depend on the canvas: init on a small one
    tree = jax.tree.map(np.asarray, jm.init_variables(jax.random.PRNGKey(0),
                                                      (32, 32)))
    he = he_tree(tree, seed=1)
    port = build_detector("VGGnet_test", device="cpu")
    port.load_state_dict(params_from_jax(he))
    return jm, tree, he, port


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_params_round_trip(models):
    """JAX tree -> state dict (strict load) -> JAX tree, leaf for leaf."""
    _, tree, _, _ = models
    port = build_detector("VGGnet_test", device="cpu")
    port.load_state_dict(params_from_jax(tree), strict=True)
    back = _flat(params_to_jax(port.state_dict()))
    want = _flat({p: {"params": tree[p]["params"]} for p in tree})
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    sd = port.state_dict()
    assert sd["trunk.backbone.conv1_1.conv.weight"].shape == (64, 3, 3, 3)
    assert sd["head.fc6.dense.weight"].shape == (512, 7 * 7 * 512)


def test_trunk_and_rpn_softmax_match_jax(models):
    jm, _, he, port = models
    data = np.random.RandomState(0).randn(1, *CANVAS, 3).astype(np.float32)
    apply = jax.jit(lambda v, d: jm.apply_trunk(v, d, train=False)[:3])
    want = apply(he, data)
    with torch.no_grad():
        got = port.apply_trunk(torch.from_numpy(data))
    fh, fw = CANVAS[0] // 16, CANVAS[1] // 16
    assert [tuple(g.shape) for g in got] == [(1, fh, fw, 512),
                                             (1, fh, fw, 2 * A),
                                             (1, fh, fw, 4 * A)]
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    _close(rpn_softmax(got[1], A).numpy(), jax_rpn_softmax(want[1], A))


@pytest.mark.parametrize("fc6_order", ["hwc", "chw"])
def test_head_matches_jax_and_pins_fc6_order(models, fc6_order):
    """The pooled operand is NHWC-flattened on both sides, so converted fc6
    rows need no permutation.  Reading them in NCHW (c, h, w) order instead
    must break the match: that is what an NCHW pool would silently do."""
    jm, _, he, port = models
    rng = np.random.RandomState(1)
    pooled = np.maximum(rng.randn(6, 7, 7, 512), 0).astype(np.float32)
    want_cls, want_bbox, _ = jm.apply_head(he, pooled, train=False)
    x = torch.from_numpy(pooled.reshape(6, -1))
    if fc6_order == "chw":
        x = torch.from_numpy(pooled.transpose(0, 3, 1, 2).reshape(6, -1))
    with torch.no_grad():
        cls, bbox = port.apply_head(x)
    if fc6_order == "hwc":
        _close(cls.numpy(), want_cls)
        _close(bbox.numpy(), want_bbox)
    else:
        with pytest.raises(AssertionError):
            _close(cls.numpy(), want_cls)
