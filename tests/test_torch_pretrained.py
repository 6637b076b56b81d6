"""The port's pretrained import (``models/pretrained.py``) against the JAX
package's, on synthetic weight dicts only (nothing is downloaded).

Both sides get the same flax-layout numpy tree, read off the port's
VGG16 detector with ``models/convert.py:params_to_jax``, and the same
``{scope: {var: value}}`` dict; their results go back through
``params_from_jax`` and the two state dicts must be equal bit for bit.
Cases: VGG's flat conv scopes, the ``rpn_conv/3x3`` alias (also split
across the var name), a 4096-wide fc6 that does not fit (skipped), an
unknown scope (skipped), ``min_loaded`` raising, a ``.npy`` file through
``load_pretrained_auto``, and a synthetic torchvision ``vgg16`` state dict
(the conv1_1 normalisation fold) through a ``.pth`` file."""

import numpy as np
import pytest
import torch

from wssdl_bus_tpu.models import pretrained as jax_pretrained
from wssdl_bus_tpu_torch.models import pretrained
from wssdl_bus_tpu_torch.models.convert import (params_from_jax,
                                                params_to_jax)
from wssdl_bus_tpu_torch.models.detector import build_detector


@pytest.fixture(scope="module")
def model():
    return build_detector("VGGnet_train", device="cpu")


def _shape(tree, *path):
    node = tree
    for p in path:
        node = node[p]
    return np.shape(node)


def _vgg_dict(tree, rng):
    bb = ("trunk", "params", "backbone")
    data = {}
    for scope in ("conv1_1", "conv2_2", "conv3_1", "conv5_3"):
        data[scope] = {
            "weights": rng.standard_normal(
                _shape(tree, *bb, scope, "conv", "kernel")).astype(
                    np.float32),
            "biases": rng.standard_normal(
                _shape(tree, *bb, scope, "conv", "bias")).astype(np.float32)}
    rpn = ("trunk", "params", "rpn_conv", "conv")
    # the scope split across the var name, as the reference's loader
    # accepts it
    data["rpn_conv"] = {"3x3/weights": rng.standard_normal(
        _shape(tree, *rpn, "kernel")).astype(np.float32)}
    data["rpn_conv/3x3"] = {
        "biases": np.full(_shape(tree, *rpn, "bias"), 0.5, np.float32)}
    data["fc6"] = {"weights": np.ones((25088, 4096), np.float32),
                   "biases": np.ones((4096,), np.float32)}
    data["fc8"] = {"weights": np.ones((4096, 1000), np.float32)}
    return data


def _equal(a, b):
    sa, sb = params_from_jax(a), params_from_jax(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    return sa


def test_npy_dict_matches_jax(model, tmp_path):
    tree = params_to_jax(model.state_dict())
    data = _vgg_dict(tree, np.random.RandomState(0))
    got = pretrained.load_pretrained_dict(data, tree, "VGGnet")
    want = jax_pretrained.load_pretrained_dict(data, tree, "VGGnet")
    sd = _equal(got, want)
    np.testing.assert_array_equal(
        sd["trunk.backbone.conv1_1.conv.weight"].numpy(),
        data["conv1_1"]["weights"].transpose(3, 2, 0, 1))
    assert torch.equal(sd["trunk.rpn_conv.conv.bias"],
                       torch.full((512,), 0.5))
    np.testing.assert_array_equal(
        sd["trunk.rpn_conv.conv.weight"].numpy(),
        data["rpn_conv"]["3x3/weights"].transpose(3, 2, 0, 1))
    before = model.state_dict()
    for k in ("head.fc6.dense.weight", "head.fc6.dense.bias",
              "trunk.backbone.conv1_2.conv.weight"):
        assert torch.equal(sd[k], before[k]), k     # skipped / untouched
    # the input tree is not changed
    assert np.array_equal(params_to_jax(model.state_dict())["trunk"][
        "params"]["backbone"]["conv1_1"]["conv"]["kernel"],
        tree["trunk"]["params"]["backbone"]["conv1_1"]["conv"]["kernel"])

    path = str(tmp_path / "vgg.npy")
    np.save(path, data, allow_pickle=True)
    _equal(pretrained.load_pretrained_auto(path, tree, "VGGnet"),
           jax_pretrained.load_pretrained_auto(path, tree, "VGGnet"))
    with pytest.raises(ValueError, match="matched only 0"):
        pretrained.load_pretrained_dict({"nope": data["fc8"]}, tree,
                                        "VGGnet", min_loaded=1)
    with pytest.raises(ValueError, match="matched only 0"):
        jax_pretrained.load_pretrained_dict({"nope": data["fc8"]}, tree,
                                            "VGGnet", min_loaded=1)


def test_load_pretrained_model_in_place(tmp_path):
    m = build_detector("VGGnet_train", device="cpu")
    tree = params_to_jax(m.state_dict())
    data = _vgg_dict(tree, np.random.RandomState(1))
    path = str(tmp_path / "vgg.npy")
    np.save(path, data, allow_pickle=True)
    want = params_from_jax(pretrained.load_pretrained_dict(data, tree,
                                                           "VGGnet"))
    pretrained.load_pretrained_model(path, m, min_loaded=10)
    for k, v in m.state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError):
        pretrained.load_pretrained_model(path, m, min_loaded=11)


def _torchvision_vgg16(rng):
    """A state dict with torchvision ``vgg16``'s keys and shapes."""
    sd, c_in, idx = {}, 3, 0
    for block in ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
                  (512, 512, 512)):
        for c in block:
            sd[f"features.{idx}.weight"] = torch.from_numpy(
                rng.standard_normal((c, c_in, 3, 3)).astype(np.float32))
            sd[f"features.{idx}.bias"] = torch.from_numpy(
                rng.standard_normal(c).astype(np.float32))
            c_in = c
            idx += 2
        idx += 1
    sd["classifier.0.weight"] = torch.zeros((4096, 25088))
    return sd


def test_torchvision_import_matches_jax(model, tmp_path):
    tree = params_to_jax(model.state_dict())
    sd = _torchvision_vgg16(np.random.RandomState(3))
    got = pretrained.load_pretrained_torchvision(sd, tree, "VGGnet",
                                                 pixel_mean=68.274)
    want = jax_pretrained.load_pretrained_torchvision(sd, tree, "VGGnet",
                                                      pixel_mean=68.274)
    _equal(got, want)
    ref = pretrained.torchvision_vgg16_to_reference(
        {k: v.numpy() for k, v in sd.items()})
    jref = jax_pretrained.torchvision_vgg16_to_reference(
        {k: v.numpy() for k, v in sd.items()})
    assert ref.keys() == jref.keys() and len(ref) == 13
    for scope in ref:
        for var in ("weights", "biases"):
            np.testing.assert_array_equal(ref[scope][var], jref[scope][var])
    path = str(tmp_path / "vgg16.pth")
    torch.save(sd, path)
    _equal(pretrained.load_pretrained_auto(path, tree, "VGGnet",
                                           min_loaded=26),
           jax_pretrained.load_pretrained_auto(path, tree, "VGGnet",
                                               min_loaded=26))
    with pytest.raises(ValueError, match="VGG16 only"):
        pretrained.load_pretrained_torchvision(sd, tree, "Resnet")
    with pytest.raises(ValueError, match="features"):
        pretrained.torchvision_vgg16_to_reference({})
