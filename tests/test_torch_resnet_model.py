"""The ResNet detector's modules and weights: the port's trunk + RPN
(``models/detector.py:TrunkRPN`` over ``models/resnet.py:ResNetBackbone``)
and per-ROI head (``ResNetRCNNHead``) against the JAX package's
``FasterRCNN.apply_trunk`` / ``apply_head`` at ResNet-18 (BN in training
and eval mode, GN) and ResNet-50 (GN, BN in eval mode); the state-dict
tree of every depth and norm against ``jax.eval_shape`` of the JAX
package's ``init_variables``; the weight, optimizer-state and ``.npy``
conversions; and a snapshot's running statistics.

The JAX variables are the port's seeded He weights read off its state dict
(``params_to_jax``), with gamma, beta and the running statistics drawn
away from their init so every norm does work; the tree's structure is held
to flax's own once, by ``eval_shape``.

Tolerances.  He weights through a residual stack grow the activations
block by block (about x2 in variance a block, in value the same in both
BatchRenorm modes: r and d make its training output (x - ra_mean) /
sigma_m), so each output is held relative to its own maximum: 2e-5 of max
|want| per element, the f32 drift of two frameworks summing convs in
another order (measured <= 3.1e-6); the updated running statistics the
same way.  The conversions are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wssdl_bus_tpu.config import Config as JaxConfig
from wssdl_bus_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from wssdl_bus_tpu.models.pretrained import \
    load_pretrained_dict as jax_load_pretrained
from wssdl_bus_tpu.train.engine import make_optimizer
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.models import pretrained
from wssdl_bus_tpu_torch.models.convert import (he_init_, he_tree,
                                                opt_state_from_jax,
                                                params_from_jax,
                                                params_to_jax,
                                                reference_init_)
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.train.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
from wssdl_bus_tpu_torch.train.engine import Optimizer

REL = 2e-5
CANVAS = (72, 100)      # odd sides after conv0 and in group1/group2


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(dict(v), prefix + (k,))
        else:
            yield prefix + (k,), v


def _perturbed(tree, seed):
    """gamma, beta and running statistics away from their init."""
    rng = np.random.RandomState(seed)
    out = {}
    for part in ("trunk", "head"):
        out[part] = {}
        for coll, sub in tree[part].items():
            new = {}
            for path, a in _flat(sub):
                a = np.asarray(a, np.float32)
                leaf = path[-1]
                if leaf in ("gamma", "var"):
                    a = rng.uniform(0.6, 1.4, a.shape).astype(np.float32)
                elif leaf in ("beta", "mean"):
                    a = (0.1 * rng.randn(*a.shape)).astype(np.float32)
                node = new
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = a
            out[part][coll] = new
    return out


def _models(depth, norm, seed=0):
    port = build_detector("Resnet_train", device="cpu", depth=depth,
                          norm=norm)
    tree = _perturbed(he_tree(params_to_jax(port.state_dict()), seed), seed)
    port.load_state_dict(params_from_jax(tree))
    jm = JaxFasterRCNN(backbone="Resnet", depth=depth, norm=norm,
                       remat=False)
    return port, jm, jax.tree.map(jnp.asarray, tree)


def _close(got, want, what):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL * scale, (what, err / scale)


@pytest.mark.parametrize("depth,norm,train", [
    (18, "BN", True), (18, "BN", False), (18, "GN", True),
    (50, "GN", True), (50, "BN", False)])
def test_trunk_and_rpn_match_jax(depth, norm, train):
    port, jm, jv = _models(depth, norm)
    x = np.random.RandomState(depth).randn(2, *CANVAS, 3).astype(np.float32)
    feat, score, bbox, bs = jm.apply_trunk(jv, jnp.asarray(x), train=train)
    port.train(train)
    with torch.no_grad():
        got = port.apply_trunk(torch.from_numpy(x))
    c = 256 if depth == 18 else 1024
    assert tuple(got[0].shape) == (2, 5, 6, c) == feat.shape
    for g, w, name in zip(got, (feat, score, bbox), ("feat", "score",
                                                     "bbox")):
        _close(g.numpy(), w, name)
    stats = params_to_jax(port.state_dict())["trunk"].get("batch_stats")
    if train and norm == "BN":
        n = 0
        for path, want in _flat(bs):
            _close(dict(_flat(stats))[path], want, "/".join(path))
            n += 1
        # conv0, 12 block convs, 2 shortcuts, 5 preact norms, group2_norm,
        # rpn_conv
        assert n == 2 * 22
    elif norm == "BN":
        assert all(np.array_equal(a, np.asarray(dict(_flat(
            jv["trunk"]["batch_stats"]))[p])) for p, a in _flat(stats))


@pytest.mark.parametrize("depth,norm,train", [
    (18, "BN", True), (18, "BN", False), (50, "GN", True)])
def test_head_matches_jax(depth, norm, train):
    port, jm, jv = _models(depth, norm, seed=1)
    c = 256 if depth == 18 else 1024
    rois = np.maximum(np.random.RandomState(2).randn(12, 7, 7, c), 0.0) \
        .astype(np.float32)
    cls, bbox, bs = jm.apply_head(jv, jnp.asarray(rois), train=train)
    port.train(train)
    with torch.no_grad():
        got_cls, got_bbox = port.apply_head(torch.from_numpy(rois))
    assert tuple(got_cls.shape) == (12, 3) and tuple(got_bbox.shape) == \
        (12, 12)
    _close(got_cls.numpy(), cls, "cls_score")
    _close(got_bbox.numpy(), bbox, "bbox_pred")
    if train and norm == "BN":
        stats = dict(_flat(params_to_jax(port.state_dict())["head"]
                           ["batch_stats"]))
        for path, want in _flat(bs):
            _close(stats[path], want, "/".join(path))


@pytest.mark.parametrize("norm", ["BN", "GN", None])
@pytest.mark.parametrize("depth", [18, 34, 50, 101])
def test_state_dict_tree_matches_flax(depth, norm):
    """Every variable of flax's tree (params and batch_stats), same path
    and shape, and nothing else; gamma / beta / the running statistics
    out of weight decay's reach (it takes ``weight`` leaves only)."""
    jm = JaxFasterRCNN(backbone="Resnet", depth=depth, norm=norm)
    shapes = jax.eval_shape(lambda: jm.init_variables(jax.random.PRNGKey(0),
                                                      (64, 96)))
    port = build_detector("Resnet_test", device="cpu", depth=depth,
                          norm=norm)
    want = {p: tuple(v.shape) for p, v in _flat(shapes)}
    got = {p: v.shape for p, v in _flat(params_to_jax(port.state_dict()))}
    assert got == want
    decayed = [n for n, _ in port.named_parameters()
               if n.rsplit(".", 1)[-1] == "weight"]
    assert all(n.endswith(("conv.weight", "dense.weight")) for n in decayed)
    assert len(decayed) == sum(1 for p in want if p[-1] == "kernel")


def test_conversion_round_trip_and_init():
    port = build_detector("Resnet_train", device="cpu", depth=18, norm="BN")
    reference_init_(port, 3)
    sd = port.state_dict()
    assert torch.equal(sd["trunk.backbone.conv0.bn.var"], torch.ones(64))
    assert torch.equal(sd["head.group3_norm.gamma"], torch.ones(512))
    assert torch.equal(sd["head.group3.block0.preact_prev.mean"],
                       torch.zeros(256))
    assert float(sd["head.bbox_pred.dense.weight"].std()) < 0.002
    tree = _perturbed(params_to_jax(sd), 4)
    assert set(tree["trunk"]) == {"params", "batch_stats"}
    back = params_from_jax(tree)
    again = params_to_jax(back)
    for part in ("trunk", "head"):
        want, got = dict(_flat(tree[part])), dict(_flat(again[part]))
        assert want.keys() == got.keys()
        for p in want:
            np.testing.assert_array_equal(got[p], want[p])
    port.load_state_dict(back)     # strict: every key, buffers included
    he = he_init_(build_detector("Resnet_test", device="cpu", depth=18,
                                 norm="GN"), 0)
    assert "batch_stats" not in params_to_jax(he.state_dict())["trunk"]


def test_opt_state_from_jax_over_norm_params():
    """An optax Adam state of the ResNet-18 BN tree (gamma / beta moments
    included) loads into the port's Optimizer, and one more step on each
    side gives the same parameters and moments."""
    port, _, jv = _models(18, "BN", seed=5)
    params = {p: jax.tree.map(np.asarray, jv[p]["params"])
              for p in ("trunk", "head")}
    tx = make_optimizer("adam", JaxConfig(),
                        jax.tree.map(lambda _: True, params))
    rng = np.random.RandomState(5)
    grads = [jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                          params) for _ in range(2)]
    state = tx.init(params)
    state.hyperparams["learning_rate"] = 5e-4
    up, state = tx.update(grads[0], state, params)
    params = optax.apply_updates(params, up)
    port.load_state_dict(params_from_jax(
        {p: {"params": params[p], "batch_stats": jv[p]["batch_stats"]}
         for p in ("trunk", "head")}))
    opt = Optimizer("adam", list(port.named_parameters()))
    conv = opt_state_from_jax(jax.tree.map(np.asarray, state))
    assert "trunk.backbone.conv0.bn.gamma" in conv["mu"]
    opt.load_state_dict(conv)
    up, state = tx.update(grads[1], state, params)
    params = optax.apply_updates(params, up)
    g2 = params_from_jax({p: {"params": grads[1][p]}
                          for p in ("trunk", "head")})
    for n, p in port.named_parameters():
        p.grad = g2[n]
    opt.step(5e-4)
    want = params_from_jax({p: {"params": jax.tree.map(np.asarray,
                                                       params[p])}
                            for p in ("trunk", "head")})
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=0, atol=1e-8, err_msg=n)


def _synthetic_npy(port_tree):
    """A reference-layout ResNet checkpoint dict over ``port_tree``'s
    shapes: slash-nested scopes, ``batch_normalization`` segments in both
    places the reference's loader accepts them, moving statistics, a
    [1,1,1,C] group-norm affine, and keys that match nothing."""
    rng = np.random.RandomState(9)
    p = port_tree["trunk"]["params"]["backbone"]

    def r(shape):
        return rng.randn(*shape).astype(np.float32)

    k0 = p["conv0"]["conv"]["kernel"].shape
    k1 = p["group0"]["block0"]["conv1"]["conv"]["kernel"].shape
    c = p["group2_norm"]["gamma"].shape[0]
    return {
        "conv0": {"weights": r(k0),
                  "batch_normalization/gamma": r((64,)),
                  "batch_normalization/moving_mean": r((64,)),
                  "batch_normalization/moving_variance": r((64,)) ** 2},
        "group0/block0/conv1/batch_normalization": {
            "beta": r((64,)), "moving_variance": r((64,)) ** 2},
        "group0/block0/conv1": {"weights": r(k1)},
        "group2/norm": {"gamma": r((1, 1, 1, c)), "beta": r((1, 1, 1, c))},
        "group1/block1/preact_prev": {"gamma": r((128,))},
        "fc1000": {"weights": r((2048, 1000))},
    }


@pytest.mark.parametrize("norm", ["BN", "GN"])
def test_pretrained_npy_matches_jax(norm, tmp_path):
    port = build_detector("Resnet_train", device="cpu", depth=18, norm=norm)
    he_init_(port, 0)
    tree = params_to_jax(port.state_dict())
    data = _synthetic_npy(tree)
    got = pretrained.load_pretrained_dict(data, tree, "Resnet")
    want = jax_load_pretrained(data, tree, "Resnet")
    a, b = dict(_flat(got)), dict(_flat(want))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))
    path = str(tmp_path / "resnet.npy")
    np.save(path, data, allow_pickle=True)
    pretrained.load_pretrained_model(path, port, min_loaded=5)
    sd = port.state_dict()
    np.testing.assert_array_equal(sd["trunk.backbone.group2_norm.gamma"],
                                  data["group2/norm"]["gamma"].reshape(-1))
    if norm == "BN":
        np.testing.assert_array_equal(
            sd["trunk.backbone.conv0.bn.mean"],
            data["conv0"]["batch_normalization/moving_mean"])
        np.testing.assert_array_equal(
            sd["trunk.backbone.group0.block0.conv1.bn.var"],
            data["group0/block0/conv1/batch_normalization"]
            ["moving_variance"])
    with pytest.raises(ValueError, match="VGG16 only"):
        pretrained.load_pretrained_torchvision({}, tree, "Resnet")


def test_snapshot_restores_running_stats(tmp_path):
    port, _, _ = _models(18, "BN", seed=7)
    path = save_checkpoint(str(tmp_path), "Resnet", "", 3,
                           port.state_dict())
    fresh = build_detector("Resnet_train", device="cpu", depth=18, norm="BN")
    sd, step = load_checkpoint(path)
    fresh.load_state_dict(sd)
    assert step == 3
    n = 0
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
        n += k.endswith((".mean", ".var"))
    assert n == 2 * 30      # the trunk's 21 + rpn_conv + the head's 8


def test_build_detector_names():
    cfg = Config()
    for name, train in (("Resnet_train", True), ("Resnet_test", False),
                        ("Resnet_train_alter", True)):
        m = build_detector(name, device="cpu", depth=18, norm=None,
                           gn_params=(cfg.TRAIN.GN_MIN_NUM_G,
                                      cfg.TRAIN.GN_MIN_CHS_PER_G))
        assert m.training == train and m.backbone == "Resnet"
        assert all(p.requires_grad for p in m.parameters())
    with pytest.raises(KeyError):
        build_detector("Resnet_test", device="cpu", depth=20)
