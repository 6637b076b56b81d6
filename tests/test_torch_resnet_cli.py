"""The port's entry points with ``--network Resnet_*`` on the CPU
(``--device cpu``) over the synthetic SNUBH-layout imdb of
``tests/test_torch_solver.py`` at its tiny config (64-px scale, default
``TRAIN.DEVICE_PREP``), at the full ResNet-18 BN width:

  * ``main.train``: 3 iterations with an evaluation after each and
    snapshots at 2 and 3, whose variables carry BatchRenorm's running
    statistics (moved from their init); ``--resume`` from the iteration-2
    snapshot writes an iteration-3 snapshot equal bit for bit (parameters,
    running statistics, moments, test losses, generator and data-layer
    state);
  * ``main.train_alter``: supervised 0-2, weak 1-3, two optimizer states;
  * ``main.test --network Resnet_test`` on the iteration-3 snapshot, at
    batch 2, with GN's group heuristic from the config when
    ``--norm_type GN``;
  * the model the CLI builds: the JAX CLI's variable tree for
    ``--norm_type BN`` / ``GN``, and any other value refused;
  * the ResNet pixel scale (``/(PIXEL_STD/255)``) on every path: the
    device-prepped training blob and the host-prepped test blob."""

import os
import pickle

import numpy as np
import pytest
import torch

from tests.test_torch_solver import (SNAP, _argv, _assert_same_snapshot,
                                     _resume_copy, data_dir, runs)  # noqa
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data.augment import prep_image
from wssdl_bus_tpu_torch.main import test as main_test
from wssdl_bus_tpu_torch.main import train, train_alter
from wssdl_bus_tpu_torch.ops.device_prep import net_divisor_for
from wssdl_bus_tpu_torch.train.checkpoint import load_checkpoint

RESNET = ["--network", "Resnet_train", "--net_depth", "18", "--norm_type",
          "BN"]


def test_train_resume_and_test(data_dir, runs):  # noqa: F811
    a, b = str(runs / "a"), str(runs / "b")
    kw = dict(iters=3, test_iters=1)
    solver = train.main(_argv(data_dir, a, *RESNET, "--no_prefetch", **kw))
    assert solver.eng.model.backbone == "Resnet"
    assert solver.net_name == "Resnet_train"
    assert len(solver.stats["eval"]) == 3
    for e in solver.stats["eval"]:
        assert np.isfinite(e["test_loss"]).all() and e["images"] == 4
    variables, step = load_checkpoint(os.path.join(a, SNAP.format(3)))
    assert step == 3
    stats = [k for k in variables if k.endswith((".mean", ".var"))]
    assert len(stats) == 60
    assert not torch.equal(variables["trunk.backbone.conv0.bn.mean"],
                           torch.zeros(64))
    assert not torch.equal(variables["head.group3_norm.var"],
                           torch.ones(512))

    _resume_copy(a, b)
    resumed = train.main(_argv(data_dir, b, *RESNET, "--no_prefetch",
                               "--resume", **kw))
    assert resumed.start_iter == 2
    _assert_same_snapshot(os.path.join(a, SNAP.format(3)),
                          os.path.join(b, SNAP.format(3)), ("opt_state",),
                          n_evals=3)

    out = str(runs / "test")
    all_boxes, result = main_test.main([
        "--model", os.path.join(a, SNAP.format(3)), "--data_dir", data_dir,
        "--device", "cpu", "--network", "Resnet_test", "--net_depth", "18",
        "--norm_type", "BN", "--batch_size", "2", "--output_dir", out,
        "--set_cfgs", "TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96",
        "ANCHOR_SCALES", "(2, 4, 8)", "TEST.RPN_PRE_NMS_TOP_N", "50",
        "TEST.RPN_POST_NMS_TOP_N", "8"])
    assert len(result) == 3
    assert {"detections.pkl", "eval.txt"} <= set(os.listdir(out))
    with open(os.path.join(out, "detections.pkl"), "rb") as f:
        assert len(pickle.load(f)) == len(all_boxes) == 3


def test_train_alter(data_dir, runs):  # noqa: F811
    a = str(runs / "a")
    solver = train_alter.main(_argv(data_dir, a, *RESNET, "--s_end_iter",
                                    "2", "--ws_start_iter", "1"))
    assert solver.ws_step == 3
    _, _, opt, opt_ws = load_checkpoint(os.path.join(a, SNAP.format(4)),
                                        opt_state=True, opt_state_ws=True)
    assert opt["count"] == 3 and opt_ws["count"] == 3
    assert "trunk.backbone.conv0.bn.gamma" in opt_ws["mu"]


def test_gn_model_from_cli_config(data_dir, tmp_path):  # noqa: F811
    """``--norm_type GN`` takes its group heuristic from the config."""
    from wssdl_bus_tpu_torch.main.common import build_model
    from wssdl_bus_tpu_torch.models.layers import GroupNormRef

    args = train.parse_args(_argv(data_dir, str(tmp_path), "--network",
                                  "Resnet_train", "--net_depth", "50",
                                  "--norm_type", "GN"))
    cfg = Config().with_overrides(["TRAIN.GN_MIN_NUM_G", "32",
                                   "TRAIN.GN_MIN_CHS_PER_G", "16"])
    model = build_model(args, cfg)
    gns = [m for m in model.modules() if isinstance(m, GroupNormRef)]
    assert gns and model.depth == 50
    for m in gns:
        assert m.groups == max(1, min(32, m.gamma.numel() // 16))


def test_resnet_pixel_scale(data_dir):  # noqa: F811
    """VGG16 blobs are x255, ResNet ones /(PIXEL_STD/255), on the host and
    in the device prep's multiplier."""
    cfg = Config()
    im = np.random.RandomState(0).randint(0, 255, (40, 60)).astype(np.uint8)
    vgg, _ = prep_image(im, "VGGnet_test", cfg)
    res, _ = prep_image(im, "Resnet_test", cfg)
    np.testing.assert_allclose(res * (cfg.PIXEL_STD / 255.0), vgg / 255.0,
                               rtol=1e-5, atol=1e-6)
    assert net_divisor_for("Resnet", cfg.PIXEL_STD) == \
        pytest.approx(255.0 / cfg.PIXEL_STD)
    assert net_divisor_for("VGGnet", cfg.PIXEL_STD) == 255.0


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape)


@pytest.mark.parametrize("norm_type", ["BN", "GN", "None"])
def test_cli_model_tree_matches_jax_cli(norm_type):
    """The same ``--network Resnet_train --norm_type`` argv gives the JAX
    CLI's variable tree (every path and shape, by ``jax.eval_shape``) or is
    refused: the JAX CLI builds any value but BN / GN as a detector with
    neither norms nor conv biases, a tree no port model has."""
    import argparse

    import jax

    from wssdl_bus_tpu.config import Config as JaxConfig
    from wssdl_bus_tpu.main import common as jax_common
    from wssdl_bus_tpu_torch.main import common
    from wssdl_bus_tpu_torch.models.convert import params_to_jax

    argv = ["--network", "Resnet_train", "--net_depth", "18", "--norm_type",
            norm_type]
    jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
    jax_common.add_common_args(jp)
    common.add_common_args(tp)
    jm = jax_common.build_model(jp.parse_args(argv), JaxConfig())
    want = dict(_leaves(jax.eval_shape(
        lambda: jm.init_variables(jax.random.PRNGKey(0), (64, 96)))))
    args = tp.parse_args(argv + ["--device", "cpu"])
    if norm_type not in ("BN", "GN"):
        assert [p for p in want if "conv0" in p] == [
            ("trunk", "params", "backbone", "conv0", "conv", "kernel")]
        with pytest.raises(ValueError, match="--norm_type must be BN or GN"):
            common.build_model(args, Config())
        return
    model = common.build_model(args, Config())
    assert dict(_leaves(params_to_jax(model.state_dict()))) == want
