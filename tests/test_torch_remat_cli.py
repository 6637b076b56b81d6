"""``--remat`` on the training CLIs, on the CPU over the synthetic
SNUBH-layout imdb of ``tests/test_torch_solver.py`` at its tiny config
(64-px scale, default ``TRAIN.DEVICE_PREP``), at the full ResNet-18 BN
width: ``main.train --remat true`` and ``--remat false`` for 2 iterations
(an evaluation and a snapshot at 2) write the same snapshot bit for bit
(parameters, running statistics, moments, test losses, generator and
data-layer state), and so do ``main.train_alter --remat head`` and
``--remat false`` (iteration 0 supervised, 1 both: both optimizer
states).  The flag reaches the model (``build_model`` ->
``build_detector``), and without it a ResNet trains under full remat, the
JAX package's default."""

import os

from tests.test_torch_solver import (SNAP, _argv, _assert_same_snapshot,
                                     data_dir, runs)  # noqa: F401
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.main import train, train_alter
from wssdl_bus_tpu_torch.main.common import build_model

RESNET = ["--network", "Resnet_train", "--net_depth", "18", "--norm_type",
          "BN", "--no_prefetch"]


def test_train_remat_true_equals_false(data_dir, runs):  # noqa: F811
    out = {}
    for remat in ("true", "false"):
        out[remat] = str(runs / remat)
        solver = train.main(_argv(data_dir, out[remat], *RESNET, "--remat",
                                  remat, iters=2, test_iters=2))
        assert solver.eng.model.remat is (remat == "true")
    _assert_same_snapshot(os.path.join(out["true"], SNAP.format(2)),
                          os.path.join(out["false"], SNAP.format(2)),
                          ("opt_state",), n_evals=1)
    args = train.parse_args(_argv(data_dir, out["true"], *RESNET))
    assert build_model(args, Config()).remat is True


def test_train_alter_takes_remat(data_dir, runs):  # noqa: F811
    out = {}
    for remat in ("head", "false"):
        out[remat] = str(runs / remat)
        solver = train_alter.main(_argv(
            data_dir, out[remat], *RESNET, "--remat", remat, "--s_end_iter",
            "1", "--ws_start_iter", "1", iters=2, test_iters=2))
        assert solver.eng.model.remat == (remat if remat == "head"
                                          else False)
        assert solver.ws_step == 1
    _assert_same_snapshot(os.path.join(out["head"], SNAP.format(2)),
                          os.path.join(out["false"], SNAP.format(2)),
                          ("opt_state", "opt_state_ws"), n_evals=1)
