"""Shared CLI plumbing for the port's entry points (counterpart of
``wssdl_bus_tpu/main/common.py``; the reference's ``code/main/train.py:18-48``
arguments).

Used by ``main/test.py``, ``main/train.py``, ``main/train_alter.py``,
``main/export.py`` and ``main/predict.py``.  ``--bf16`` builds the
detector with bf16 convs and dense layers
(``models/detector.py:build_detector(compute_dtype=)``); ``--remat``
{true, false, head, trunk} overrides the backbone's activation-remat
default (``build_detector(remat=)``: off for VGG16, full remat for every
ResNet), which applies in training only, so the serving and evaluation
CLIs accept it and serve the same detections.  What the port has no path
for yet raises ``NotImplementedError`` naming the ROADMAP item, never
silently ignored: ``--mesh_data`` / ``--mesh_model`` > 1 (A10).  The JAX
package's XLA compilation cache has no counterpart here.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data.augment import max_canvas
from wssdl_bus_tpu_torch.data.dataset import (get_imdb, get_training_roidb,
                                              prepare_roidb)


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("--network", default="VGGnet_train", type=str,
                        help="name of the network (VGGnet_train / "
                             "VGGnet_test / Resnet_train / Resnet_test)")
    parser.add_argument("--net_depth", default=18, type=int,
                        help="ResNet depth (18, 34, 50, 101)")
    parser.add_argument("--dataset", default="SNUBH", type=str,
                        help="dataset mode (SNUBH / SNUBH_FG / UDIAT)")
    parser.add_argument("--norm_type", default="BN", type=str,
                        help="ResNet normalization type (BN / GN)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 conv / dense compute with f32 "
                             "params; norms, losses and detection geometry "
                             "stay f32")
    parser.add_argument("--remat", default=None,
                        choices=["true", "false", "head", "trunk"],
                        help="override the backbone's activation-remat "
                             "default (off for VGG16, true for ResNet; "
                             "models/detector.py:build_detector); applies "
                             "to training only")
    parser.add_argument("--data_dir", default="./SNUBH_BUS", type=str,
                        help="SNUBH_BUS dataset root")
    parser.add_argument("--set_cfgs", default=None, nargs=argparse.REMAINDER,
                        help="override config keys, e.g. "
                             "TEST.DEBUG_TIMELINE True")
    parser.add_argument("--cfg", default=None, type=str,
                        help="optional YAML config override file")
    parser.add_argument("--randomize", action="store_true",
                        help="do not fix the random seed")
    parser.add_argument("--output_dir", default="./trained_model/run",
                        type=str)
    parser.add_argument("--mesh_data", default=1, type=int,
                        help="data-parallel extent (only 1 is ported)")
    parser.add_argument("--mesh_model", default=1, type=int,
                        help="tensor-parallel extent (only 1 is ported)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="device to run on: cuda (default) or cpu")


def check_ported(args) -> None:
    """Raise for the options the port has no path for yet."""
    if getattr(args, "mesh_data", 1) * getattr(args, "mesh_model", 1) > 1:
        raise NotImplementedError(
            "--mesh_data / --mesh_model > 1: multi-device is not ported yet "
            "(ROADMAP.md A10, multi-device)")


def build_model(args, cfg: Config, freeze_stem: bool = True):
    """The one CLI -> detector construction, on ``args.device`` (PyTorch's
    default init: a snapshot or converted weights are loaded into it):
    ``--network``, and for ``Resnet_*`` ``--net_depth``, ``--norm_type``
    (BN / GN) and the GN group heuristic of ``cfg``
    (TRAIN.GN_MIN_NUM_G / GN_MIN_CHS_PER_G); ``--remat`` its activation
    remat (None, the backbone's default, when not given; the JAX CLI's
    mapping); ``--bf16`` its compute dtype
    (the solver trains and evaluates the model it is given, so the dtype
    reaches ``main.train`` / ``main.train_alter`` through it, where the JAX
    package passes ``compute_dtype`` down to its ``build_detector``).
    ``freeze_stem`` False lets a
    VGG16 training network's conv1/conv2 train (``--unfreeze_stem``); the
    stem kernels then never run in training
    (``models/detector.py:stem_is_frozen``)."""
    from wssdl_bus_tpu_torch.models.detector import build_detector

    check_ported(args)
    if args.network.startswith("Resnet") and args.norm_type not in ("BN",
                                                                     "GN"):
        # the JAX CLI builds any other value as a detector with neither
        # norms nor conv biases, a tree no port model has
        raise ValueError(f"--norm_type must be BN or GN for a ResNet, got "
                         f"{args.norm_type!r}")
    remat = getattr(args, "remat", None)
    return build_detector(args.network, num_classes=3, device=args.device,
                          freeze_stem=freeze_stem, depth=args.net_depth,
                          norm=args.norm_type,
                          gn_params=(cfg.TRAIN.GN_MIN_NUM_G,
                                     cfg.TRAIN.GN_MIN_CHS_PER_G),
                          compute_dtype=(torch.bfloat16
                                         if getattr(args, "bf16", False)
                                         else None),
                          remat={None: None, "true": True,
                                 "false": False}.get(remat, remat))


def add_train_args(parser: argparse.ArgumentParser):
    parser.add_argument("--max_iters", default=60000, type=int)
    parser.add_argument("--s_start_iter", default=0, type=int)
    parser.add_argument("--s_end_iter", default=60000, type=int)
    parser.add_argument("--ws_start_iter", default=0, type=int)
    parser.add_argument("--ws_end_iter", default=60000, type=int)
    parser.add_argument("--pretrained_model", default=None, type=str,
                        help="path to an ImageNet .npy weight dict")
    parser.add_argument("--unfreeze_stem", action="store_true",
                        help="let VGG conv1/conv2 train (the reference "
                             "freezes them: right with ImageNet weights, "
                             "fatal from scratch, where a frozen random stem "
                             "leaves the trunk featureless)")
    parser.add_argument("--opt", default="adam", type=str,
                        help="adam / amsgrad / sgd")
    parser.add_argument("--lr", default=5e-4, type=float)
    parser.add_argument("--lr_scheduling", default="const", type=str,
                        help="const / pc / rop")
    parser.add_argument("--imdb_train_s", default="bus_test", type=str)
    parser.add_argument("--imdb_train_ws", default="bus_test", type=str)
    parser.add_argument("--imdb_test", default="bus_test", type=str)
    # tri-state prefetch: --prefetch forces on, --no_prefetch forces off,
    # neither defers to cfg.TRAIN.USE_PREFETCH
    parser.add_argument("--prefetch", action="store_true",
                        help="overlap host-side augmentation with the device "
                             "step on a background thread")
    parser.add_argument("--no_prefetch", action="store_true")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest snapshot in output_dir")
    parser.add_argument("--qual_res", action="store_true",
                        help="save qualitative overlays during in-loop eval")
    parser.add_argument("--eval_batch", default=1, type=int,
                        help="test images per device step during in-loop "
                             "eval")


def prefetch_choice(args):
    """-> True / False / None (None = honor cfg.TRAIN.USE_PREFETCH)."""
    if args.no_prefetch:
        return False
    if args.prefetch:
        return True
    return None


def build_config(args) -> Config:
    cfg = Config.from_yaml(args.cfg) if args.cfg else Config()
    if args.set_cfgs:
        cfg = cfg.with_overrides(args.set_cfgs)
    if hasattr(args, "lr"):
        cfg = cfg.with_overrides(["TRAIN.LEARNING_RATE", str(args.lr)])
    return cfg


def load_train_data(args, cfg: Config):
    """-> (roidb_s, roidb_ws, imdb_test, roidb_test, canvas_hw)."""
    imdb_s = get_imdb(args.imdb_train_s, args.data_dir)
    roidb_s = get_training_roidb(imdb_s, use_flipped=cfg.TRAIN.USE_FLIPPED)
    imdb_ws = get_imdb(args.imdb_train_ws, args.data_dir)
    roidb_ws = get_training_roidb(imdb_ws, use_flipped=cfg.TRAIN.USE_FLIPPED)
    imdb_test = get_imdb(args.imdb_test, args.data_dir)
    roidb_test = prepare_roidb(imdb_test)

    sizes = [(e["height"], e["width"])
             for e in roidb_s + roidb_ws + roidb_test]
    canvas = max_canvas(sizes, cfg.TRAIN.SCALES[0], cfg.TRAIN.MAX_SIZE,
                        crop_margin=(cfg.TRAIN.CROPPING_MAX_MARGIN
                                     if cfg.TRAIN.USE_CROPPING else 0.0))
    return roidb_s, roidb_ws, imdb_test, roidb_test, canvas


def seed_all(args, cfg: Config):
    if not args.randomize:
        np.random.seed(cfg.RNG_SEED)
        torch.manual_seed(cfg.RNG_SEED)
