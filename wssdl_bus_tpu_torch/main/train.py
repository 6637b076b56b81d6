"""Combined-minibatch training CLI (counterpart of
``wssdl_bus_tpu/main/train.py``, the reference's ``code/main/train.py``):

    python -m wssdl_bus_tpu_torch.main.train --data_dir <SNUBH_BUS> \\
        --pretrained_model <VGG16 / ResNet .npy, or torchvision VGG16 .pth> \\
        [--max_iters 60000] [--output_dir ./trained_model/run] \\
        [--set_cfgs TRAIN.SNAPSHOT_ITERS 100 TRAIN.TEST_ITERS 100] \\
        [--resume] [--device cpu]

Reads the three imdbs, sizes the static canvas, builds the detector
(``--network VGGnet_train`` or ``Resnet_train`` with ``--net_depth`` /
``--norm_type``; ``--bf16`` for bf16 convs and dense layers; ``--remat``
for activation remat, by default off for VGG16 and full for ResNet) and
trains it with ``train/solver.py:train_net`` (in-loop evaluation,
snapshots, ``--resume``).  Runs on CUDA unless ``--device cpu``; the options
``main/common.py:check_ported`` names raise.
"""

from __future__ import annotations

import argparse
import pprint

import numpy as np

from wssdl_bus_tpu_torch.main.common import (add_common_args, add_train_args,
                                             build_config, build_model,
                                             load_train_data, prefetch_choice,
                                             seed_all)


def parse_args(argv=None, description="Train a Faster R-CNN network "
                                      "(combined minibatches)"):
    parser = argparse.ArgumentParser(description=description)
    add_train_args(parser)
    add_common_args(parser)
    return parser.parse_args(argv)


def setup(args):
    """-> (the positional and the keyword arguments of ``train_net`` /
    ``train_net_alter``), after printing the arguments and the config."""
    print("Called with args:")
    print(args)
    cfg = build_config(args)
    print("Using config:")
    pprint.pprint(cfg)
    model = build_model(args, cfg, freeze_stem=not args.unfreeze_stem)
    seed_all(args, cfg)
    roidb_s, roidb_ws, imdb_test, roidb_test, canvas = \
        load_train_data(args, cfg)
    print(f"static canvas: {canvas}")
    kw = dict(pretrained_model=args.pretrained_model,
              max_iters=args.max_iters, s_start_iter=args.s_start_iter,
              s_end_iter=args.s_end_iter, ws_start_iter=args.ws_start_iter,
              ws_end_iter=args.ws_end_iter, opt=args.opt, lr=args.lr,
              lr_scheduling=args.lr_scheduling, vis=args.qual_res, cfg=cfg,
              dataset=args.dataset, canvas_hw=canvas,
              use_prefetch=prefetch_choice(args), resume=args.resume,
              seed=(int(np.random.randint(2 ** 31))
                    if args.randomize else None),
              eval_batch=args.eval_batch, device=args.device, model=model)
    return (args.network, roidb_s, roidb_ws, imdb_test, roidb_test,
            args.output_dir), kw


def main(argv=None):
    """-> the Solver after training."""
    from wssdl_bus_tpu_torch.train.solver import train_net

    pos, kw = setup(parse_args(argv))
    return train_net(*pos, **kw)


if __name__ == "__main__":
    main()
