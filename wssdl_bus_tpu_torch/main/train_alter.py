"""Alternating-minibatch training CLI (counterpart of
``wssdl_bus_tpu/main/train_alter.py``, the reference's
``code/main/train_alter.py``): a supervised step while s_start_iter <= it
<= s_end_iter and a weak MIL step while ws_start_iter <= it <= ws_end_iter,
each with its own optimizer state.

    python -m wssdl_bus_tpu_torch.main.train_alter --data_dir <SNUBH_BUS> \\
        [--s_end_iter N] [--ws_start_iter M] [--device cpu] ...

Supervised-only training: set --ws_start_iter > --max_iters
(train_alter.py:3-5).  Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

from wssdl_bus_tpu_torch.main.train import parse_args, setup


def main(argv=None):
    """-> the Solver after training."""
    from wssdl_bus_tpu_torch.train.solver import train_net_alter

    pos, kw = setup(parse_args(argv, "Train a Faster R-CNN network "
                                     "(alternating minibatches)"))
    return train_net_alter(*pos, **kw)


if __name__ == "__main__":
    main()
