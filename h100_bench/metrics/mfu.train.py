"""mfu.train: the model operations of the window's steps (the
benchmark's count, ``hbench/work.py``) over the window's time and the
card's TF32 peak, in percent."""


def read(ctx):
    rate = ctx["steps"] * ctx["step_flops"] / ctx["seconds"]
    return 100.0 * rate / ctx["peak_flops"]
