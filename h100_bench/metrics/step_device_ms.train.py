"""step_device_ms.train: milliseconds between CUDA events around each
``Engine.train_step`` call, the mean over the window's steps."""


def read(ctx):
    times = ctx.get("step_device_s")
    return 1e3 * sum(times) / len(times) if times else None
