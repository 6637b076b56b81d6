"""feed_wait_ms.train: host milliseconds a step waits in the data layer's
``Prefetcher.forward()``, the mean over the window's steps."""


def read(ctx):
    waits = ctx.get("feed_wait_s")
    return 1e3 * sum(waits) / len(waits) if waits else None
