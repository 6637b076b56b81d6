"""roi_pool_bwd_roofline.train: the traced steps' ROI-pool backward
(kernel #4: its row scan, compaction, argmax and gather kernels): the time
its bytes need at the card's HBM bandwidth over their device time, in
percent."""

KERNELS = ("roi_rows_scan", "roi_rows_compact", "roi_argmax", "roi_gather")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    launches, seconds = tr.kernel_seconds(*KERNELS)
    if not launches or seconds <= 0:
        return None
    need = ctx["trace_steps"] * ctx["roi_pool_bwd_bytes"] / \
        ctx["peak_bytes_per_s"]
    return 100.0 * need / seconds
