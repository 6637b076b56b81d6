"""roi_pool_fwd_roofline.train: the traced steps' ROI-pool forward
launches (kernel #3, ``roi_pool_fwd_*``): the time their bytes need at the
card's HBM bandwidth over their device time, in percent.  Nothing when
the trace holds another number of launches than the steps need."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    launches, seconds = tr.kernel_seconds("roi_pool_fwd_")
    want = ctx["trace_steps"] * ctx["roi_pool_launches_per_step"]
    if launches != want or seconds <= 0:
        return None
    need = ctx["trace_steps"] * ctx["roi_pool_fwd_bytes"] / \
        ctx["peak_bytes_per_s"]
    return 100.0 * need / seconds
