"""roi_pool_bwd_active_share.train: of the cotangent rows the ROI-pool
backward (kernel #4) was handed over the measured window, the share its
scan found carrying gradient, in percent (the port's counters
``roi_pool_fc_backward.rows`` and ``.rows_active``).  Nothing where the
program has no such counters."""


def read(ctx):
    rows = ctx.get("pool_bwd_rows")
    if not rows or rows[0] <= 0:
        return None
    return 100.0 * rows[1] / rows[0]
