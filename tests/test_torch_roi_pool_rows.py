"""``roi_pool_fc_backward``'s row counters on the CPU path: ``.rows`` counts
the cotangent rows it is handed (B * P), ``.rows_active`` those that carry
gradient by the f32 kernel's rule (``ops/roi_pool.py:live_rows``: a row
with a nonzero entry in some 256-channel block that holds no NaN), summed
where they are made (``ops/roi_pool_cuda.py:DeviceTally``) and read by
``int()``.  The gradient is the plain backward's either way."""

import pytest
import torch

from wssdl_bus_tpu_torch.ops.roi_pool import roi_pool_grad
from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (DeviceTally,
                                                   roi_pool_fc_backward)

B, P, C = 2, 3, 512


def _cotangent(live: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed(7)
    g = torch.zeros((B, P, 49 * C))
    if live == "all":
        g = torch.randn((B, P, 49 * C), generator=gen)
    elif live == "one":
        g[1, 2, 49 * C - 3] = 0.5
    elif live == "nan_only":
        # a NaN in the only nonzero block of row (0, 1): the kernel skips it
        g[0, 1, 300] = float("nan")
        g[0, 1, 301] = 2.0
    return g


@pytest.mark.parametrize("live,want", [("all", B * P), ("one", 1),
                                       ("none", 0), ("nan_only", 0)])
def test_rows_and_rows_active(live, want):
    gen = torch.Generator().manual_seed(3)
    feat = torch.randn((B, 6, 8, C), generator=gen)
    rois = torch.tensor([[[0, 0, 60, 60], [10, 10, 100, 90],
                          [0, 0, 127, 95]]] * B, dtype=torch.float32)
    g = _cotangent(live)
    rows, active = roi_pool_fc_backward.rows, \
        int(roi_pool_fc_backward.rows_active)
    dfeat = roi_pool_fc_backward(feat, rois, g, 7, 7, 1.0 / 16)
    assert roi_pool_fc_backward.rows - rows == B * P
    assert int(roi_pool_fc_backward.rows_active) - active == want
    assert torch.equal(dfeat, roi_pool_grad(feat, rois, g, 7, 7, 1.0 / 16))


def test_device_tally_sums_counts_of_any_integer_type():
    tally = DeviceTally()
    assert int(tally) == 0
    tally.add(torch.tensor(3, dtype=torch.int32))
    tally.add(torch.tensor(4))
    assert int(tally) == 7
