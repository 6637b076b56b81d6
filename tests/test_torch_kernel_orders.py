"""Numpy emulations of the schedules of the port's two serial-walk kernels,
held at small sizes against the plain versions and the JAX package.

* ``csrc/nms.cu``: the mask kernel's store (row words of the upper triangle
  in chunked tile rows, column words of the diagonal tiles, the disjoint
  pair rejected before the division) and the walk tile by tile (the settle
  as the Jacobi fixpoint on column words, the OR of the kept rows' words
  chunk by chunk), with the chunk width the kernel takes and with narrow
  ones that force several chunks per tile row.  Against
  ``ops/nms.py:nms_mask``, the JAX ``nms_mask`` and the Pallas kernel
  (interpret mode).
* ``csrc/roi_pool.cu`` backward: the active-row list, the argmax table
  (first column, then first row; f32 or bf16-rounded ranking) and the
  gather per cell (listed rows ascending, bin rows ascending, a j-ordered
  sum per bin row, chunks of rows carried in dfeat), against
  ``ops/roi_pool.py:roi_pool_grad`` / ``roi_pool_grad_bf16`` and the
  Pallas backward's VJP in interpret mode (on ``bf16(feat)`` for the bf16
  instance, as ``tests/test_torch_roi_pool_bf16.py`` runs it).

Everything must agree bit for bit: these catch order and index errors of
the kernels' designs before they reach the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_roi_pool_pallas import make_case
from wssdl_bus_tpu.ops.nms import nms_mask as jax_nms_mask
from wssdl_bus_tpu.ops.nms_pallas import nms_keep_pallas
from wssdl_bus_tpu.ops.roi_pool_pallas import roi_pool_image
from wssdl_bus_tpu_torch.ops.nms import nms_mask
from wssdl_bus_tpu_torch.ops.roi_pool import roi_pool_grad, roi_pool_grad_bf16

TILE = 64
F32 = np.float32
U64 = np.uint64
SCALE = 1.0 / 16.0


# --------------------------------------------------------------------- #
# greedy NMS
# --------------------------------------------------------------------- #
def _row_base(t, words):
    """Words of an image's store before tile row t's row words; the column
    words follow the last tile row."""
    return TILE * sum(words - 1 - s for s in range(t))


def _row_base_closed(t, words):
    """csrc/nms.cu row_base, the closed form."""
    return TILE * (t * (words - 1) - t * (t - 1) // 2)


def _suppresses(r, c, thresh):
    """csrc/nms.cu suppresses on broadcast f32 box arrays r (rows) and c
    (columns), each (x1, y1, x2, y2), in the kernel's order of operations:
    -> (hit, the pair took the division)."""
    one, zero, t = F32(1), F32(0), F32(thresh)
    r_area = (r[2] - r[0] + one) * (r[3] - r[1] + one)
    c_area = (c[2] - c[0] + one) * (c[3] - c[1] + one)
    iw = np.maximum(np.minimum(r[2], c[2]) - np.maximum(r[0], c[0]) + one,
                    zero)
    ih = np.maximum(np.minimum(r[3], c[3]) - np.maximum(r[1], c[1]) + one,
                    zero)
    inter = iw * ih
    u = (r_area + c_area) - inter
    with np.errstate(all="ignore"):
        hit = np.zeros(inter.shape, bool)
        slow = np.ones(inter.shape, bool)
        if F32(2.0 ** -100) <= t <= np.finfo(F32).max:
            tu = t * u
            d = inter - tu
            e = tu * F32(2.0 ** -20)
            scaled = tu >= F32(2.0 ** -100)
            hit = scaled & (d > e)
            slow = ~hit & ~((scaled & (d < -e)) | (inter == zero))
        return np.where(slow, inter / u >= t, hit), slow


def _pack(bits):
    """[..., 64] bool -> [...] uint64, bit j from column j."""
    return (bits.astype(U64) << np.arange(TILE, dtype=U64)).sum(-1,
                                                                dtype=U64)


def nms_list(boxes_t, valid):
    """nms_compact_kernel on one image: (the valid boxes [4, nv] in order,
    their positions)."""
    order = np.flatnonzero(valid)
    return boxes_t[:, order], order


def nms_store(lbox, thresh, cw):
    """One image's mask store as nms_mask_kernel writes it for its listed
    boxes: each tile row's row words in chunks of cw columns, [64][width]
    each, then every tile's 64 column words (bits j < i of the row's own
    tile).  Words it does not write (padding rows) hold all ones."""
    n = lbox.shape[1]
    words = -(-n // TILE)
    pad = words * TILE - n
    b = [np.pad(lbox[k], (0, pad)) for k in range(4)]
    m, _ = _suppresses([v[:, None] for v in b], [v[None] for v in b], thresh)
    store = np.full(TILE * words * (words + 1) // 2, ~U64(0), U64)
    r = np.arange(TILE)
    live = np.arange(words * TILE) < n
    for rt in range(words):
        rows = slice(rt * TILE, (rt + 1) * TILE)
        lv = live[rows]
        width = words - 1 - rt
        diag = m[rows, rows] & (r[None, :] < r[:, None])     # j < i
        store[(_row_base(words, words) + rt * TILE + r)[lv]] = \
            _pack(diag)[lv]
        for ct in range(rt + 1, words):
            q = ct - rt - 1
            k = q // cw
            wk = min(cw, width - k * cw)
            at = _row_base(rt, words) + TILE * k * cw + r * wk + q - k * cw
            store[at[lv]] = _pack(m[rows, ct * TILE:(ct + 1) * TILE])[lv]
    return store


def nms_walk(store, n, cw, stages=2):
    """nms_walk_kernel on one image of n listed boxes: tile by tile, warp 0
    settles the tile on its column words, then the block ORs the kept rows'
    words chunk by chunk out of a ring of `stages` stages, each chunk
    copied `stages` chunks ahead.  -> (kept [n] bool over the listed boxes,
    the deepest settle in Jacobi trips)."""
    words = -(-n // TILE)
    removed = np.zeros(words, U64)
    if n % TILE:
        removed[-1] = ~U64(0) << U64(n % TILE)
    bit = [U64(1) << U64(r) for r in range(TILE)]
    chunks = [(t, q0) for t in range(words - 1)
              for q0 in range(0, words - 1 - t, cw)]
    ring = [None] * stages

    def issue(ci):
        if ci < len(chunks):
            t, q0 = chunks[ci]
            wk = min(cw, words - 1 - t - q0)
            src = _row_base(t, words) + TILE * q0
            ring[ci % stages] = (ci, store[src:src + TILE * wk]
                                 .reshape(TILE, wk))

    for ci in range(stages):
        issue(ci)
    cols = store[_row_base(words, words):]
    keep = np.zeros(words * TILE, bool)
    deepest, ci = 0, 0
    for t in range(words):
        col = cols[t * TILE:(t + 1) * TILE]
        free = np.array([not (removed[t] & bit[r]) for r in range(TILE)])
        kept, trips = free, 0
        while True:
            nxt = free & ((col & _pack(kept)) == 0)
            trips += 1
            if np.array_equal(nxt, kept):
                break
            kept = nxt
        deepest = max(deepest, trips)
        keep[t * TILE:(t + 1) * TILE] = kept
        for q0 in range(0, words - 1 - t, cw):
            held, rows = ring[ci % stages]
            assert held == ci, f"chunk {ci} wanted, stage holds {held}"
            if kept.any():
                removed[t + 1 + q0:t + 1 + q0 + rows.shape[1]] |= \
                    np.bitwise_or.reduce(rows[kept], axis=0)
            issue(ci + stages)
            ci += 1
    return keep[:n], deepest


def _random_boxes(rng, n, scale=300.0):
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(5, scale / 2, (n, 2))
    return np.hstack([xy, xy + wh]).astype(F32).T.copy()     # [4, N]


def _nested_chain(n):
    """Nested boxes sharing a corner, side + 1 shrinking by 0.86 a box: a
    box and the next overlap at IoU 0.74, the one after at 0.55, so each
    suppresses only its successor."""
    side = 1e5 * 0.86 ** np.arange(n) - 1
    z = np.zeros(n)
    return np.stack([z, z, side, side]).astype(F32)


def _sliding_chain(n):
    """11 x 11 boxes shifted 1.5 px a box: IoU 0.76 with the next, 0.57
    with the one after."""
    x = np.arange(n) * 1.5
    z = np.zeros(n)
    return np.stack([x, z, x + 10, z + 10]).astype(F32)


def _check_nms(boxes_t, valid, thresh, jax_ops=True):
    """The kernel's schedule against the plain version and the JAX
    package's two."""
    n = boxes_t.shape[1]
    want = nms_mask(torch.from_numpy(boxes_t)[None],
                    torch.from_numpy(valid)[None], thresh)[0].numpy()
    lbox, order = nms_list(boxes_t, valid)
    words = -(-len(order) // TILE)
    deepest = 0
    # the kernel's chunk (a whole tile row), and narrow ones: several
    # chunks a tile row
    for cw in (max(words - 1, 1), 2, 5):
        kept, trips = nms_walk(nms_store(lbox, thresh, cw), len(order), cw)
        got = np.zeros(n, bool)
        got[order] = kept
        np.testing.assert_array_equal(got, want, err_msg=f"chunks of {cw}")
        deepest = max(deepest, trips)
    if jax_ops:
        pallas = np.asarray(nms_keep_pallas(jnp.asarray(boxes_t),
                                            jnp.asarray(valid), thresh,
                                            interpret=True))
        np.testing.assert_array_equal(want, pallas)
        np.testing.assert_array_equal(want, np.asarray(jax_nms_mask(
            jnp.asarray(boxes_t.T), jnp.asarray(valid), thresh)))
    return want, deepest


@pytest.mark.parametrize("n", [1, 63, 64, 65, 130, 300])
def test_nms_schedule_random(n):
    rng = np.random.RandomState(n)
    boxes_t = _random_boxes(rng, n)
    valid = rng.uniform(size=n) >= 0.1
    _check_nms(boxes_t, valid, 0.7)


def test_nms_schedule_clustered_boxes():
    """2300 clustered boxes, 95% valid: 35 tiles after listing, most of
    each cluster suppressed across tiles."""
    rng = np.random.RandomState(7)
    centers = rng.uniform(0, 900, (60, 2))
    xy = centers[rng.randint(0, 60, 2300)] + rng.uniform(-9, 9, (2300, 2))
    boxes_t = np.hstack([xy, xy + rng.uniform(30, 60, (2300, 2))]) \
        .astype(F32).T.copy()
    valid = rng.uniform(size=2300) >= 0.05
    keep, _ = _check_nms(boxes_t, valid, 0.7, jax_ops=False)
    assert 0 < keep.sum() < 0.5 * valid.sum()


@pytest.mark.parametrize("chain,n", [(_nested_chain, 64),
                                     (_sliding_chain, 200)])
def test_nms_schedule_deep_chains(chain, n):
    """Chains in which each box suppresses only the next: kept and removed
    alternate, inside one tile (nested shrinking boxes) and across four
    tiles; a tile's settle takes as many Jacobi trips as its chain is
    long."""
    keep, deepest = _check_nms(chain(n), np.ones(n, bool), 0.7)
    assert keep.tolist() == [k % 2 == 0 for k in range(n)]
    assert deepest >= TILE


def test_nms_schedule_identical_boxes_keep_one():
    boxes_t = np.tile(np.array([[10], [20], [90], [80]], F32), (1, 150))
    keep, _ = _check_nms(boxes_t, np.ones(150, bool), 0.7)
    assert keep.tolist() == [True] + [False] * 149


@pytest.mark.parametrize("thresh", [0.0, 1.0])
def test_nms_schedule_threshold_edges(thresh):
    """0.0: every pair suppresses, disjoint ones included (the division
    path: IoU 0 >= 0); 1.0: only identical boxes, by the inclusive
    compare."""
    rng = np.random.RandomState(5)
    boxes_t = _random_boxes(rng, 140)
    boxes_t[:, 70:80] = boxes_t[:, 3:4]        # copies of box 3
    valid = np.ones(140, bool)
    keep, _ = _check_nms(boxes_t, valid, thresh)
    if thresh == 0.0:
        assert keep.tolist() == [True] + [False] * 139
    else:
        assert keep[3] and not keep[70:80].any() and keep.sum() == 130


@pytest.mark.parametrize("thresh", [0.7, 0.5, 0.3, 1.0, 2.0 ** -90, 1e-30])
def test_nms_pair_test_is_exact_near_the_threshold(thresh):
    """The division-free decisions equal RN(inter / union) >= thresh on
    pairs whose IoU sits within a few ulps of the threshold, on exact ties
    (14 / 20 at 0.7, identical boxes at 1.0), at pixel and sub-pixel
    scales; on random pairs nearly all are decided without the division."""
    rng = np.random.RandomState(11)
    a = rng.uniform(4, 400, 4000).astype(F32)
    # the shift dx with IoU (a - dx) / (a + dx) = thresh, nudged by up to
    # 40 ulps or 2^12 times that
    t = min(thresh, 0.999)
    dx = (a * (1 - t) / (1 + t)).astype(F32)
    ulps = rng.randint(-40, 41, a.shape) * 2.0 ** (12 * rng.randint(0, 2,
                                                                    a.shape))
    dx = np.maximum(dx + (ulps * np.spacing(dx)).astype(F32), 0).astype(F32)
    dx[::50] = 0                               # identical boxes: IoU 1
    scale = F32(2.0) ** rng.randint(-8, 9, a.shape).astype(F32)
    z = np.zeros_like(a)
    r = [z, z, a * scale - 1, a * scale - 1]
    c = [dx * scale, z, (a + dx) * scale - 1, a * scale - 1]
    # widths 17 and 17 overlapping in 14: IoU 14 / 20, a tie at 0.7
    r = [np.append(v, x).astype(F32) for v, x in zip(r, [0, 0, 16, 63])]
    c = [np.append(v, x).astype(F32) for v, x in zip(c, [3, 0, 19, 63])]
    got, _ = _suppresses(r, c, thresh)
    want, full = _suppresses(r, c, -np.inf)
    assert full.all()
    with np.errstate(all="ignore"):
        one = F32(1)
        inter = (np.maximum(np.minimum(r[2], c[2]) - np.maximum(r[0], c[0])
                            + one, 0) *
                 np.maximum(np.minimum(r[3], c[3]) - np.maximum(r[1], c[1])
                            + one, 0)).astype(F32)
        union = (((r[2] - r[0] + one) * (r[3] - r[1] + one) +
                  (c[2] - c[0] + one) * (c[3] - c[1] + one)) - inter)
        want = inter / union >= F32(thresh)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    if thresh >= 2.0 ** -100:
        boxes = _random_boxes(rng, 1000)
        _, slow = _suppresses([v[:500, None] for v in boxes],
                              [v[None, 500:] for v in boxes], thresh)
        assert slow.mean() < 1e-3


def test_nms_store_layout():
    """The closed form of the row words' offsets, and the store's size:
    64 * w(w+1)/2 words for w tiles."""
    for words in range(1, 40):
        for t in range(words + 1):
            assert _row_base_closed(t, words) == _row_base(t, words)
        assert len(nms_store(np.zeros((4, words * TILE), F32), 0.7, 2)) == \
            TILE * words * (words + 1) // 2


def test_nms_schedule_all_invalid():
    boxes_t = _random_boxes(np.random.RandomState(2), 130)
    keep, _ = _check_nms(boxes_t, np.zeros(130, bool), 0.7, jax_ops=False)
    assert not keep.any()


# --------------------------------------------------------------------- #
# ROI-pool backward
# --------------------------------------------------------------------- #
def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16) \
        .float().numpy()


def _edges(k, start, size, pooled, limit, flavor):
    lo = (k * size) // pooled + start
    hi = ((k + 1) * size + (pooled - 1 if flavor == "gpu" else 0)) // pooled \
        + start
    return min(max(lo, 0), limit), min(max(hi, 0), limit)


def _roi_edges(roi, ph, pw, h, w, flavor):
    q = np.floor(roi.astype(F32) * F32(SCALE) + F32(0.5)).astype(np.int64)
    rsw, rsh, rew, reh = (int(v) for v in q)
    rw, rh = max(rew - rsw + 1, 1), max(reh - rsh + 1, 1)
    return ([_edges(i, rsh, rh, ph, h, flavor) for i in range(ph)],
            [_edges(j, rsw, rw, pw, w, flavor) for j in range(pw)])


def roi_bwd_schedule(feat, rois, g, ph=7, pw=7, flavor="gpu", bf16=False,
                     chunk=3):
    """The backward kernels on [B, H, W, C] / [B, P, 4] / [B, P, Ph*Pw*C]:
    active rows, compaction, argmax table, gather; rows are walked in chunks
    of ``chunk`` (the gather block's, small here to cross chunk edges)."""
    b_n, h, w, c = feat.shape
    p = rois.shape[1]
    g = g.reshape(b_n, p, ph, pw, c).astype(F32)
    rank = _bf16(feat) if bf16 else feat
    # 1-2: the flagged rows in ascending order, each image's first position
    flat = g.reshape(b_n * p, -1)
    rows = [q for q in range(b_n * p) if (flat[q] != 0).any()]
    starts = [sum(1 for q in rows if q < bi * p) for bi in range(b_n + 1)]
    # 3: the argmax table, -1 for an empty bin
    table = np.full((len(rows), ph, pw, c), -1, np.int64)
    edges = []
    for k, q in enumerate(rows):
        bi, r = divmod(q, p)
        he, we = _roi_edges(rois[bi, r], ph, pw, h, w, flavor)
        edges.append((he, we))
        for i, (hlo, hhi) in enumerate(he):
            for j, (wlo, whi) in enumerate(we):
                if hhi <= hlo or whi <= wlo:
                    continue
                best = None
                for x in range(wlo, whi):
                    col = rank[bi, hlo:hhi, x]                  # [rows, C]
                    ch = hlo + np.argmax(col, axis=0)            # first max
                    cm = col.max(axis=0)
                    if best is None:
                        best, bh, bw = cm, ch, np.full(c, x)
                    else:
                        up = cm > best
                        best = np.where(up, cm, best)
                        bh = np.where(up, ch, bh)
                        bw = np.where(up, x, bw)
                table[k, i, j] = bh * w + bw
    # 4: the gather, per cell, chunks of listed rows carried in dfeat
    dfeat = np.zeros((b_n, h, w, c), F32)
    for bi in range(b_n):
        for base in range(starts[bi], starts[bi + 1], chunk):
            for y in range(h):
                for x in range(w):
                    acc = dfeat[bi, y, x].copy()
                    for k in range(base, min(base + chunk, starts[bi + 1])):
                        he, we = edges[k]
                        for i, (hlo, hhi) in enumerate(he):
                            if hlo > y:
                                break
                            if y >= hhi:
                                continue
                            s = np.zeros(c, F32)
                            for j, (wlo, whi) in enumerate(we):
                                if wlo > x:
                                    break
                                if x >= whi:
                                    continue
                                hit = table[k, i, j] == y * w + x
                                s = np.where(hit, s + g.reshape(
                                    b_n * p, ph, pw, c)[rows[k], i, j], s)
                            acc = acc + s
                    dfeat[bi, y, x] = acc
    return dfeat


def _pallas_dfeat(feat, rois, g, flavor="gpu"):
    out = []
    for f, r, gi in zip(feat, rois, g):
        _, vjp = jax.vjp(lambda v: roi_pool_image(
            v, jnp.asarray(r), 7, 7, SCALE, True, flavor), jnp.asarray(f))
        out.append(np.asarray(vjp(jnp.asarray(gi.reshape(len(r), 7, 7, -1)))
                              [0]))
    return np.stack(out)


def _check_bwd(feat, rois, g, flavor="gpu", bf16=False, pallas=True):
    got = roi_bwd_schedule(feat, rois, g, flavor=flavor, bf16=bf16)
    plain = roi_pool_grad_bf16 if bf16 else roi_pool_grad
    tg = torch.from_numpy(g)
    want = plain(torch.from_numpy(feat), torch.from_numpy(rois),
                 tg.to(torch.bfloat16) if bf16 else tg, 7, 7, SCALE,
                 flavor).numpy()
    np.testing.assert_array_equal(got, want)
    if pallas:
        np.testing.assert_array_equal(
            want, _pallas_dfeat(_bf16(feat) if bf16 else feat, rois, g,
                                flavor))
    assert (got != 0).any()
    return got


def _batch(rng, h=12, w=15, c=4, p=9):
    cases = [make_case(rng, h=h, w=w, c=c, p=p) for _ in range(2)]
    return (np.stack([f for f, _ in cases]),
            np.stack([r for _, r in cases]))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("flavor", ["gpu", "cpu"])
def test_roi_bwd_schedule_random(rng, flavor, bf16):
    """Two images, 9 ROIs each (one forced 1x1), post-ReLU map (zero
    ties), one all-zero cotangent row skipped."""
    feat, rois = _batch(rng)
    feat = np.maximum(feat, 0)
    g = rng.randn(2, 9, 49 * 4).astype(F32)
    g[1, 4] = 0.0
    if bf16:
        g = _bf16(g)
    _check_bwd(feat, rois, g, flavor, bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_roi_bwd_schedule_identical_rois(rng, bf16):
    """Twelve copies of one ROI: every cell's chain is twelve adds long, in
    ROI order."""
    feat, rois = _batch(rng, p=1)
    rois = np.repeat(rois, 12, axis=1)
    g = rng.randn(2, 12, 49 * 4).astype(F32)
    if bf16:
        g = _bf16(g)
    _check_bwd(feat, rois, g, bf16=bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_roi_bwd_schedule_whole_map_and_outside_rois(rng, bf16):
    """Whole-map ROIs, and ROIs partly outside the map, whose bins past the
    edge are empty (clipped to nothing) and add nothing."""
    feat, _ = _batch(rng)
    h, w = feat.shape[1:3]
    rois = np.array([[0, 0, w * 16 - 1, h * 16 - 1],
                     [-200, -120, 60, 40],
                     [w * 16 - 40, h * 16 - 30, w * 16 + 300, h * 16 + 200],
                     [0, 0, w * 16 - 1, h * 16 - 1]], F32)
    rois = np.stack([rois, rois[::-1].copy()])
    g = rng.randn(2, 4, 49 * 4).astype(F32)
    if bf16:
        g = _bf16(g)
    _check_bwd(feat, rois, g, bf16=bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_roi_bwd_schedule_ties(rng, bf16):
    """A map of few values: ties everywhere, first column then first row;
    with bf16, values that only tie after rounding."""
    feat, rois = _batch(rng)
    feat = (1.0 + rng.randint(0, 3, feat.shape) / 4096.0).astype(F32)
    g = np.ones((2, 9, 49 * 4), F32)
    got = _check_bwd(feat, rois, g, bf16=bf16)
    assert set(np.unique(got).tolist()) <= set(float(k) for k in range(500))
