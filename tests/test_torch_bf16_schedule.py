"""The schedules of the bf16-mode K1, K5 and K6 kernels, checked on the
CPU (the kernels themselves run only on the card:
``tests/test_torch_cuda.py``):

- :func:`wgrad_bf16_splits` (K6 bf16's split of the reduction over
  positions) covers every position exactly once, each of K6's GEMM row
  tiles maps every dW row ``tap·C + c`` exactly once (the kernel's
  epilogue arithmetic: GEMM row ``r = tap·CP + c``), the schedule is a
  function of the shapes alone, and its partials stay within
  :data:`WGRAD_BF16_PARTIAL_BYTES` at every flagship shape at -b 256 and
  at -b 4,160 (the remat ceiling);
- :func:`fwd_halo_span` (the input rows a K1 bf16 tile signs into shared
  memory) holds every input row any of the tile's positions reads at any
  tap, and :func:`fwd_halo_rows` (what the wrapper sizes shared memory
  by) is the most any tile of the batch reads, and fits the card at the
  flagship's shapes;
- K5 bf16's walk (:func:`dgrad_bf16_tile` over :func:`dgrad_bf16_tiles`)
  covers every dx row of every stride-parity class and every channel
  exactly once, every g row a tap of a tile's rows reads lies in the halo
  :func:`dgrad_halo_span` gives it, :func:`dgrad_bf16_schedule`'s halo is
  the most any tile copies, and its shared memory and grid fit the card at
  the flagship's shapes at -b 256 and -b 4,160.
"""

import math

import numpy as np
import pytest

from bdbnn_tpu_torch.nn.kernels.binary_conv import (
    DGRAD_BF16_TILE,
    FWD_BF16_TILE,
    SMEM_PER_BLOCK,
    WGRAD_BF16_M_STAGE,
    WGRAD_BF16_PARTIAL_BYTES,
    WGRAD_BF16_ROW_TILE,
    WGRAD_BF16_SMS,
    _round_up,
    dgrad_bf16_schedule,
    dgrad_bf16_smem,
    dgrad_bf16_tile,
    dgrad_bf16_tiles,
    dgrad_class_grid,
    dgrad_class_taps,
    dgrad_halo_span,
    dgrad_parity_classes,
    fwd_halo_rows,
    fwd_halo_span,
    out_size,
    wgrad_bf16_splits,
)
from chip_smoke import FLAGSHIP_CONVS

# the remat ceiling of the bf16 flagship (PERF.md §2)
BATCHES = (256, 4160)
# (N, H, C, O, k, stride): off every tile edge, stride 2, 1x1, tiny
ODD = [(2, 9, 5, 4, 3, 1), (2, 8, 8, 8, 3, 2), (1, 7, 6, 3, 3, 2), (2, 5, 7, 3, 1, 1),
       (1, 6, 40, 70, 3, 1), (2, 14, 256, 96, 3, 2), (3, 13, 20, 130, 3, 1), (1, 1, 3, 1, 1, 1)]


def _flagship(batch):
    return [(batch, hw, c, o, k, s) for _, hw, c, o, k, s, _ in FLAGSHIP_CONVS]


def _wgrad_args(n, h, c, o, k, s):
    ho = out_size(h, k, s, k // 2)
    cp = _round_up(c, 8)
    return n * ho * ho, k * k * cp, k * k * c, o


@pytest.mark.parametrize("case", _flagship(256) + _flagship(4160) + ODD)
def test_wgrad_bf16_splits_cover_every_position_once(case):
    m, kd, rows, o = _wgrad_args(*case)
    splits, per = wgrad_bf16_splits(m, kd, rows, o)
    # split z reduces positions [z·per, min(m, (z+1)·per)): each non-empty,
    # together all of them, in whole stages
    assert per % WGRAD_BF16_M_STAGE == 0 and per > 0
    assert splits * per >= m and (splits - 1) * per < m
    assert 1 <= splits <= 65535
    starts = [z * per for z in range(splits)]
    covered = sum(min(m, a + per) - a for a in starts)
    assert covered == m


@pytest.mark.parametrize("case", _flagship(256) + ODD)
def test_wgrad_bf16_tiles_map_every_dw_row_once(case):
    n, h, c, o, k, s = case
    cp = _round_up(c, 8)
    kk = k * k
    seen = []
    for tile in range(math.ceil(kk * cp / WGRAD_BF16_ROW_TILE)):
        for i in range(WGRAD_BF16_ROW_TILE):
            r = tile * WGRAD_BF16_ROW_TILE + i
            tap, ch = divmod(r, cp)
            if tap < kk and ch < c:
                seen.append(tap * c + ch)
    assert sorted(seen) == list(range(kk * c))


@pytest.mark.parametrize("batch", BATCHES)
def test_wgrad_bf16_splits_are_a_function_of_the_shapes_and_bounded(batch):
    total = 0
    for case in _flagship(batch):
        m, kd, rows, o = _wgrad_args(*case)
        a = wgrad_bf16_splits(m, kd, rows, o)
        assert a == wgrad_bf16_splits(m, kd, rows, o) == wgrad_bf16_splits(*(int(v) for v in
                                                                             (m, kd, rows, o)))
        splits = a[0]
        part = 0 if splits == 1 else splits * rows * o * 8
        assert part <= WGRAD_BF16_PARTIAL_BYTES
        # at least a wave of the card's SMs where the shape has the work
        tiles = math.ceil(kd / WGRAD_BF16_ROW_TILE) * math.ceil(o / 64)
        assert tiles * splits >= min(WGRAD_BF16_SMS, tiles) * 0.9
        total += part
    # the partials of all ten shapes together: a few tens of MB, where the
    # f32 design's reach about the bound's bytes
    assert total <= 10 * WGRAD_BF16_PARTIAL_BYTES


def _rows_read(n, h, k, s, ho, wo, m0, count):
    """Every global input row n·H + h a position of the tile reads."""
    pad = k // 2
    rows = set()
    for m in range(m0, m0 + count):
        b, rem = divmod(m, ho * wo)
        oh = rem // wo
        for i in range(k):
            hh = oh * s - pad + i
            if 0 <= hh < h:
                rows.add(b * h + hh)
    return rows


@pytest.mark.parametrize("case", ODD + [(3, 56, 64, 64, 3, 1), (2, 56, 64, 128, 3, 2),
                                        (3, 14, 256, 512, 3, 2), (4, 7, 512, 512, 3, 1),
                                        (3, 28, 64, 128, 1, 1)])
def test_fwd_halo_span_holds_every_row_a_tile_reads(case):
    n, h, c, o, k, s = case
    pad = k // 2
    ho = wo = out_size(h, k, s, pad)
    m = n * ho * wo
    most = 0
    for m0 in range(0, m, FWD_BF16_TILE):
        count = min(FWD_BF16_TILE, m - m0)
        lo, hi = fwd_halo_span(m0, count, h, k, s, pad, ho, wo)
        read = _rows_read(n, h, k, s, ho, wo, m0, count)
        assert read and lo <= min(read) and max(read) <= hi
        most = max(most, hi - lo + 1)
    assert fwd_halo_rows(n, h, h, k, k, s, pad) == most


@pytest.mark.parametrize("batch", BATCHES)
def test_fwd_halo_fits_the_card_at_flagship_shapes(batch):
    # the halo buffer (80-byte rows of a 64-channel chunk and one zero row,
    # or the 128 x 72 bf16 staged output) and one chunk's weight sign (4 KB
    # a tap) within the 227 KB a block may take
    for n, h, c, o, k, s in _flagship(batch):
        rows = fwd_halo_rows(n, h, h, k, k, s, k // 2)
        assert rows <= 2 * (FWD_BF16_TILE // out_size(h, k, s, k // 2) + 2) * s + 2 * k
        halo = max((rows * h + 1) * 80, 128 * 72 * 2)
        assert 2048 + k * k * 4096 + halo <= 232448


def _dgrad_walk(n, h, w, c, k, s):
    """Each tile of K5 bf16's walk whose rows lie on its class's grid: (class,
    channel tile, its rows' (n, hh, ww) as arrays, the class grid, its
    taps)."""
    ctiles, mtiles, tiles = dgrad_bf16_tiles(n, h, w, c, s)
    classes = dgrad_class_taps(k, k, s, k // 2)
    for tile in range(tiles):
        z, mt, ct = dgrad_bf16_tile(tile, ctiles, mtiles)
        hc, wc = dgrad_class_grid(h, w, s, z)
        mc, m0 = n * hc * wc, mt * DGRAD_BF16_TILE
        if m0 >= mc:
            continue
        m = np.arange(m0, min(m0 + DGRAD_BF16_TILE, mc))
        nn, rem = np.divmod(m, hc * wc)
        hh, ww = np.divmod(rem, wc)
        yield z, ct, m0, (nn, hh, ww), (hc, wc), classes[z]


# (N, H, C, O, k, stride) of the flagship's ten shapes at a batch off the
# 128-row tile
DGRAD_SMALL = ODD + [(3, hw, c, o, k, s) for _, hw, c, o, k, s, _ in FLAGSHIP_CONVS] + [
    (2, 9, 9, 5, 1, 2), (1, 5, 70, 3, 3, 2)]


@pytest.mark.parametrize("case", DGRAD_SMALL)
def test_dgrad_bf16_walk_covers_every_dx_row_once(case):
    n, h, c, o, k, s = case
    ctiles = dgrad_bf16_tiles(n, h, h, c, s)[0]
    seen = np.zeros((n, h, h, ctiles), dtype=np.int64)
    for z, ct, _, (nn, hh, ww), _, _ in _dgrad_walk(n, h, h, c, k, s):
        a, b = divmod(z, s)
        np.add.at(seen, (nn, a + s * hh, b + s * ww, ct), 1)
    # every row of every class once a channel tile; the channel tiles
    # cover every channel once
    assert (seen == 1).all()
    assert sorted(ch for ct in range(ctiles) for ch in range(ct * 64, min(ct * 64 + 64, c))) == \
        list(range(c))
    # every tap lands in exactly one class
    assert sorted(t[0] for taps in dgrad_class_taps(k, k, s, k // 2) for t in taps) == \
        list(range(k * k))
    assert [len(t) for t in dgrad_class_taps(k, k, s, k // 2)] == [
        len(r) * len(q) for r in dgrad_parity_classes(k, s, k // 2)
        for q in dgrad_parity_classes(k, s, k // 2)]


@pytest.mark.parametrize("case", DGRAD_SMALL)
def test_dgrad_bf16_halo_holds_every_g_row_a_tap_reads(case):
    n, h, c, o, k, s = case
    pad = k // 2
    ho = out_size(h, k, s, pad)
    halo_px = dgrad_bf16_schedule(n, h, h, k, k, s, pad)[0]
    most = 0
    for _, _, m0, (nn, hh, ww), (hc, wc), taps in _dgrad_walk(n, h, h, c, k, s):
        if not taps:
            continue
        dis = [t[1] for t in taps]
        lo, hi = dgrad_halo_span(m0, len(nn), hc, wc, ho, min(dis), max(dis))
        most = max(most, (hi - lo + 1) * ho)
        for _, di, dj in taps:
            ok = (hh + di >= 0) & (hh + di < ho) & (ww + dj >= 0) & (ww + dj < ho)
            rows = (nn * ho + hh + di)[ok]
            assert ((rows >= lo) & (rows <= hi)).all()
    assert halo_px == most


@pytest.mark.parametrize("batch", BATCHES)
def test_dgrad_bf16_fits_the_card_at_flagship_shapes(batch):
    for n, h, c, o, k, s in _flagship(batch):
        pad = k // 2
        halo_px, maxtaps, nstage, smem = dgrad_bf16_schedule(n, h, h, k, k, s, pad)
        assert nstage >= 2 and smem <= SMEM_PER_BLOCK
        assert smem == dgrad_bf16_smem(halo_px, maxtaps, nstage)
        # the halo: the class rows 128 dx rows span (at most ceil(128 / Wc)
        # + 1, Hc = Ho here) and the taps' reach beyond them, in g rows of
        # Wo pixels
        ho, wc = out_size(h, k, s, pad), -(-h // s)
        assert halo_px <= (-(-DGRAD_BF16_TILE // wc) + k) * ho
        assert maxtaps == max(len(t) for t in dgrad_class_taps(k, k, s, pad))
        # the walk's tile index, and its per-class tile count, stay in int32
        ctiles, mtiles, tiles = dgrad_bf16_tiles(n, h, h, c, s)
        assert tiles < 2**31 and ctiles * mtiles < 2**31
