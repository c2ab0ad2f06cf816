"""PyTorch port: the launch plans of K1 (SpecAugment views), K2 (episode
head) and K3 (mel + log), computed in Python by their wrappers and checked
here on the CPU.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py``);
what they are launched with (tiles, vector widths, stages, shared-memory
bytes, bulk-copy sizes and offsets, the ragged tail) is plain arithmetic that a wrong edit
would break without a card to show it.
"""

import itertools

import numpy as np
import pytest
import torch

from audio_few_shot_learning_tpu_torch.ops import convblock, mel, protohead, specaugment

HOPPER_SMS = 132
SMEM_227K = 227 * 1024
THREADS_PER_SM = 2048


def _old_head_accepts(n_way, s, d):
    """The limit of the episode head before it staged the support: prototypes,
    norms, counts and labels in 48 KB."""
    return 4 * (n_way * d + 2 * n_way + s) <= 48 * 1024


# ----------------------------------------------------------------------------
# K2
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("e,s,q,d,n_way,blocks", [
    (16, 25, 25, 256, 5, 64),  # spec eval batch: 4 query tiles per episode
    (16, 25, 25, 64, 5, 64),  # wav eval batch
    (1, 25, 25, 256, 5, 4),  # predict episode
    (16, 40, 25, 256, 40, 64),  # many classes
    (3, 10, 6, 64, 4, 3),  # fewer queries than a tile
])
def test_head_plan_stages_whole_support_at_path_shapes(e, s, q, d, n_way, blocks):
    plan = protohead.head_plan(e, s, q, d, n_way)
    assert plan.s_chunk == s  # one memory round
    assert plan.q_tile == min(protohead.Q_TILE, q)
    assert plan.blocks == blocks == e * -(-q // plan.q_tile)
    assert plan.smem_bytes == protohead.head_smem_bytes(n_way, d, plan.q_tile, s) <= SMEM_227K


def test_head_plan_flagship_fits_default_shared_memory():
    # below 48 KB the launch needs no opt-in attribute
    assert protohead.head_plan(16, 25, 25, 256, 5).smem_bytes <= 48 * 1024


def test_head_plan_accepts_everything_the_48k_kernel_accepted():
    grid = itertools.product([1, 2, 5, 7, 20, 40, 47, 100, 190], [0, 1, 25, 40, 500, 4000],
                             [1, 3, 63, 64, 256, 1000, 4096])
    checked = 0
    for n_way, s, d in grid:
        if not _old_head_accepts(n_way, s, d):
            continue
        plan = protohead.head_plan(16, s, 25, d, n_way)
        assert plan.smem_bytes <= SMEM_227K
        assert (plan.s_chunk >= 1) == (s >= 1) and plan.s_chunk <= s
        assert 1 <= plan.q_tile <= protohead.Q_TILE
        checked += 1
    assert checked > 60


def test_head_plan_chunks_a_support_too_large_for_shared_memory():
    plan = protohead.head_plan(2, 5000, 25, 256, 5)
    assert 1 <= plan.s_chunk < 5000
    assert plan.smem_bytes <= SMEM_227K
    assert protohead.head_smem_bytes(5, 256, plan.q_tile, plan.s_chunk + 1) > SMEM_227K


def test_head_plan_refuses_prototypes_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        protohead.head_plan(1, 4, 4, 256, 240)
    protohead.head_plan(1, 4, 4, 256, 200)  # still fits beside one query and one support row


@pytest.mark.parametrize("n_way,d,q_tile,s_chunk", [(5, 256, 8, 25), (7, 63, 3, 9), (1, 1, 1, 1)])
def test_head_shared_memory_regions_are_16_byte_aligned(n_way, d, q_tile, s_chunk):
    r4 = lambda x: (x + 3) // 4 * 4  # noqa: E731
    offsets = np.cumsum([0, r4(n_way * d), r4(q_tile * d), r4(s_chunk * d), r4(n_way)]) * 4
    assert (offsets % 16 == 0).all()
    assert protohead.head_smem_bytes(n_way, d, q_tile, s_chunk) == offsets[-1] + 4 * s_chunk


def test_head_feature_rows_pass_through_without_a_copy():
    e, s, q, d = 4, 25, 25, 64
    fused = torch.randn(e, s + q, d)  # the attention output the eval path slices
    for part in (fused[:, :s], fused[:, s:]):
        rows = protohead._rows(part)
        assert rows.data_ptr() == part.data_ptr() and rows.stride() == part.stride()
    spread = torch.randn(e, d, s).transpose(1, 2)  # rows not contiguous
    rows = protohead._rows(spread)
    assert rows.is_contiguous() and torch.equal(rows, spread)
    assert protohead._rows(fused.double()[:, :s]).dtype == torch.float32


# ----------------------------------------------------------------------------
# K3
# ----------------------------------------------------------------------------


def _table(flavor):
    return mel.band_table(mel.MelSpec(flavor).fb)


@pytest.mark.parametrize("flavor", ["online", "offline"])
@pytest.mark.parametrize("m,tiles,tail", [
    (16 * 50 * 157, 3925, 0),  # wav eval batch
    (50 * 157, 246, 10),  # predict episode
    (157, 5, 29),
    (33, 2, 1), (35, 2, 3), (63, 2, 31), (1, 1, 1),
])
def test_mel_plan_at_path_shapes(flavor, m, tiles, tail):
    table = _table(flavor)
    plan = mel.mel_plan(m, 513, 128, table.weights.numel(), HOPPER_SMS)
    assert plan.stages == mel.MAX_STAGES and plan.table_in_smem
    assert plan.smem_bytes <= SMEM_227K
    assert plan.grid == min(tiles, HOPPER_SMS)
    assert plan.bulk_tiles == m // mel.TILE_ROWS == tiles - (tail > 0)
    assert m - plan.bulk_tiles * mel.TILE_ROWS == tail  # rows left to the plain loads


def test_mel_bulk_copies_are_whole_16_byte_units_at_aligned_offsets():
    plan = mel.mel_plan(16 * 50 * 157, 513, 128, _table("online").weights.numel(), HOPPER_SMS)
    assert plan.tile_bytes == 32 * 513 * 4 == 65664
    assert plan.tile_bytes % 16 == 0
    offsets = np.arange(plan.bulk_tiles, dtype=np.int64) * plan.tile_bytes
    assert (offsets % 16 == 0).all()
    # the ring's buffers start 16-byte aligned after the mbarrier header
    starts = mel.HEADER_BYTES + np.arange(plan.stages) * plan.tile_bytes
    assert (starts % 16 == 0).all()


def test_mel_plan_unaligned_base_takes_no_bulk_copy():
    plan = mel.mel_plan(7850, 513, 128, 1013, HOPPER_SMS, aligned=False)
    assert plan.bulk_tiles == 0


def test_mel_plan_dense_band_table_stays_in_device_memory():
    dense = 513 * 128  # a filterbank whose bands span every bin
    plan = mel.mel_plan(7850, 513, 128, dense, HOPPER_SMS)
    assert not plan.table_in_smem and plan.stages == mel.MAX_STAGES
    assert plan.smem_bytes == mel.mel_smem_bytes(513, 128, dense, plan.stages, False) <= SMEM_227K


def test_mel_plan_band_table_shrinks_the_ring_before_leaving_shared_memory():
    # a table just too large for three stages but fine beside two
    room = SMEM_227K - mel.mel_smem_bytes(513, 128, 0, 3, False) - 4 * 3 * 128
    plan = mel.mel_plan(7850, 513, 128, room // 4 + 16, HOPPER_SMS)
    assert plan.table_in_smem and plan.stages == 2


def test_mel_plan_refuses_a_tile_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        mel.mel_plan(100, 2000, 128, 1013, HOPPER_SMS)
    mel.mel_plan(100, 1025, 128, 2000, HOPPER_SMS)  # n_fft = 2048 still fits


# ----------------------------------------------------------------------------
# K1
# ----------------------------------------------------------------------------

# the card tests' shapes and the path's: eval batch, multi-segment queries
# at s_max 6 and 36, a train step's single episode at 128x157 and NSynth's
# 128x126 (and its eval batch), the odd and unaligned ones
K1_SHAPES = [(16, 25, 128, 157), (16, 150, 128, 157), (3, 900, 128, 157), (1, 3, 37, 1000),
             (2, 1, 1, 31), (1, 25, 128, 157), (1, 25, 128, 126), (16, 25, 128, 126), (2, 7, 37, 157)]
K1_DTYPES = {"float32": 4, "bfloat16": 2}


def _k1_tiles(plan, e, b, f):
    """(item, first row, rows) of every block, as the kernel derives them
    from its block index."""
    blk = np.arange(plan.blocks, dtype=np.int64)
    item = blk // plan.tiles_per_item
    f0 = (blk - item * plan.tiles_per_item) * plan.rows
    return item, f0, np.minimum(plan.rows, f - f0)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", K1_DTYPES)
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_views_plan_tiles_cover_every_row_once(shape, dtype, aligned):
    e, b, f, t = shape
    plan = specaugment.views_plan(e, b, f, t, K1_DTYPES[dtype], HOPPER_SMS, aligned)
    assert plan.blocks == e * b * plan.tiles_per_item
    item, f0, rows = _k1_tiles(plan, e, b, f)
    assert (rows >= 1).all()
    hits = np.zeros((e * b, f), np.int64)
    for r in range(plan.rows):
        live = r < rows
        np.add.at(hits, (item[live], f0[live] + r), 1)
    assert (hits == 1).all()
    # every element of a tile is one access of one thread's loop
    assert (rows * t % plan.vec == 0).all()
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= specaugment.VIEWS_MAX_THREADS


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", K1_DTYPES)
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_views_plan_vector_path_only_on_16_byte_spans(shape, dtype, aligned):
    e, b, f, t = shape
    eb = K1_DTYPES[dtype]
    plan = specaugment.views_plan(e, b, f, t, eb, HOPPER_SMS, aligned)
    assert plan.vec in (1, 16 // eb)
    item, f0, rows = _k1_tiles(plan, e, b, f)
    plane = f * t
    starts = [item * plane + f0 * t] + [(4 * item + v) * plane + f0 * t for v in range(4)]  # input, 4 views
    spans_aligned = aligned and all(((s * eb) % 16 == 0).all() for s in starts) and ((rows * t * eb) % 16 == 0).all()
    if plan.vec > 1:
        assert spans_aligned
    # and it is taken wherever the plane is whole 16-byte units (T=157 and 126 at F=128)
    assert (plan.vec > 1) == (aligned and (plane * eb) % 16 == 0)


@pytest.mark.parametrize("dtype", K1_DTYPES)
def test_views_plan_fills_every_sm_at_a_train_step(dtype):
    plan = specaugment.views_plan(1, 25, 128, 157, K1_DTYPES[dtype], HOPPER_SMS)
    assert plan.vec == 16 // K1_DTYPES[dtype]  # the vector path
    assert plan.blocks >= 3 * HOPPER_SMS  # several tiles on every one of 132 SMs
    # one access per thread, and the whole grid resident at once
    assert plan.threads * plan.vec >= plan.rows * 157
    assert plan.blocks * plan.threads <= HOPPER_SMS * THREADS_PER_SM
    assert (plan.blocks, plan.rows) == {"float32": (800, 4), "bfloat16": (400, 8)}[dtype]


@pytest.mark.parametrize("dtype", K1_DTYPES)
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_views_plan_shared_memory_within_227k(shape, dtype):
    e, b, f, t = shape
    eb = K1_DTYPES[dtype]
    plan = specaugment.views_plan(e, b, f, t, eb, HOPPER_SMS)
    assert plan.smem_bytes == specaugment.views_smem_bytes(plan.rows, t, eb) <= SMEM_227K
    # the tile starts 16 bytes aligned after the ys row; each buffer holds one
    # padding word per 128 bytes
    ys_bytes = plan.smem_bytes - specaugment._padded(plan.rows * t * eb)
    assert ys_bytes % 16 == 0 and ys_bytes >= 4 * t + 4 * (4 * t // 128)


def test_views_plan_accepts_every_shape_the_48k_kernel_accepted():
    """The kernel before the plan took any T whose row fit 48 KB of static
    shared memory."""
    checked = 0
    for eb in (4, 2):
        for t in (1, 2, 31, 157, 1000, 4097, 48 * 1024 // eb):
            for f in (1, 3, 37, 128):
                plan = specaugment.views_plan(2, 3, f, t, eb, HOPPER_SMS)
                assert plan.smem_bytes <= SMEM_227K and 1 <= plan.rows <= f
                checked += 1
    assert checked == 56


def test_views_plan_refuses_a_row_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        specaugment.views_plan(1, 1, 4, 40000, 4, HOPPER_SMS)


def test_views_masks_pass_as_views_without_a_copy():
    mask = torch.rand(3, 157) < 0.3
    view = specaugment._mask_bytes(mask, "tmask")
    assert view.dtype == torch.uint8 and view.data_ptr() == mask.data_ptr()
    assert torch.equal(view, mask.to(torch.uint8))
    with pytest.raises(ValueError, match="bool"):
        specaugment._mask_bytes(mask.to(torch.uint8), "tmask")
    with pytest.raises(ValueError, match="bool"):
        specaugment._mask_bytes(torch.rand(157, 3).t() < 0.3, "tmask")


# ----------------------------------------------------------------------------
# K4 (eval block 0)
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("maps,h,w,pair,rows,tiles,threads,smem", [
    (200, 128, 157, 2, 6, 7, 160, 4 * (64 * 12 + 20 * 158)),  # the flagship eval batch: 26 pairs a pooled row
    (3700, 128, 157, 2, 6, 7, 160, 4 * (64 * 12 + 20 * 158)),  # a multi-segment episode at s_max 36
    (200, 128, 126, 2, 6, 7, 128, 4 * (64 * 12 + 20 * 128)),  # NSynth: 21 pairs a pooled row
    (1, 128, 157, 2, 6, 7, 160, 4 * (64 * 12 + 20 * 158)),  # one map
])
def test_block0_plan_at_path_shapes(maps, h, w, pair, rows, tiles, threads, smem):
    plan = convblock.block0_plan(maps, h, w, 64, 3, 3)
    assert (plan.pair, plan.tile_rows, plan.tiles_per_map, plan.threads, plan.smem_bytes) == (
        pair, rows, tiles, threads, smem)
    assert plan.blocks == maps * tiles


def test_block0_plan_covers_every_pooled_row_within_the_limits():
    grid = itertools.product([3, 4, 9, 37, 128], [3, 5, 31, 126, 157, 1000], [1, 8, 64, 256],
                             [(3, 3), (2, 2), (2, 3), (1, 1), (4, 4)])
    checked = 0
    for h, w, c, (ph, pw) in grid:
        if ph > h or pw > w:
            continue
        hp, wp = h // ph, w // pw
        plan = convblock.block0_plan(5, h, w, c, ph, pw)
        assert plan.pair == (2 if (ph, pw) == convblock.BLOCK0_UNROLLED_POOL and wp % 2 == 0 else 1)
        assert (plan.tiles_per_map - 1) * plan.tile_rows < hp <= plan.tiles_per_map * plan.tile_rows
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= convblock.BLOCK0_MAX_THREADS
        assert plan.threads <= max(32, -(-plan.tile_rows * (wp // plan.pair) // 32) * 32)
        assert plan.smem_bytes == convblock.block0_smem_bytes(c, plan.tile_rows, ph, pw, wp) <= SMEM_227K
        assert plan.blocks == 5 * plan.tiles_per_map
        checked += 1
    assert checked > 300


@pytest.mark.parametrize("w,takes", [(157, True), (11466, True), (11469, False), (30000, False)])
def test_block0_plan_refuses_a_row_wider_than_shared_memory(w, takes):
    """The plan tiles a map up to 11 466 frames wide at pool 3 and 64
    channels (one pooled row's tile in shared memory), and raises beyond;
    ``block0_cuda`` plans before it launches, so it raises there too."""
    if takes:
        assert convblock.block0_plan(1, 3, w, 64, 3, 3).smem_bytes <= SMEM_227K
    else:
        with pytest.raises(ValueError, match="shared memory"):
            convblock.block0_plan(1, 3, w, 64, 3, 3)


# ----------------------------------------------------------------------------
# K5 (eval blocks 1-3)
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("maps,h,w,tiling,pitch,stages,stage_bytes,tiles,ctas", [
    # the multi-segment batch's block 1 (3 x 3 700 maps): rectangles of 2 x 16
    # pooled pixels (8 slots of 50 input pixels) and the 17th column's strip
    # of 14 x 1 (44 slots of 5): 8 tiles a map, a copy each (a rectangle's
    # slots lie its width apart), three stages
    (11100, 42, 52, (convblock.RECTS, 0, 2, 16, 14), 0, 3, 8 * 50 * 128, 11100 * 8, 132),
    # its block 2: 20 pooled pixels a map, runs of 32 across maps (at most 28
    # slots of 17, 21 apart), two stages
    (11100, 14, 17, (convblock.RUNS, 32, 0, 0, 0), 21, 2, 74 * 1024, 6938, 132),
    # its block 3: one pooled pixel a map, runs of 16 maps of 5 slots of 5
    (11100, 4, 5, (convblock.RUNS, 16, 0, 0, 0), 5, 3, 80 * 5 * 128, 694, 132),
    (3200, 42, 52, (convblock.RECTS, 0, 2, 16, 14), 0, 3, 8 * 50 * 128, 3200 * 8, 132),  # the E=16 batch
    (200, 42, 52, (convblock.RECTS, 0, 2, 16, 14), 0, 3, 8 * 50 * 128, 1600, 132),  # a prediction
    # NSynth's 128x126: 4 x 8 rectangles and a strip of 5 x 6, 7 tiles a map
    (200, 42, 42, (convblock.RECTS, 0, 4, 8, 5), 0, 3, 46 * 1024, 1400, 132),
    (200, 14, 14, (convblock.RUNS, 32, 0, 0, 0), 14, 3, 28 * 14 * 128, 100, 50),
    # a wide map: 2 x 16 rectangles and a strip of 6 x 5
    (2, 42, 400, (convblock.RECTS, 0, 2, 16, 6), 0, 3, 8 * 50 * 128, 2 * (7 * 8 + 3), 59),
])
def test_blocks_plan_at_path_shapes(maps, h, w, tiling, pitch, stages, stage_bytes, tiles, ctas):
    plan = convblock.blocks_plan(maps, h, w, 3, 3)
    assert (plan.mode, plan.tile_px, plan.rr, plan.rc, plan.sr, plan.pitch) == tiling + (pitch,)
    assert (plan.stages, plan.stage_bytes, plan.tiles, plan.ctas) == (stages, stage_bytes, tiles, ctas)
    assert plan.smem_bytes == convblock.BLOCKS_STAGE_BASE + stages * stage_bytes <= SMEM_227K


def test_blocks_tiles_cover_every_pooled_pixel_once_within_a_stage():
    """For every plan: the tiles hold the concatenated maps' pooled pixels
    exactly once, at most 32 a tile, and every tile's slots fit a stage,
    which with the others, the ring and the weights fits shared memory."""
    grid = itertools.product([1, 3, 40], [3, 4, 14, 42, 45], [3, 5, 17, 52, 104, 400],
                             [(3, 3), (2, 2), (3, 2), (1, 1), (1, 3)])
    checked = 0
    for maps, h, w, (ph, pw) in grid:
        if ph > h or pw > w:
            continue
        hp, wp = h // ph, w // pw
        plan = convblock.blocks_plan(maps, h, w, ph, pw)
        assert plan.smem_bytes == convblock.BLOCKS_STAGE_BASE + plan.stages * plan.stage_bytes <= SMEM_227K
        assert plan.stage_bytes <= convblock.stage_limit(plan.stages) and plan.stages in (2, 3)
        assert plan.stage_bytes % 1024 == 0
        assert plan.ctas == min(-(-plan.tiles // 2), convblock.H100_SMS)
        seen = np.zeros((maps, hp, wp), dtype=int)
        for t in range(plan.tiles):
            g = convblock.tile_geometry(t, plan, hp, wp, ph, pw, maps * hp * wp)
            assert 1 <= g["n"] <= convblock.BLOCKS_TEAM_PX
            for r in range(g["n"]):
                seen[convblock.tile_pixel(g, r, hp, wp)] += 1
            assert g["width"] <= min(g["pitch"], convblock.BLOCKS_MAX_BOX)
            assert g["slots"] * g["pitch"] * convblock.BLOCKS_PIXEL_BYTES <= plan.stage_bytes
        assert (seen == 1).all()
        checked += 1
    assert checked > 300


@pytest.mark.parametrize("maps,h,w", [(200, 42, 52), (11100, 42, 52), (11100, 14, 17), (11100, 4, 5)])
def test_blocks_swizzle_puts_8_pooled_pixels_in_8_banks(maps, h, w):
    """An ldmatrix reads 8 consecutive pixels of a tile at one window
    position; the 128-byte swizzle puts chunk j of the stage's pixel p at
    j ^ (p & 7), and with the plan's pitches the 8 keys differ, also where a
    tile's rows wrap (within a map; rows past a tile's end repeat its last
    pixel, which reads the same address). At the flagship's blocks 1-3;
    NSynth's 128x126 reads 2 ways where its rows wrap (the 42x42 strip of 6
    columns, 14x14's runs, which keep three stages at their width)."""
    plan = convblock.blocks_plan(maps, h, w, 3, 3)
    hp, wp = h // 3, w // 3
    for t in range(min(plan.tiles, 64)):
        g = convblock.tile_geometry(t, plan, hp, wp, 3, 3, maps * hp * wp)
        for first in range(0, g["n"], 8):
            addrs = {}
            for r in range(first, first + 8):
                m, py, px = convblock.tile_pixel(g, min(r, g["n"] - 1), hp, wp)
                srow = 3 * (py - g["lo0"]) if m == g["m0"] else g["rows0"] + (m - g["m0"] - 1) * (3 * hp + 2) + 3 * py
                pix = srow * g["pitch"] + 3 * (px - g["col_lo"])
                addrs[pix] = m
            keys = [p % 8 for p in addrs]
            if len(set(addrs.values())) == 1:  # 8 pixels of one map
                assert len(set(keys)) == len(keys), (t, first)
