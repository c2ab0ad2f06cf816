"""PyTorch port: the launch plans of K2 (episode head) and K3 (mel + log),
computed in Python by their wrappers and checked here on the CPU.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py``);
what they are launched with (tiles, stages, shared-memory bytes, bulk-copy
sizes and offsets, the ragged tail) is plain arithmetic that a wrong edit
would break without a card to show it.
"""

import itertools

import numpy as np
import pytest
import torch

from audio_few_shot_learning_tpu_torch.ops import mel, protohead

HOPPER_SMS = 132
SMEM_227K = 227 * 1024


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
