"""K2's plan and a numpy model of its passes (``tests/gather_select_model.py``)
against the plain versions of K2 (``gather_select_plain``) and K4's table
entry (``rank_select_table_plain``), bit for bit, on the smoke's stress
cases rebuilt at a small size. CPU only; the card tests hold the kernel to
the same plain versions."""

from __future__ import annotations

import numpy as np
import pytest

from gather_select_model import CONTRACTS, grouped, pack_record, pack_state, stress_inputs, unpack_record
from open3d_slam_private_tpu_torch.kernels import gather_select as tgs
from open3d_slam_private_tpu_torch.kernels import select as tsel

@pytest.mark.parametrize("cap", [24, 48])
@pytest.mark.parametrize("case,by_coords", CONTRACTS,
                         ids=[f"{c}-{'k4_table' if k4 else 'k2'}" for c, k4 in CONTRACTS])
def test_model_matches_plain_bit_for_bit(case, by_coords, cap):
    table, h, q, m = stress_inputs(cap, by_coords)[case]
    plain = tsel.rank_select_table_plain if by_coords else tgs.gather_select_plain
    want = plain(table, h, q, m).numpy().view(np.int32)
    got, scratch, plan = grouped(table.numpy(), h.numpy(), q.numpy(), m.numpy(), by_coords=by_coords)
    assert np.array_equal(got.view(np.int32), want)
    # Another order of the count's atomics gives the same bits.
    again, _, _ = grouped(table.numpy(), h.numpy(), q.numpy(), m.numpy(), by_coords=by_coords, seed=7)
    assert np.array_equal(again.view(np.int32), want)
    inside = (h >= 0) & (h < table.shape[0])
    assert scratch[plan.n_items] <= plan.max_items
    last = scratch[plan.state + 2 * plan.row_blocks - 2: plan.state + 2 * plan.row_blocks].view(np.uint64)[0]
    assert last == pack_state(int(inside.sum()), int(scratch[plan.n_items]))


def test_plan_at_the_headline():
    p = tgs.k2_plan(8 * 65536, 1 << 16, 48)
    assert (p.row_blocks, p.max_items) == (64, 16384 + 65536)
    assert (p.records, p.items, p.state, p.ticket, p.count, p.offset, p.n_items) == (
        0, 2097152, 2424832, 2424960, 2424961, 2490497, 2556033)
    assert p.words == 2556034 and p.words * 4 == 10224136  # 10.2 MB of scratch a call
    assert p.zero_words == 2 * 64 + 1 + 65536
    assert (p.warp_smem, p.block_smem, p.rank_blocks) == (4112, 32896, 132 * 6)


@pytest.mark.parametrize("N,T,cap", [(2345, 4096, 24), (2345, 4096, 48), (2345, 3000, 48),
                                     (0, 4096, 48), (1, 1, 1), (8 * 65536, 1 << 16, 437)])
def test_plan_layout(N, T, cap):
    p = tgs.k2_plan(N, T, cap)
    sizes = [("records", 4 * N), ("items", 4 * p.max_items), ("state", 2 * p.row_blocks), ("ticket", 1),
             ("count", T), ("offset", T), ("n_items", 1)]
    at = 0
    for name, size in sizes:  # disjoint, in this order, back to back
        assert getattr(p, name) == at, name
        at += size
    assert p.words == at
    assert p.items % 4 == 0 and p.state % 2 == 0  # 16-byte items, 8-byte look-back words
    assert p.zero_words == p.offset - p.state  # the memset: look-back words, ticket, row counts
    assert p.row_blocks == -(-T // 1024) and p.max_items == -(-N // 32) + min(N, T)
    assert p.warp_smem == 16 + 2 * max(32 * cap + 512, 2048) and p.block_smem == 8 * p.warp_smem
    per_sm = min(8, 233472 // (p.block_smem + 1024))
    assert p.rank_blocks == 132 * per_sm and per_sm >= 1


def test_plan_refuses_and_max_cap():
    assert tgs.k2_max_cap() == 437
    assert tgs.k2_plan(1, 1, 437).block_smem <= tgs.K2_BLOCK_SMEM < tgs.k2_plan(1, 1, 438).block_smem
    for N, T, cap in ((1 << 31, 16, 48), (-1, 16, 48), (16, 0, 48), (16, (1 << 30) + 1, 48), (16, 16, 0)):
        with pytest.raises(ValueError, match="outside"):
            tgs.k2_plan(N, T, cap)
    tgs.k2_plan((1 << 31) - 1, 1 << 30, 48)  # the largest shape the plan takes


def test_record_packing():
    idx = np.array([0, 1, 12345, (1 << 31) - 1, (1 << 31) - 1, 7], np.int64)
    mask = np.array([True, False, True, True, False, False])
    xyz = np.array([[0.0, -0.0, 1.5], [np.inf, -np.inf, 1e-40], [3.0, 2.0, 1.0], [-1.0, 1e9, 0.25],
                    [5.0, 6.0, 7.0], [1e-45, 0.0, -2.5]], np.float32)
    rec = pack_record(xyz, idx, mask)
    assert np.array_equal(rec[:, 3] >> 31, mask.astype(np.uint32))  # the mask in bit 31
    back_xyz, back_idx, back_mask = unpack_record(rec)
    assert np.array_equal(back_xyz.view(np.uint32), xyz.view(np.uint32))
    assert np.array_equal(back_idx, idx) and np.array_equal(back_mask, mask)
    s = pack_state(123, 45, flag=1)
    assert int(s) >> 62 == 1 and (int(s) >> 31) & 0x7FFFFFFF == 45 and int(s) & 0x7FFFFFFF == 123
