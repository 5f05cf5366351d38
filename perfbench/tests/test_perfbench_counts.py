"""The yardstick's counts against hand counts."""

import torch

from perfbench import harness, peaks
from perfbench.profiling import NO_OP, idle_by_host, merge

CFG = harness.cell("ppo-append-spawn.train-4096")[3]


def test_policy_macs_by_hand():
    # 25x25x15 in; 5x5/2 -> 11x11x32, 3x3/2 -> 5x5x64, 3x3/1 -> 3x3x64;
    # dense 576 -> 512; heads 512 -> 1 + 9.
    conv0 = 11 * 11 * 32 * 5 * 5 * 15
    conv1 = 5 * 5 * 64 * 3 * 3 * 32
    conv2 = 3 * 3 * 64 * 3 * 3 * 64
    dense = 576 * 512 + 512 * 10
    assert peaks.policy_macs(CFG["policy"], (25, 25)) == (
        conv0 + conv1 + conv2 + dense, conv0)
    assert conv0 + conv1 + conv2 + dense == 2544608


def test_ppo_iteration_flops_by_hand():
    fwd = 2 * 2544608
    conv0 = 2 * 1452000
    lanes, steps = 4096, 20
    want = ((steps + 1) * lanes * fwd
            + 3 * steps * lanes * (3 * fwd - conv0)
            + steps * lanes * fwd)
    got = peaks.ppo_iteration_flops(
        CFG["policy"], (25, 25),
        {"rollout": (steps + 1) * lanes, "batch": steps * lanes}, 3)
    assert got == want
    assert abs(got / 3.892e12 - 1) < 1e-3


def test_bound():
    t, by = peaks.bound(3.35e12, 1.0)
    assert abs(t - 1.0) < 1e-12 and by == "bytes"
    t, by = peaks.bound(1.0, 2 * peaks.INT32_OPS_PER_S)
    assert abs(t - 2.0) < 1e-12 and by == "operations"


def test_board_and_view_work_by_hand():
    # 2 boards of 3x4, one agent each: read + write 12 words a board; an
    # agent's location in and out, its action and cell; 2 probabilities
    # and the 2 seed words.
    assert peaks.board_step_work(2, 3, 4, 1) == (
        2 * 2 * 12 * 4 + 2 * (16 + 4 + 4) + 2 * 4 + 8,
        2 * 12 * 55 + 2 * 60)
    # One lane, a 3x3 view at (1, 1) of a 4x4 board: 9 cells covered; one
    # valid exit at (3, 3), outside the view: 10 cells.
    cy = torch.tensor([[1]])
    cx = torch.tensor([[1]])
    exits = torch.tensor([[[3, 3]]])
    valid = torch.tensor([[True]])
    assert peaks.covered_cells(4, 4, cy, cx, exits, valid, (3, 3)) == 10
    assert peaks.view_work(4, 4, cy, cx, exits, valid, (3, 3)) == (
        2 * 10 * 4 + 2 * 4 + 9 + 9 * 4, 9 * 10 + 12)


def test_union_and_idle_gaps():
    assert merge([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    gaps = idle_by_host([[1, 3], [5, 6]],
                        [(0, 10, "outer"), (3.5, 4.5, "inner")], (0, 10))
    # Idle: [0, 1] and [6, 10] under outer, [3, 5] under inner.
    assert abs(gaps["outer"] - 5e-6) < 1e-15
    assert abs(gaps["inner"] - 2e-6) < 1e-15
    assert idle_by_host([], [], (0, 4)) == {NO_OP: 4e-6}
