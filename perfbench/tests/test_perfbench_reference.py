"""The reference's pieces against the program's plain versions on the CPU
(the reference imports nothing of the program; a test may)."""

import numpy as np
import torch

from perfbench.reference import env as R
from safelife_tpu_torch.core import advance as ADV
from safelife_tpu_torch.ops import physics as PH

SEEDS = torch.tensor([[-2 ** 31, 2 ** 31 - 1], [12345, -678], [0, 1]],
                     dtype=torch.int32)


def test_spawn_coins_match_the_program():
    prob = torch.tensor([0.3, 0.05, 0.9], dtype=torch.float32)
    many = R.spawn_coins(SEEDS, prob, 3, 5, 7)
    for k, seed in enumerate(SEEDS):
        want = PH.spawn_coins(seed, prob, 3, 35).reshape(3, 5, 7)
        assert torch.equal(R.spawn_coins(seed, prob, 3, 5, 7), want)
        assert torch.equal(many[k], want)


def test_spawn_coins_of_sampled_lanes_are_their_rows():
    """A replay of some of a run's lanes draws each lane's own coins."""
    prob = torch.tensor([0.3, 0.05, 0.9, 0.5, 0.7], dtype=torch.float32)
    lanes = torch.tensor([1, 3, 4])
    full = R.spawn_coins(SEEDS[1], prob, 5, 6, 7)
    part = R.spawn_coins(SEEDS[1], prob[lanes], 3, 6, 7, lanes)
    assert torch.equal(part, full[lanes])


def test_ca_step_matches_the_program():
    rng = np.random.default_rng(5)
    cells = np.array([0, R.LIFE, R.ALIVE, R.FROZEN, R.LIFE | R.COLOR_G,
                      R.FROZEN | R.SPAWNING | R.DESTRUCTIBLE,
                      R.PRESERVING | R.FROZEN, R.LEVEL_EXIT])
    board = torch.as_tensor(rng.choice(cells, size=(4, 9, 11)),
                            dtype=torch.int32)
    coins = torch.as_tensor(rng.random((4, 9, 11)) < 0.3)
    assert torch.equal(R.advance(board, coins),
                       ADV.advance_board_given_spawns(board, coins))
