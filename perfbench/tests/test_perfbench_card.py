"""On the card: the controls of the training and rollout cells (the
program's policy in TF32) read not correct at a size a test run holds,
and a sound run reads correct.

    python -m pytest perfbench/tests -q -m card
"""

import pytest
import torch

from perfbench import harness

SEED = 2 ** 31 + 7919
SMALL = {
    "ppo-append-spawn.train-64": {"lanes": 64},
    "ppo-prune-spawn.rollout-16384": {"lanes": 512, "steps": 60,
                                     "profile_steps": 10},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_reads_not_correct(card, cell):
    result, checks = harness.run(cell, SEED, 0.5, sizes=SMALL[cell],
                                 control=True)
    assert not result["correct"], checks


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_reads_correct(card, cell):
    result, checks = harness.run(cell, SEED, 0.5, sizes=SMALL[cell])
    assert result["correct"], checks
