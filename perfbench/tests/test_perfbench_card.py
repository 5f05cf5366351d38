"""On the card: the controls of the cells whose sizes file has ``card``
sizes (the program's policy in TF32 in the training and rollout cells, the
reference's EMD in float32 in the evaluation's) read not correct at a size
a test run holds, and a sound run reads correct.

    python -m pytest perfbench/tests -q -m card
"""

import pytest
import torch

from perfbench import harness
from perfbench.tests.sizes import card

SEED = 2 ** 31 + 7919
CELLS = sorted(w["name"] for w in harness.manifest()["workloads"]
               if card(w["name"]) is not None)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct(device, cell):
    result, checks = harness.run(cell, SEED, 0.5, sizes=card(cell),
                                 control=True)
    assert not result["correct"], checks


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_reads_correct(device, cell):
    result, checks = harness.run(cell, SEED, 0.5, sizes=card(cell))
    assert result["correct"], checks
