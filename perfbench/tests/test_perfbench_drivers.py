"""Each cell at a tiny size on the CPU, its window's outputs judged against
the plain reference: sound runs read correct, and every fault its driver
can plant (its ``FAULTS``), and the evaluation's float32 control, read not
correct. A cell's sizes come from its own file (``sizes.tiny``)."""

import json

import pytest

from perfbench import harness
from perfbench.tests.sizes import SEED, tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def run(cell, **kw):
    return harness.run(cell, kw.pop("seed", SEED), 0.05, device="cpu",
                       sizes=tiny(cell), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, checks = run(cell)
    assert result["correct"], checks
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "setup_phases", "reference_s",
                            "checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    json.dumps(result)


def faults(cell):
    """The faults that ``cell``'s driver plants (none where it has no
    ``FAULTS``: the manifest's tests fail that driver, collection goes
    on)."""
    return getattr(harness.driver(harness.cell(cell)[2]["driver"]),
                   "FAULTS", {})


FAULTY = [(cell, fault) for cell in CELLS for fault in faults(cell)]


@pytest.mark.parametrize("cell,fault", FAULTY)
def test_fault_reads_not_correct(cell, fault):
    result, checks = run(cell, fault=fault, seed=SEED + 1)
    assert not result["correct"], (fault, checks)


#: What the drivers of the first cells plant: a state left unchanged, half
#: of each minibatch left out (training), a token altered.
DRIVER_FAULTS = {
    "train": ("unchanged", "half_batch", "token"),
    "evaluate": ("unchanged", "token"),
    "rollout": ("unchanged", "token"),
}


@pytest.mark.parametrize("name", sorted(DRIVER_FAULTS))
def test_driver_plants_its_faults(name):
    assert tuple(harness.driver(name).FAULTS) == DRIVER_FAULTS[name]


def test_evaluation_control_reads_not_correct():
    """The reference's scores in float32 in the program's place."""
    cell = "ppo-prune-spawn.eval-25"
    result, checks = run(cell, control=True, seed=SEED + 2)
    assert not result["correct"]
    assert checks["side_effect_rel"]["value"] > checks["side_effect_rel"][
        "limit"]
    assert checks["eval_mismatches"]["value"] == 0


def test_traced_run_reads_span_metrics():
    """On the CPU there is no device trace: those readers return nothing
    and the span metrics remain."""
    cell = "ppo-append-spawn.train-4096"
    result, _ = run(cell, trace=True)
    assert set(result["metrics"]) == {"ppo_rollout_ms.train",
                                      "ppo_update_ms.train", "mfu_pct.train"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
