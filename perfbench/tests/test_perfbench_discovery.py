"""A cell, a configuration and a metric added as new files, with new
entries in BENCHMARK.json, are found by name: no file of the benchmark is
edited."""

import filecmp
import json
import os
import shutil

from perfbench import harness
from perfbench.tests.sizes import SEED

ROOT = harness.ROOT

READER = '''"""Calls of the window (a probe of discovery)."""


def read(t):
    return t.work.get("calls")
'''


def checkout(tmp):
    """A checkout in ``tmp``: the benchmark copied, the program and its
    level data linked."""
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(tmp, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    for pkg in ("safelife_tpu_torch", "safelife_tpu"):
        os.symlink(os.path.join(ROOT, pkg), os.path.join(tmp, pkg))


def test_new_cell_config_and_metric_are_picked_up(tmp_path):
    tmp = str(tmp_path)
    checkout(tmp)
    pb = os.path.join(tmp, "perfbench")
    shutil.copy(os.path.join(pb, "configs", "ppo-prune-spawn.json"),
                os.path.join(pb, "configs", "probe-still.json"))
    with open(os.path.join(pb, "configs", "probe-still.json")) as f:
        cfg = json.load(f)
    cfg["levels"] = "safelife_tpu/levels/benchmarks/v1.0/prune-still.npz"
    with open(os.path.join(pb, "configs", "probe-still.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "workloads",
                           "probe-still.rollout-8.json"), "w") as f:
        json.dump({"driver": "rollout", "lanes": 8, "steps": 12,
                   "sampled": 3, "warmup_steps": 2, "profile_steps": 4,
                   "limits": {"rollout_mismatches": 0, "policy_rel": 1e-4},
                   "why": "a probe"}, f)
    with open(os.path.join(pb, "metrics", "calls.probe.py"), "w") as f:
        f.write(READER)
    bench = harness.manifest(tmp)
    bench["configs"].append({
        "name": "probe-still", "source": "a probe",
        "file": "perfbench/configs/probe-still.json", "reduced": [],
        "why": "a probe"})
    bench["workloads"].append({
        "name": "probe-still.rollout-8", "config": "probe-still",
        "traffic": "rollout-8", "chips": 1, "why": "a probe"})
    bench["end_to_end"][2]["workloads"].append("probe-still.rollout-8")
    bench["per_layer"].append({
        "name": "calls.probe", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "runner", "moves":
        "rollout_env_steps_per_s", "workloads": ["probe-still.rollout-8"]})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    result, _ = harness.run("probe-still.rollout-8", SEED, 0.01,
                            trace=True, device="cpu", root=tmp)
    assert result["correct"]
    assert result["metrics"]["calls.probe"]["value"] >= 1

    # Every file the benchmark had is as it was; only BENCHMARK.json grew.
    cmp = filecmp.dircmp(os.path.join(ROOT, "perfbench"), pb,
                         ignore=["__pycache__"])

    def changed(d):
        return d.diff_files + [x for s in d.subdirs.values()
                               for x in changed(s)]
    assert changed(cmp) == []
