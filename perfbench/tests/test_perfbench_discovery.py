"""A cell on a driver of its own, with its configuration, a metric and its
tests' sizes, added as new files with new entries in BENCHMARK.json (and
its end-to-end metric's ``workloads`` grown by the cell), is found by name:
it runs, and the benchmark's tests take it up, with no file of the
benchmark edited."""

import filecmp
import json
import os
import re
import shutil
import subprocess
import sys

from perfbench import harness
from perfbench.tests.sizes import SEED

ROOT = harness.ROOT
CELL = "probe-still.rollout-8"

READER = '''"""Calls of the window (a probe of discovery)."""


def read(t):
    return t.work.get("calls")
'''


def checkout(tmp):
    """A checkout in ``tmp``: the benchmark copied, the program and its
    level data linked, and the probe cell's new files and entries."""
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(tmp, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for pkg in ("safelife_tpu_torch", "safelife_tpu"):
        os.symlink(os.path.join(ROOT, pkg), os.path.join(tmp, pkg))
    pb = os.path.join(tmp, "perfbench")

    def write(rel, data):
        with open(os.path.join(pb, *rel.split("/")), "w") as f:
            if isinstance(data, str):
                f.write(data)
            else:
                json.dump(data, f)

    shutil.copy(os.path.join(pb, "drivers", "rollout.py"),
                os.path.join(pb, "drivers", "probe-rollout.py"))
    cfg = harness.load_json(os.path.join(pb, "configs",
                                         "ppo-prune-spawn.json"))
    cfg["levels"] = "safelife_tpu/levels/benchmarks/v1.0/prune-still.npz"
    write("configs/probe-still.json", cfg)
    write("workloads/%s.json" % CELL, {
        "driver": "probe-rollout", "lanes": 8, "steps": 12, "sampled": 3,
        "warmup_steps": 2, "profile_steps": 4,
        "limits": {"rollout_mismatches": 0, "policy_rel": 1e-4},
        "why": "a probe"})
    write("metrics/calls.probe.py", READER)
    write("tests/tiny/%s.json" % CELL, {"lanes": 4, "steps": 10})

    bench = harness.manifest(ROOT)
    bench["configs"].append({
        "name": "probe-still", "source": "a probe",
        "file": "perfbench/configs/probe-still.json", "reduced": [],
        "why": "a probe"})
    bench["workloads"].append({
        "name": CELL, "config": "probe-still", "traffic": "rollout-8",
        "chips": 1, "why": "a probe"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e["rollout_env_steps_per_s"]["workloads"].append(CELL)
    bench["per_layer"].append({
        "name": "calls.probe", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "runner", "moves":
        "rollout_env_steps_per_s", "workloads": [CELL]})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def assert_nothing_edited(tmp):
    """Every file the benchmark had is as it was; only BENCHMARK.json
    grew."""
    cmp = filecmp.dircmp(os.path.join(ROOT, "perfbench"),
                         os.path.join(tmp, "perfbench"),
                         ignore=["__pycache__"])

    def changed(d):
        return d.diff_files + [x for s in d.subdirs.values()
                               for x in changed(s)]
    assert changed(cmp) == []


def test_new_cell_config_and_metric_are_picked_up(tmp_path):
    tmp = str(tmp_path)
    checkout(tmp)
    result, _ = harness.run(CELL, SEED, 0.01, trace=True, device="cpu",
                            root=tmp)
    assert result["correct"]
    assert result["metrics"]["calls.probe"]["value"] >= 1
    assert_nothing_edited(tmp)


def test_new_cell_passes_the_benchmark_tests_unedited(tmp_path):
    """The drivers' and the manifest's tests, in the checkout, take the
    new cell up from its files: each of its cases runs and passes."""
    tmp = str(tmp_path / "checkout")
    os.mkdir(tmp)
    checkout(tmp)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "pytest",
         "perfbench/tests/test_perfbench_drivers.py",
         "perfbench/tests/test_perfbench_manifest.py", "-k", "probe",
         "-p", "no:cacheprovider", "-v"],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    passed = re.findall(r"^(\S+::\S+) PASSED", out.stdout, re.M)
    assert passed and all("probe" in p for p in passed), out.stdout[-4000:]
    for case in ("test_perfbench_drivers.py::test_sound_run_is_correct",
                 "test_perfbench_drivers.py::test_fault_reads_not_correct",
                 "test_perfbench_manifest.py::"
                 "test_every_cell_has_tiny_sizes"):
        assert any(case in p for p in passed), (case, passed)
    assert_nothing_edited(tmp)
