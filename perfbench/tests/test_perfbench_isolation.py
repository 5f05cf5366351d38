"""Nothing the harness, its reference or its tests import is JAX or the
JAX package (top-level names compared whole), the reference imports
nothing of the program, and a checkout without the program gives no
result."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = harness.ROOT
SOURCES = sorted(glob.glob(os.path.join(ROOT, "perfbench", "**", "*.py"),
                           recursive=True))


def imported(path):
    """Top-level names of the modules a source imports (absolute)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_whole_name_comparison():
    names = ["safelife_tpu_torch", "safelife_tpu_torch.ops", "jaxtyping",
             "safelife_tpu", "safelife_tpu.core", "jax.numpy", "flaxen",
             "jaxlib"]
    assert harness.forbidden_modules(names) == [
        "jax.numpy", "jaxlib", "safelife_tpu", "safelife_tpu.core"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_import_no_jax(path):
    assert not imported(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "safelife_tpu_torch" not in imported(path)
    assert imported(path) <= {"contextlib", "dataclasses", "numpy", "torch",
                              "scipy"}


def test_a_run_loads_no_jax():
    """A whole run in a fresh process, then its loaded modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench import harness\n"
        "from perfbench.tests.sizes import SEED, tiny\n"
        "c = 'ppo-prune-spawn.rollout-16384'\n"
        "r, _ = harness.run(c, SEED, 0.01, device='cpu', sizes=tiny(c))\n"
        "assert r['correct']\n"
        "print(harness.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS=""))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_program_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: the run raises."""
    tmp = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(tmp, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    with pytest.raises((RuntimeError, ImportError)):
        harness.run("ppo-append-spawn.train-4096", 1, 0.01, device="cpu",
                    root=tmp)


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    from perfbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "ppo-append-spawn.train-4096", "--seed",
                     "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
