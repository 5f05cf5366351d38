"""The port stands alone: importing every module of safelife_tpu_torch
(and chip_smoke.py) pulls in neither JAX nor the JAX package, and its entry
points refuse to run on the CPU unless asked to."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import safelife_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    safelife_tpu_torch.__path__, "safelife_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "safelife_tpu"))
print(len(names), bad)
"""


def test_no_jax_and_no_reference_package_imported():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 32
    assert bad == "[]"


def test_cuda_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.io.levels import load_levels
    from safelife_tpu_torch.models.nets import SafeLifePolicyNetwork
    from safelife_tpu_torch.training import ppo
    from safelife_tpu_torch.training.runner import benchmark
    from safelife_tpu_torch.utils.device import resolve_device

    levels = load_levels("benchmarks/v1.0/append-still.npz")[:2]
    with pytest.raises(RuntimeError, match="cuda"):
        pack_levels(levels)
    with pytest.raises(RuntimeError, match="cuda"):
        SafeLifePolicyNetwork(num_channels=15)
    with pytest.raises(RuntimeError, match="cuda"):
        benchmark(None, levels, 1)
    assert resolve_device("cpu") == torch.device("cpu")

    # The training path: each entry point raises unless asked for the CPU.
    pool = pack_levels(levels, device="cpu")
    cfg = E.EnvConfig(view_shape=(17, 17), output_channels=None)
    wcfg, pcfg = W.WrapperConfig(), ppo.PPOConfig(steps_per_env=1)
    net = SafeLifePolicyNetwork(view_shape=(17, 17), num_channels=1,
                                device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        W.reset(cfg, wcfg, pool, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        ppo.init_ppo_state(pcfg, net)
    ws, obs = W.reset(cfg, wcfg, pool, 2, device="cpu")
    ps = ppo.init_ppo_state(pcfg, net, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ppo.train_iteration(cfg, wcfg, pcfg, pool, ps, ws, obs,
                            torch.Generator())

    # The evaluation path and its pieces.
    from safelife_tpu_torch.io.iterator import LevelPoolManager
    from safelife_tpu_torch.side_effects import side_effect_score
    from safelife_tpu_torch.training import train
    from safelife_tpu_torch.training.checkpoints import CheckpointManager

    with pytest.raises(RuntimeError, match="cuda"):
        side_effect_score(levels[0].board, levels[0].board, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        LevelPoolManager(iter(levels), pool_size=2)
    with pytest.raises(RuntimeError, match="cuda"):
        train.run_benchmark(None, None, None, None)
    with pytest.raises(RuntimeError, match="cuda"):
        CheckpointManager(str(tmp_path)).restore()
