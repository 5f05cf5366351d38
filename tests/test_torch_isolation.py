"""The port stands alone: importing every module of safelife_tpu_torch
(and chip_smoke.py) pulls in neither JAX nor the JAX package (nor pygame or
imageio, which the card's host lacks) and builds nothing, and its entry
points refuse to run on the CPU unless asked to."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, os, pkgutil, subprocess, sys
compilers = []
class Recorded(subprocess.Popen):
    def __init__(self, args, *a, **k):
        prog = os.path.basename(str(args[0] if isinstance(args, list)
                                    else args).split()[0])
        if prog in ("g++", "gcc", "c++", "nvcc"):
            compilers.append(prog)
        super().__init__(args, *a, **k)
subprocess.Popen = Recorded
import safelife_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    safelife_tpu_torch.__path__, "safelife_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from safelife_tpu_torch import native
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "safelife_tpu",
                                    "pygame", "imageio"))
print(len(names), len(compilers), len(native._libs), bad)
"""


def test_no_jax_and_no_reference_package_imported():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, started, lib, bad = out.stdout.strip().split(" ", 3)
    # 55 modules, training.dqn, the front end, the device annealer, the
    # oracle's generator, the multi-process package and the bench among
    # them.
    assert int(n) >= 55
    assert {"safelife_tpu_torch.training.dqn", "safelife_tpu_torch.game",
            "safelife_tpu_torch.registry", "safelife_tpu_torch.interactive",
            "safelife_tpu_torch.interactive_gl",
            "safelife_tpu_torch.variants",
            "safelife_tpu_torch.render.graphics",
            "safelife_tpu_torch.procgen.anneal_device",
            "safelife_tpu_torch.procgen.batched",
            "safelife_tpu_torch.core.pcg64",
            "safelife_tpu_torch.parallel.mesh",
            "safelife_tpu_torch.parallel.spatial",
            "safelife_tpu_torch.bench"} <= _modules()
    assert bad == "[]"
    # Importing builds nothing: no compiler started, no library loaded.
    assert started == "0" and lib == "0"


def _modules():
    import pkgutil

    import safelife_tpu_torch
    return {m.name for m in pkgutil.walk_packages(
        safelife_tpu_torch.__path__, "safelife_tpu_torch.")}


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

    # DQN: the Q network, the learner, its unit and the trainer.
    from safelife_tpu_torch.models.nets import SafeLifeQNetwork
    from safelife_tpu_torch.training import dqn

    with pytest.raises(RuntimeError, match="cuda"):
        SafeLifeQNetwork(num_channels=15)
    qnet = SafeLifeQNetwork(view_shape=(17, 17), num_channels=1,
                            device="cpu")
    dcfg = dqn.DQNConfig(replay_size=8)
    with pytest.raises(RuntimeError, match="cuda"):
        dqn.init_dqn_state(dcfg, qnet, 2, (17, 17), torch.int32)
    with pytest.raises(RuntimeError, match="cuda"):
        dqn.init_replay(8, (17, 17))
    ds = dqn.init_dqn_state(dcfg, qnet, 2, (17, 17), torch.int32,
                            device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        dqn.collect_and_optimize(cfg, wcfg, dcfg, pool, ds, ws, obs,
                                 torch.Generator(), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        dqn.train_chunk(cfg, wcfg, dcfg, pool, ds, ws, obs,
                        torch.Generator(), 1, 1)
    assert ds.num_steps == 0 and ds.replay.idx == 0

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

    # The trainer and the CLI.
    from safelife_tpu_torch import __main__ as cli
    from safelife_tpu_torch.io.iterator import SafeLifeLevelIterator
    from safelife_tpu_torch.training.env_factory import build_environments
    from safelife_tpu_torch.training.global_config import GlobalConfig

    with pytest.raises(RuntimeError, match="cuda"):
        build_environments(GlobalConfig(env_type="append-still"),
                           num_envs=2, pool_size=2, procgen_workers=0)
    with pytest.raises(RuntimeError, match="cuda"):
        train.train_ppo(None)
    with pytest.raises(RuntimeError, match="cuda"):
        train.train_dqn(None)
    it = SafeLifeLevelIterator("random/append-still", seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        LevelPoolManager(it, pool_size=2)
    assert it.idx == 0  # nothing generated
    for algo in ("ppo", "dqn"):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["train", str(tmp_path / "run"), "-e", "append-still",
                      "--algo", algo])
    assert not os.path.exists(tmp_path / "run")

    # The front end: make, the game loop and the play verb; nothing is
    # generated before the device is refused.
    from safelife_tpu_torch import interactive, registry

    with pytest.raises(RuntimeError, match="cuda"):
        registry.make("safelife-append-still-v1")
    with pytest.raises(RuntimeError, match="cuda"):
        interactive.GameLoop(it)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["play", "benchmarks/v1.0/append-still.npz"])
    assert it.idx == 0
    assert interactive.GameLoop(it, device="cpu").device == \
        torch.device("cpu")
