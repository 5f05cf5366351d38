"""The port's trainer and CLI against the JAX package's, on the CPU.

``build_config`` and ``check_for_unused`` with overrides, and
``build_environments`` (configs, the pool's levels, the validation and
benchmark levels byte for byte, the schedules) against the JAX package's;
then the slice: ``python -m safelife_tpu_torch train ... --device cpu``
trains, logs in the JAX package's formats, checkpoints, resumes on the
restored pool (the learner only when the batch changed), and benchmarks
from the checkpoint. The training draws are torch's and JAX's and never
match, so the loop's bookkeeping is held, not its numbers."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from safelife_tpu import loggers as JLOG  # noqa: E402
from safelife_tpu.training import env_factory as JF  # noqa: E402
from safelife_tpu.training import global_config as JGC  # noqa: E402
from safelife_tpu.training import ppo as JPPO  # noqa: E402
from safelife_tpu.utils import rng as JRNG  # noqa: E402
from safelife_tpu_torch import __main__ as CLI  # noqa: E402
from safelife_tpu_torch import loggers as TLOG  # noqa: E402
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.training import env_factory as TF  # noqa: E402
from safelife_tpu_torch.training import global_config as TGC  # noqa: E402
from safelife_tpu_torch.training import ppo as TPPO  # noqa: E402
from safelife_tpu_torch.training import train as TT  # noqa: E402
from safelife_tpu_torch.training.checkpoints import (  # noqa: E402
    CheckpointManager)
from safelife_tpu_torch.utils import rng as TRNG  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL_FIELDS = ("board", "goals", "agent_locs", "agent_names",
                "points_table", "min_performance", "spawn_prob", "name")


def _fresh():
    """What a new process starts with: empty configs and logger stats
    (both are shared by the whole process)."""
    for cfg in (JGC.config, TGC.config):
        cfg.clear()
        cfg._used.clear()
    for cls in (JLOG.SafeLifeLogger, TLOG.SafeLifeLogger):
        cls.cumulative_stats.clear()


@pytest.fixture(autouse=True)
def fresh_state():
    _fresh()
    yield
    _fresh()


def assert_same_levels(xs, ys):
    assert len(xs) == len(ys)
    for a, b in zip(xs, ys):
        for k in LEVEL_FIELDS:
            x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k


def test_build_config_matches_jax():
    overrides = {"ppo.gamma": 0.9, "learning_rate": 1e-3,
                 "ppo.num_minibatches": 2, "dqn.gamma": 0.5,
                 "unused.key": 1, "_private": 3}
    for cfg in (JGC.config, TGC.config):
        cfg.update(overrides)
        assert cfg.setdefault("env.view_size", 25) == 25
    j = JGC.build_config(JPPO.PPOConfig, "ppo")
    t = TGC.build_config(TPPO.PPOConfig, "ppo")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.gamma == 0.9 and t.learning_rate == 1e-3
    assert JGC.config.check_for_unused() == TGC.config.check_for_unused() \
        == ["dqn.gamma", "unused.key"]
    seen = []
    TGC.config.add_hook(lambda k, v: seen.append((k, v)))
    TGC.config["x"] = 1
    assert seen == [("x", 1)]


@pytest.mark.parametrize("task", ("append-still", "append-spawn", "asym1"))
def test_build_environments_matches_jax(task):
    bundles = []
    for cfg, factory, set_rng, dev in (
            (JGC.config, JF, JRNG.set_rng, {}),
            (TGC.config, TF, TRNG.set_rng, {"device": "cpu"})):
        cfg.update({"env_type": task, "seed": 11,
                    "side_effect.penalty": 0.5})
        # The switching iterator's coin flips draw from the global
        # generator: the same seed on both sides.
        with set_rng(np.random.default_rng(1)):
            bundles.append(factory.build_environments(
                cfg, num_envs=4, pool_size=4, procgen_workers=0, **dev))
    j, t = bundles
    for f in dataclasses.fields(t.env_cfg):
        assert getattr(j.env_cfg, f.name) == getattr(t.env_cfg, f.name)
    assert t.env_cfg.output_channels is None and t.packed_obs
    assert dataclasses.asdict(j.wrapper_cfg) == \
        dataclasses.asdict(t.wrapper_cfg)
    assert tuple(j.obs_channels) == tuple(t.obs_channels)
    assert j.side_effect_weights == t.side_effect_weights
    assert_same_levels(j.pool_manager._host_levels,
                       t.pool_manager._host_levels)
    assert_same_levels(j.validation_levels, t.validation_levels)
    assert_same_levels(j.benchmark_levels, t.benchmark_levels)
    assert len(t.validation_levels) == 5 and t.benchmark_levels
    assert t.pool_manager.pool.device == torch.device("cpu")
    for flag in ("all_goals_static", "spawner_free"):
        assert getattr(j.pool_manager.pool, flag) == \
            getattr(t.pool_manager.pool, flag)
    for steps in (0, 1.2e6, 3e6):
        JLOG.SafeLifeLogger.cumulative_stats["training_steps"] = steps
        TLOG.SafeLifeLogger.cumulative_stats["training_steps"] = steps
        for name in ("se_penalty_schedule", "exit_difficulty_schedule"):
            assert getattr(j, name)() == getattr(t, name)()
        if task == "append-spawn":
            assert j.pool_manager.iterator.p_switch() == \
                t.pool_manager.iterator.p_switch()
    assert type(t.pool_manager.iterator).__name__ == \
        type(j.pool_manager.iterator).__name__
    assert JGC.config.check_for_unused() == TGC.config.check_for_unused()


def test_unported_options_raise(tmp_path, monkeypatch):
    """The modes that once raised now build and train on the CPU:
    ``env.packed_obs: false`` with ``train.precision`` bfloat16 (uint8
    channels into a bfloat16 learner) and ``env.device_procgen`` (the
    start-up pool and its refills from the device annealer); --algo dqn
    trains, resumes and benchmarks; ``train.torch_init: false`` (flax's
    init) trains. An unknown task still raises."""
    from safelife_tpu_torch.procgen import batched as TB

    run = str(tmp_path / "channels")
    out = _train(run, 1280, extra=["--skip-benchmark", "-x", json.dumps({
        "env.pool_size": 4, "env.procgen_workers": 0,
        "env.packed_obs": False, "train.precision": "bfloat16"})])
    assert not out.bundle.packed_obs and out.model.precision == "bfloat16"
    assert out.model.unpack_channels is None
    assert out.state.num_steps == 1280 and _params_finite(out.model)
    saved, _, _ = CheckpointManager(run).restore(device="cpu")
    ws = saved["env_state"]
    obs = TF.E._batch_obs(out.bundle.env_cfg, saved["pool"], ws.env)
    assert obs.dtype == torch.uint8
    assert obs.shape[-1] == len(TN.TRAINING_CHANNELS)

    made = []
    real = TB.gen_games_batched

    def spy(param_dicts, rngs, generator):
        made.append(len(param_dicts))
        return real(param_dicts, rngs, generator)

    monkeypatch.setattr(TB, "gen_games_batched", spy)
    out = _train(str(tmp_path / "device"), 1280, extra=[
        "--skip-benchmark", "-x", json.dumps({
            "env.pool_size": 4, "env.procgen_workers": 0,
            "env.device_procgen": 4})])
    it = out.bundle.pool_manager.iterator
    assert it.device_batch == 4 and it.num_workers == 0
    assert made and set(made) == {4}
    assert out.state.num_steps == 1280 and _params_finite(out.model)

    # --algo dqn is ported: it trains, resumes and benchmarks on the CPU.
    _check_dqn_cli(str(tmp_path / "dqn"))
    _fresh()
    with pytest.raises(ValueError, match="not a recognized task"):
        CLI.main(["train", "-e", "no-such-task", "--device", "cpu"])
    # train.torch_init: false: flax's init (zero biases); the run trains.
    out = _train(str(tmp_path / "flax-init"), 1280, extra=[
        "--skip-benchmark", "-x", json.dumps({
            "env.pool_size": 4, "env.procgen_workers": 0,
            "train.torch_init": False})])
    assert out.state.num_steps == 1280 and _params_finite(out.model)
    assert TGC.config["train.torch_init"] is False
    for algo in ("ppo", "dqn"):
        model = TT.build_model(out.bundle, algo, device="cpu")[0]
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                assert not p.any(), name


CPU = ["--device", "cpu", "-e", "append-still", "--seed", "3", "-x",
       json.dumps({"env.pool_size": 4, "env.procgen_workers": 0})]


def _train(data_dir, steps, batch=4, extra=()):
    """One CLI run, as a new process would start it."""
    _fresh()
    return CLI.main(["train", data_dir, "--batch", str(batch), "--steps",
                     str(steps), *CPU, *extra])


DQN_CONFIG = {"dqn.replay_size": 512, "dqn.replay_initial": 64,
              "dqn.report_interval": 512}


def _check_dqn_cli(run):
    """``--algo dqn``: train two chunks (32 units of 8 steps of 4 lanes),
    resume one chunk more with the learner and target network restored,
    then benchmark the checkpoint's Q network."""
    cpu = CPU[:-1] + [json.dumps({**json.loads(CPU[-1]), **DQN_CONFIG})]
    _fresh()
    out = CLI.main(["train", run, "--algo", "dqn", "--batch", "4", "--steps",
                    "2048", "--skip-benchmark", *cpu])
    assert isinstance(out.model, TN.SafeLifeQNetwork)
    assert out.state.num_steps == 2048 and out.state.replay.idx >= 64
    assert _params_finite(out.model)
    ckpt = CheckpointManager(run)
    saved, _, _ = ckpt.restore(device="cpu")
    assert ckpt.steps() == [2048] and "target_params" in saved
    _fresh()
    out = CLI.main(["train", run, "--algo", "dqn", "--batch", "4", "--steps",
                    "3072", "--skip-benchmark", *cpu])
    assert out.state.num_steps == 3072 and ckpt.steps() == [2048, 3072]
    _fresh()
    out = CLI.main(["train", run, "--algo", "dqn", "--run-type", "benchmark",
                    "--benchmark-episodes", "1", *CPU])
    assert out.state is None and out.summary["episodes"] == 1
    latest, _, _ = ckpt.restore(device="cpu")
    for k, v in out.model.state_dict().items():
        assert torch.equal(v, latest["params"][k]), k
    with open(os.path.join(run, "training.log")) as f:
        assert "pcheck=" in f.read()


def _params_finite(model):
    return all(torch.isfinite(p).all() for p in model.parameters())


def test_cli_trains_resumes_and_benchmarks(tmp_path, monkeypatch):
    run = str(tmp_path / "run")
    out = _train(run, 1280, extra=["--skip-benchmark"])
    assert out.state.num_steps >= 1280 and out.summary is None
    assert _params_finite(out.model)
    for name in ("training.log", "training-log.json"):
        assert os.path.exists(os.path.join(run, name)), name
    ckpt = CheckpointManager(run)
    assert ckpt.steps() == [out.state.num_steps]

    # Resume: the learner, the env state and the pool it was saved with.
    restored = []
    real = TT._restore_latest

    def spy(ckpt, pstate, ws, bundle, device):
        got = real(ckpt, pstate, ws, bundle, device)
        restored.append((got, pstate.num_steps, bundle.pool_manager.pool))
        return got

    monkeypatch.setattr(TT, "_restore_latest", spy)
    saved, _, step = ckpt.restore(device="cpu")
    out2 = _train(run, 1920, extra=["--skip-benchmark"])
    (ws, obs, extra, rstep), n0, pool = restored[-1]
    assert rstep == step == n0 == 1280 and obs is not None
    assert extra["training_steps"] == 1280
    assert torch.equal(pool.board, saved["pool"].board)
    assert torch.equal(ws.env.board, saved["env_state"].env.board)
    assert out2.state.num_steps == 1920
    assert ckpt.steps() == [1280, 1920]

    # Another batch size: the learner alone comes back.
    out3 = _train(run, 2560, batch=8, extra=["--skip-benchmark"])
    (ws, obs, _, rstep), n0, _ = restored[-1]
    assert rstep == n0 == 1920 and obs is None
    assert ws.env.board.shape[0] == 8
    assert out3.state.num_steps == 1920 + 8 * 20 * 8

    # Benchmark the latest checkpoint without training.
    _fresh()
    out4 = CLI.main(["train", run, "--run-type", "benchmark",
                     "--benchmark-episodes", "1", *CPU])
    assert out4.state is None and out4.summary["episodes"] == 1
    latest, _, _ = ckpt.restore(device="cpu")
    for k, v in out4.model.state_dict().items():
        assert torch.equal(v, latest["params"][k]), k
    bench = TLOG.summarize_run(run)["benchmark-data.json"]
    assert abs(bench["reward"] - out4.summary["reward"]) < 1e-9

    # Both packages' loaders read the logs alike, and the JAX package's
    # snapshot tool reads the run.
    for name in ("training-log.json", "benchmark-data.json"):
        t, j = (load(os.path.join(run, name)) for load in (
            TLOG.load_safelife_log, JLOG.load_safelife_log))
        assert t.keys() == j.keys()
        for k in t:
            assert np.array_equal(t[k], j[k]), k
    assert len(t["reward"]) == 1 and "side_effects.total" in t
    snap = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "snapshot_run.py"),
         run, str(tmp_path / "snap")], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert snap.returncode == 0, snap.stderr
    summary = json.loads(snap.stdout)
    assert summary["benchmark_episodes"] == 1
    assert summary["benchmark"]["reward"] == round(bench["reward"], 4)


def _torchrun(argv, ranks=2):
    """``torchrun --standalone --nproc-per-node <ranks> -m
    safelife_tpu_torch <argv>``, one thread a rank, under a time limit;
    its output (both ranks' lines, tagged ``[rank N]``)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(ranks), "-m", "safelife_tpu_torch",
         *argv], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return out.stdout + out.stderr


def _rank_lines(log, marker):
    """{rank: [lines containing ``marker``]} of a torchrun run's output."""
    lines = {}
    for line in log.splitlines():
        if marker in line and line.startswith("[rank "):
            rank = int(line[6:line.index("]")])
            lines.setdefault(rank, []).append(line.split("] ", 1)[1])
    return lines


def _pchecks(log):
    return {r: [ln.split("pcheck=")[1] for ln in v]
            for r, v in _rank_lines(log, "pcheck=").items()}


@pytest.mark.parametrize("algo", ["ppo", "dqn"])
def test_torchrun_two_ranks_train_checkpoint_and_resume(tmp_path, algo):
    """Two ranks of 2 lanes each (a global batch of 4) on the CPU over
    ``gloo``: every report's ``pcheck`` is bitwise equal on both ranks;
    rank 0 alone writes the one checkpoint, and both ranks restore it
    when the run resumes."""
    run = str(tmp_path / "run")
    extra = {"env.pool_size": 4, "env.procgen_workers": 0}
    steps = (1280, 1920)
    if algo == "dqn":
        extra.update(DQN_CONFIG)
        steps = (2048, 3072)
    argv = ["train", run, "--algo", algo, "--device", "cpu", "-e",
            "append-still", "--seed", "3", "--batch", "4",
            "--skip-benchmark", "-x", json.dumps(extra)]
    log = _torchrun(argv + ["--steps", str(steps[0])])
    first = _pchecks(log)
    assert set(first) == {0, 1} and first[0] and first[0] == first[1]
    ckpt = CheckpointManager(run)
    assert ckpt.steps() == [steps[0]]
    saved, _, _ = ckpt.restore(device="cpu")
    assert saved["env_state"].env.board.shape[0] == 4  # the global batch
    assert saved["pool"].board.shape[0] == 8  # both ranks' 4 slots

    log = _torchrun(argv + ["--steps", str(steps[1])])
    restored = _rank_lines(log, "restored checkpoint at step %d" % steps[0])
    assert set(restored) == {0, 1}
    second = _pchecks(log)
    assert second[0] and second[0] == second[1]
    assert ckpt.steps() == list(steps)
    with open(os.path.join(run, "training.log")) as f:
        text = f.read()
    assert "[rank 0]" in text and "[rank 1]" not in text
