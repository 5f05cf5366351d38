"""The port's ``bench`` verb (``safelife_tpu_torch/bench.py``) against the
root ``bench.py``, on the CPU: the bench's step loop (the observation
checksum folded into the actions in int32, then ``env.step``) against the
same loop around JAX's ``step_impl`` on the same NumPy base actions, bit for
bit; the verb's one-line output and sidecar; and its refusals."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu.env import env as JE, state as JST  # noqa: E402
from safelife_tpu.io import levels as JL  # noqa: E402
from safelife_tpu.training.env_factory import (  # noqa: E402
    TRAINING_CHANNELS as J_CHANNELS)
from safelife_tpu_torch import bench as TB  # noqa: E402
from safelife_tpu_torch.env import state as TST  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, STEPS, TIME_LIMIT = 8, 40, 15


def _jax_bench():
    """The root ``bench.py`` by path (``import bench`` is the folder)."""
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _one_level_pools():
    """A one-level pool cut from append-still: every auto-reset picks the
    same level on both sides, whatever their random streams."""
    jl = JL.load_levels(TB.LEVELS)[:1]
    tl = TL.load_levels(TB.LEVELS)[:1]
    return JST.pack_levels(jl), TST.pack_levels(tl, device="cpu")


def _jax_loop(obs_mode):
    """``bench.py:98-119``'s config and step body, one step at a time on
    the given base actions."""
    cfg = JE.EnvConfig(
        view_shape=(25, 25),
        output_channels=None if obs_mode == "packed" else J_CHANNELS,
        time_limit=TIME_LIMIT, goals_may_evolve=False, stochastic=False,
        auto_reset=True, flat_obs=obs_mode == "flat")

    @jax.jit
    def body(state, obs, base, key):
        checksum = obs.reshape(BATCH, 1, -1).sum(axis=-1, dtype=jnp.int32)
        actions = (base + checksum) % 9
        state, obs, reward, done, info = JE.step_impl(
            cfg, jpool, state, actions, key)
        return state, obs, reward, checksum, actions

    jpool, _ = _one_level_pools()
    state, obs = JE.reset(cfg, jpool, jax.random.PRNGKey(0), BATCH)
    return body, state, obs


def _port_run(tpool, obs_mode, bases):
    """The port's loop fed ``bases``, its episodes cut to TIME_LIMIT."""
    feed = iter(torch.as_tensor(b) for b in bases)
    run = TB.setup(tpool, obs_mode, BATCH, draw=lambda: next(feed))
    run.cfg = dataclasses.replace(run.cfg, time_limit=TIME_LIMIT)
    return run


@pytest.mark.parametrize("obs_mode", ["packed", "channels", "flat"])
def test_step_loop_matches_jax(obs_mode):
    """40 steps of 8 lanes with resets every 15 steps: per step the
    checksum, the folded actions, the rewards and their sum and the
    boards bit for bit; then the same actions through ``run_chunk``."""
    rng = np.random.default_rng(7)
    bases = rng.integers(0, 9, (STEPS, BATCH, 1), dtype=np.int32)
    _, tpool = _one_level_pools()
    body, jstate, jobs = _jax_loop(obs_mode)
    run = _port_run(tpool, obs_mode, bases)
    np.testing.assert_array_equal(run.obs.numpy(), np.asarray(jobs))
    key = jax.random.PRNGKey(1)
    total = 0.0
    for t in range(STEPS):
        key, k = jax.random.split(key)
        jstate, jobs, jrew, jcheck, jact = body(
            jstate, jobs, jnp.asarray(bases[t]), k)
        reward, check, actions = TB.step(run)
        what = "step %d" % t
        np.testing.assert_array_equal(check.numpy(), np.asarray(jcheck),
                                      err_msg=what)
        np.testing.assert_array_equal(actions.numpy(), np.asarray(jact),
                                      err_msg=what)
        np.testing.assert_array_equal(reward.numpy(), np.asarray(jrew),
                                      err_msg=what)
        assert reward.sum().item() == float(jnp.sum(jrew)), what
        np.testing.assert_array_equal(run.state.board.numpy(),
                                      np.asarray(jstate.board), err_msg=what)
        np.testing.assert_array_equal(run.obs.numpy(), np.asarray(jobs),
                                      err_msg=what)
        total += float(jnp.sum(jrew))
    # Resets happened inside the window: every lane's clock restarted.
    assert int(run.state.num_steps.max()) < TIME_LIMIT
    assert total != 0.0

    again = _port_run(tpool, obs_mode, bases)
    rsum = TB.run_chunk(again, STEPS)
    assert rsum.dtype == torch.float32 and rsum.item() == pytest.approx(
        total, abs=1e-4)
    np.testing.assert_array_equal(again.state.board.numpy(),
                                  run.state.board.numpy())


@pytest.mark.parametrize("fill,base", [
    (2 ** 27, 0),                 # 625 x 2^27: past 2^31, wraps negative
    (2 ** 27 + 2 ** 26 + 3, 8),   # wraps twice over, then the + base
    (-(2 ** 27), 5),              # negative sums: the floor mod
])
def test_checksum_wraps_as_jax(fill, base):
    """A lane whose packed views sum past 2^31 wraps in int32 and folds
    with a floor mod, as JAX's ``sum(dtype=int32)`` and ``%`` do."""
    rng = np.random.default_rng(3)
    obs = rng.integers(0, 2 ** 28, (4, 1, 25, 25), dtype=np.int32)
    obs[1] = fill
    bases = np.full((4, 1), base, np.int32)
    jcheck = jnp.asarray(obs).reshape(4, 1, -1).sum(axis=-1, dtype=jnp.int32)
    jact = (jnp.asarray(bases) + jcheck) % 9
    exact = obs.astype(np.int64).reshape(4, 1, -1).sum(-1)
    assert exact[1, 0] >= 2 ** 31 or exact[1, 0] < -2 ** 31
    check = TB.checksum(torch.as_tensor(obs))
    actions = TB.fold_actions(torch.as_tensor(bases), check)
    assert check.dtype == torch.int32 and actions.dtype == torch.int32
    np.testing.assert_array_equal(check.numpy(), np.asarray(jcheck))
    np.testing.assert_array_equal(actions.numpy(), np.asarray(jact))
    assert ((actions >= 0) & (actions < 9)).all()


def test_verb_prints_one_line_and_both_modes(tmp_path):
    """``python -m safelife_tpu_torch bench --device cpu``: exactly one
    stdout line with the JAX bench's keys and metric format, and a sidecar
    with both modes, their set-up times and no launches (the CPU runs the
    kernels' plain versions)."""
    sidecar = tmp_path / "modes.json"
    out = subprocess.run(
        [sys.executable, "-m", "safelife_tpu_torch", "bench", "--device",
         "cpu", "--batch", "8", "--scan", "5", "--reps", "2", "--sidecar",
         str(sidecar)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    head = json.loads(lines[0])
    assert sorted(head) == ["metric", "unit", "value", "vs_baseline"]
    jb = _jax_bench()
    assert TB.OBS_DESC == jb.OBS_DESC
    assert TB.REFERENCE_BASELINE_STEPS_PER_S == \
        jb.REFERENCE_BASELINE_STEPS_PER_S
    assert head["metric"] == "env-steps/s/chip (append-still, batch 8, %s)" \
        % jb.OBS_DESC["packed"]
    assert head["unit"] == "env-steps/s" and head["value"] > 0
    assert head["vs_baseline"] == round(head["value"] / 1e4, 2)
    modes = json.loads(sidecar.read_text())
    assert sorted(modes) == ["channels", "packed"]
    for mode, r in modes.items():
        assert r["steps"] == 8 * 5 * 2
        assert r["warmup_s"] > 0 and r["build_s"] >= 0
        assert r["launches"] == {} and r["reset_launches"] == {}
        assert r["device"] == "cpu"
    assert modes["packed"]["value"] == head["value"]
    assert "reward checksum" in out.stderr


def test_verb_refuses(monkeypatch):
    """An unknown ``--obs`` is refused before any work (and an unknown
    mode by the loop itself); the default device raises without a card,
    as every entry point of the port does."""
    with pytest.raises(SystemExit):
        TB.main(["--obs", "pixels", "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown obs mode"):
        TB.env_config("pixels")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TB.main([])
    from safelife_tpu_torch import __main__ as CLI
    with pytest.raises(RuntimeError, match="is_available"):
        CLI.main(["bench", "--one-mode"])
    with pytest.raises(FileNotFoundError):
        TB.load_pool("cpu", path=os.path.join(ROOT, "no-such-levels.npz"))
