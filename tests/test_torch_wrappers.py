"""The port's reward-shaping wrappers (``env/wrappers.py``) against
``W.step`` of the JAX package, on the CPU: integer state bit for bit, shaped
rewards within 1e-6, on generated 12x12 levels and shipped 26x26 ones.

Pools hold one level, so that an auto-reset lands on the same level
whatever the two packages' random draws, and no level has spawners."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu.core import cells as C  # noqa: E402
from safelife_tpu.env import env as JE, state as JST  # noqa: E402
from safelife_tpu.env import wrappers as JW  # noqa: E402
from safelife_tpu.io import levels as JL  # noqa: E402
from safelife_tpu_torch.env import env as TE, state as TST  # noqa: E402
from safelife_tpu_torch.env import wrappers as TW  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402

STATE_FIELDS = (
    "board", "goals", "agent_locs", "num_steps", "old_value",
    "episode_reward", "episode_length", "is_active", "level_idx",
    "min_perf_fraction")
WRAPPER_FIELDS = ("prior_positions", "prior_count", "last_side_effect",
                  "baseline_board", "episode_start_board")


def _level_12x12(seed=3):
    """Open 12x12 level: live (black and red) cells, coloured goals, an
    exit two cells right of the agent, open from the start."""
    rng = np.random.default_rng(seed)
    board = np.zeros((12, 12), np.int32)
    alive = rng.random((12, 12)) < 0.25
    board |= alive * (C.ALIVE | C.DESTRUCTIBLE)
    board |= alive * (rng.random((12, 12)) < 0.4) * C.COLOR_R
    board |= (rng.random((12, 12)) < 0.05) * (C.PUSHABLE | C.PULLABLE)
    goals = ((rng.random((12, 12)) < 0.3)
             * (rng.integers(1, 8, (12, 12)) << C.COLOR_BIT))
    goals[2:5, 2:5] = C.COLOR_B
    board[6, 5:9] = 0
    board[6, 6] = C.PLAYER
    board[6, 8] = C.LEVEL_EXIT
    return dict(board=board, goals=goals.astype(np.int32),
                agent_locs=np.array([[6, 6]]), min_performance=-1.0)


def _pools(source):
    if source == "12x12":
        data = _level_12x12()
        return (JST.pack_levels([JL.level_from_data(data)]),
                TST.pack_levels([TL.level_from_data(data)], device="cpu"))
    path, i = source
    return (JST.pack_levels(JL.load_levels(path)[i:i + 1]),
            TST.pack_levels(TL.load_levels(path)[i:i + 1], device="cpu"))


PRUNE = ("benchmarks/v1.0/prune-dynamic.npz", 3)
COOP = ("benchmarks/multi-agent-v1/multi-build-coop.npz", 0)

#: name -> (level, WrapperConfig fields, view, time limit, auto-reset,
#: se_penalty_coef, min_perf_fraction, whether lane 0 walks to the exit).
CASES = {
    "12x12-starting-state": (
        "12x12", {}, (9, 9), 5, True, 1.0, 1.0, True),
    "12x12-inaction-ignore-reward-cells": (
        "12x12", dict(se_baseline="inaction", ignore_reward_cells=True),
        (9, 9), 5, True, 0.5, 1.0, True),
    "12x12-continuing-exhaustive-se": (
        "12x12", dict(continuing=True, exhaustive_se=True,
                      ignore_reward_cells=True), (9, 9), 5, True, 1.0, 0.5,
        True),
    "12x12-bonus-power-period-3": (
        "12x12", dict(movement_as_penalty=False, movement_bonus_power=0.5,
                      movement_bonus_period=3, se_baseline="inaction"),
        (9, 9), 5, True, 2.0, 1.0, True),
    "12x12-disabled": (
        "12x12", dict(enabled=False), (9, 9), 5, True, 1.0, 1.0, True),
    "26x26-prune-dynamic-inaction": (
        PRUNE, dict(se_baseline="inaction"), (25, 25), 6, True, 1.0, 0.0,
        False),
    "26x26-prune-dynamic-ignore-reward-cells-no-reset": (
        PRUNE, dict(ignore_reward_cells=True, continuing=True), (15, 15), 6,
        False, 1.0, 1.0, False),
    "26x26-multi-agent-per-agent-bonus": (
        COOP, dict(single_agent=False, se_baseline="inaction"), (15, 15), 6,
        True, 1.0, 1.0, False),
    "26x26-multi-agent-single-agent-bonus": (
        COOP, dict(ignore_reward_cells=True), (15, 15), 6, True, 1.0, 1.0,
        False),
}


def _eq(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _wrapped_eq(ts, js, what):
    for name in STATE_FIELDS:
        _eq(getattr(ts.env, name), getattr(js.env, name),
            "%s: env.%s" % (what, name))
    for name in WRAPPER_FIELDS:
        _eq(getattr(ts, name), getattr(js, name), "%s: %s" % (what, name))


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapped_step_matches_jax(case):
    source, wkw, view, time_limit, auto_reset, coef, mpf, walk = CASES[case]
    jpool, tpool = _pools(source)
    assert tpool.spawner_free
    b, a, steps = 4, tpool.num_agents, 12
    kw = dict(view_shape=view, output_channels=None, time_limit=time_limit,
              auto_reset=auto_reset)
    jcfg, tcfg = JE.EnvConfig(**kw), TE.EnvConfig(**kw)
    jw, tw = JW.WrapperConfig(**wkw), TW.WrapperConfig(**wkw)
    # Lanes start at fraction 1; a fresh lane takes the step's fraction.
    js, jobs = JW.reset(jcfg, jw, jpool, jax.random.PRNGKey(0), b)
    ts, tobs = TW.reset(tcfg, tw, tpool, b, device="cpu")
    _wrapped_eq(ts, js, "reset")
    _eq(tobs, jobs, "reset obs")

    rng = np.random.default_rng(4)
    gen = torch.Generator().manual_seed(0)
    ended_by_exit = ended_by_time = False
    for t in range(steps):
        acts = rng.integers(0, 9, (b, a)).astype(np.int32)
        if walk:
            acts[0] = 2  # lane 0 walks right, onto the exit at step 2
        js, jobs, jr, jd, jinfo = JW.step(
            jcfg, jw, jpool, js, jnp.asarray(acts), jax.random.PRNGKey(t),
            coef, mpf)
        ts, tobs, tr, td, tinfo = TW.step(
            tcfg, tw, tpool, ts, torch.from_numpy(acts), gen, coef, mpf)
        what = "%s step %d" % (case, t)
        _wrapped_eq(ts, js, what)
        _eq(tobs, jobs, what + ": obs")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=1e-6, err_msg=what + ": reward")
        _eq(td, jd, what + ": done")
        assert set(tinfo) == set(jinfo)
        for k in jinfo:
            if k == "ep_sample":
                assert set(tinfo[k]) == set(jinfo[k])
                for s in jinfo[k]:
                    _eq(tinfo[k][s], jinfo[k][s], "%s: ep_sample[%s]"
                        % (what, s))
            else:
                _eq(tinfo[k], jinfo[k], "%s: info[%s]" % (what, k))
        lane_done = tinfo["lane_done"].numpy()
        times_up = tinfo["times_up"].numpy()
        ended_by_exit |= bool((lane_done & ~times_up).any())
        ended_by_time |= bool((lane_done & times_up).any())
    if auto_reset:
        assert ended_by_time
    if walk:
        assert ended_by_exit


def test_wrapper_config_matches_jax():
    assert [f.name for f in dataclasses.fields(TW.WrapperConfig)] == \
        [f.name for f in dataclasses.fields(JW.WrapperConfig)]
    assert dataclasses.asdict(TW.WrapperConfig()) == \
        dataclasses.asdict(JW.WrapperConfig())


def test_merge_lane_reset_recurses_into_wrapped_state():
    """A wrapped state merges field by field, the env state's too."""
    _, tpool = _pools(PRUNE)
    cfg = TE.EnvConfig(view_shape=(9, 9), output_channels=None)
    wcfg = TW.WrapperConfig()
    ws, _ = TW.reset(cfg, wcfg, tpool, 3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        ws, *_ = TW.step(cfg, wcfg, tpool, ws,
                         torch.full((3, 1), 2, dtype=torch.int32), gen)
    lane_done = torch.tensor([True, False, True])
    fresh = TW._fresh_wrapped(cfg, wcfg, tpool, torch.zeros(3).long(), 1.0)
    merged = TE.merge_lane_reset(lane_done, None, lambda _: fresh, ws)
    assert isinstance(merged, TW.WrappedState)
    assert isinstance(merged.env, TST.EnvState)
    for name in WRAPPER_FIELDS:
        got, old, new = (getattr(x, name) for x in (merged, ws, fresh))
        assert torch.equal(got[1], old[1]) and torch.equal(got[0], new[0])
    for name in STATE_FIELDS:
        got, old, new = (getattr(x.env, name) for x in (merged, ws, fresh))
        assert torch.equal(got[1], old[1]) and torch.equal(got[2], new[2])
    assert merged.prior_count.tolist() == [1, 3, 1]
