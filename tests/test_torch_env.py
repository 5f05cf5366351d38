"""The port's environment (pack_levels, reset, step, merge_lane_reset)
against the JAX package's on shipped benchmark levels, on the CPU: integer
state, observations, rewards, done flags and info bit for bit."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu.core import cells as C  # noqa: E402
from safelife_tpu.env import env as JE, state as JST  # noqa: E402
from safelife_tpu.io import levels as JL  # noqa: E402
from safelife_tpu_torch.env import env as TE, state as TST  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402

ARCHIVES = {
    "append-still": "benchmarks/v1.0/append-still.npz",
    "prune-dynamic": "benchmarks/v1.0/prune-dynamic.npz",
    "multi-build-coop": "benchmarks/multi-agent-v1/multi-build-coop.npz",
}
POOL_FIELDS = (
    "board", "goals", "agent_locs", "agent_mask", "points_table",
    "min_performance", "spawn_prob", "exit_mask", "exit_locs",
    "exit_locs_valid", "goals_static", "initial_counts", "initial_colors",
    "table_flat", "init_points", "required_points", "available_points",
    "reset_boards", "reset_old_value")
STATE_FIELDS = (
    "board", "goals", "agent_locs", "num_steps", "old_value",
    "episode_reward", "episode_length", "is_active", "level_idx",
    "min_perf_fraction")


def _pools(task, n=6):
    path = ARCHIVES[task]
    jl = JL.load_levels(path)[:n]
    tl = TL.load_levels(path)[:n]
    return JST.pack_levels(jl), TST.pack_levels(tl, device="cpu")


def _eq(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize("task", sorted(ARCHIVES))
def test_pack_levels_fields(task):
    jpool, tpool = _pools(task)
    for name in POOL_FIELDS:
        _eq(getattr(tpool, name), getattr(jpool, name), name)
    assert tpool.all_goals_static == jpool.all_goals_static
    assert tpool.spawner_free == jpool.spawner_free


def test_level_loader_reads_old_format():
    jl = JL.load_levels(ARCHIVES["prune-dynamic"])
    tl = TL.load_levels(ARCHIVES["prune-dynamic"])
    assert len(tl) == len(jl) == 100
    for a, b in zip(jl[:10], tl[:10]):
        assert a.name == b.name
        np.testing.assert_array_equal(a.board, b.board)
        np.testing.assert_array_equal(a.agent_locs, b.agent_locs)
        np.testing.assert_array_equal(a.points_table, b.points_table)


def _state_eq(ts, js):
    for name in STATE_FIELDS:
        _eq(getattr(ts, name), getattr(js, name), name)


@pytest.mark.parametrize("task", sorted(ARCHIVES))
def test_rollout_matches_jax(task):
    jpool, tpool = _pools(task)
    b, a, steps = 8, tpool.num_agents, 30
    kw = dict(view_shape=(15, 15), output_channels=None, time_limit=25,
              auto_reset=False)
    jcfg, tcfg = JE.EnvConfig(**kw), TE.EnvConfig(**kw)
    jstate, jobs = JE.reset(jcfg, jpool, jax.random.PRNGKey(0), b)
    tstate, tobs = TE.reset(tcfg, tpool, b)
    _state_eq(tstate, jstate)
    _eq(tobs, jobs, "reset obs")
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    unpack_j = JE.EnvConfig(view_shape=(15, 15))
    unpack_t = TE.EnvConfig(view_shape=(15, 15))
    for t in range(steps):
        acts = rng.integers(0, 9, (b, a)).astype(np.int32)
        jstate, jobs, jr, jd, jinfo = JE.step(
            jcfg, jpool, jstate, jnp.asarray(acts), jax.random.PRNGKey(t))
        tstate, tobs, tr, td, tinfo = TE.step(
            tcfg, tpool, tstate, torch.from_numpy(acts), gen)
        _state_eq(tstate, jstate)
        _eq(tobs, jobs, "packed obs, step %d" % t)
        _eq(TE.unpack_view_channels(unpack_t, tobs),
            JE.unpack_view_channels(unpack_j, jobs), "uint8 obs")
        _eq(tr, jr, "reward, step %d" % t)
        _eq(td, jd, "done, step %d" % t)
        assert set(tinfo) == set(jinfo)
        for k in jinfo:
            _eq(tinfo[k], jinfo[k], "info[%s], step %d" % (k, t))
    # The rollout reached episode ends (time limit or exits).
    assert bool(tstate.num_steps.max() >= 25)


def test_merge_lane_reset_injected_indices():
    jpool, tpool = _pools("prune-dynamic")
    b = 8
    kw = dict(view_shape=(15, 15), output_channels=None, auto_reset=False)
    jcfg, tcfg = JE.EnvConfig(**kw), TE.EnvConfig(**kw)
    # Fraction 0 on some lanes selects the open-exit reset boards.
    mpf = np.array([1.0, 0.0, 0.5, 1.0, 0.0, 1.0, 0.25, 1.0], np.float32)
    jstate = JE.reset_batch(jcfg, jpool, jnp.arange(b) % 6, jnp.asarray(mpf))
    tstate = TE.reset_batch(tcfg, tpool, torch.arange(b) % 6,
                            torch.from_numpy(mpf))
    rng = np.random.default_rng(2)
    gen = torch.Generator().manual_seed(0)
    for t in range(5):
        acts = rng.integers(0, 9, (b, 1)).astype(np.int32)
        jstate, *_ = JE.step(jcfg, jpool, jstate, jnp.asarray(acts),
                             jax.random.PRNGKey(t))
        tstate, *_ = TE.step(tcfg, tpool, tstate, torch.from_numpy(acts),
                             gen)
    lane_done = np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)
    fresh = np.array([5, 4, 3, 2, 1, 0, 5, 4])
    jm = JE.merge_lane_reset(
        jnp.asarray(lane_done), jax.random.PRNGKey(9),
        lambda r: JE.reset_batch(jcfg, jpool, jnp.asarray(fresh, jnp.int32),
                                 jstate.min_perf_fraction), jstate)
    tm = TE.merge_lane_reset(
        torch.from_numpy(lane_done), torch.from_numpy(fresh),
        lambda r: TE.reset_batch(tcfg, tpool, r, tstate.min_perf_fraction),
        tstate)
    _state_eq(tm, jm)
    _eq(tm.level_idx, np.where(lane_done, fresh, np.arange(b) % 6),
        "level_idx")


@pytest.mark.parametrize("stochastic", [False, True])
def test_advance_batch_matches_jax(stochastic):
    """advance_batch (K2's route for inaction baselines) on boards with
    spawners: exact when deterministic, and at p = 0 and p = 1."""
    levels = TL.load_levels("benchmarks/v1.0/navigation.npz")[:8]
    boards = np.stack([lv.board for lv in levels]).astype(np.int32)
    p = np.array([0.0, 1.0] * 4, np.float32)
    jcfg = JE.EnvConfig(stochastic=stochastic)
    ref = JE.advance_batch(jcfg, jnp.asarray(boards), jnp.asarray(p),
                           jax.random.PRNGKey(0))
    got = TE.advance_batch(torch.from_numpy(boards), torch.from_numpy(p),
                           torch.Generator().manual_seed(0),
                           stochastic=stochastic)
    _eq(got, ref, "advance_batch")


def test_env_config_fields_match_jax():
    """The port keeps JAX's fields and defaults, less the knobs it reads
    from the pool (goals_may_evolve, stochastic) and the TPU-only flat
    observation layout."""
    tnames = [f.name for f in dataclasses.fields(TE.EnvConfig)]
    jnames = [f.name for f in dataclasses.fields(JE.EnvConfig)]
    assert [n for n in jnames if n not in
            ("goals_may_evolve", "stochastic", "flat_obs")] == tnames
    jdef = dataclasses.asdict(JE.EnvConfig())
    assert TE.EnvConfig() == TE.EnvConfig(**{n: jdef[n] for n in tnames})


def _tiny_levels(n=4, seed=7):
    """3x3 levels (one agent, one exit, live cells and blocks, coloured
    goals): the boards where an action's four cells alias."""
    rng = np.random.default_rng(seed)
    data = []
    for _ in range(n):
        board = np.zeros((3, 3), np.int32)
        board |= (rng.random((3, 3)) < 0.3) * (C.ALIVE | C.DESTRUCTIBLE)
        board |= (rng.random((3, 3)) < 0.2) * (C.PUSHABLE | C.PULLABLE)
        board[0, 2] = C.EXIT
        board[1, 1] = C.PLAYER
        goals = ((rng.random((3, 3)) < 0.4)
                 * (rng.integers(1, 8, (3, 3)) << C.COLOR_BIT))
        data.append(dict(board=board, goals=goals.astype(np.int32),
                         agent_locs=np.array([[1, 1]])))
    return ([JL.level_from_data(d) for d in data],
            [TL.level_from_data(d) for d in data])


def test_step_core_tiny_board_matches_jax():
    """step_core (K1's plain version on the CPU, through the aliasing
    actions path), then reset_batch and the 3x3 views, on 3x3 levels."""
    jl, tl = _tiny_levels()
    jpool, tpool = JST.pack_levels(jl), TST.pack_levels(tl, device="cpu")
    b, steps = 8, 12
    kw = dict(view_shape=(3, 3), output_channels=None, time_limit=10,
              auto_reset=False)
    jcfg, tcfg = JE.EnvConfig(**kw), TE.EnvConfig(**kw)
    jstate, jobs = JE.reset(jcfg, jpool, jax.random.PRNGKey(0), b)
    tstate, tobs = TE.reset(tcfg, tpool, b)
    _state_eq(tstate, jstate)
    _eq(tobs, jobs, "reset obs")
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(3)
    for t in range(steps):
        acts = rng.integers(0, 9, (b, 1)).astype(np.int32)
        jstate, jr, jd, _ = JE.step_core(
            jcfg, jpool, jstate, jnp.asarray(acts), jax.random.PRNGKey(t))
        tstate, tr, td, _ = TE.step_core(
            tcfg, tpool, tstate, torch.from_numpy(acts), gen)
        _state_eq(tstate, jstate)
        _eq(tr, jr, "reward, step %d" % t)
        _eq(td, jd, "done, step %d" % t)
        _eq(TE._batch_obs(tcfg, tpool, tstate),
            JE._batch_obs(jcfg, jpool, jstate), "obs, step %d" % t)
