"""The port's ``registry.make`` against the JAX package's, on the CPU: the
same eight names, equal level pools for equal seeds (the generated levels
are byte-identical), equal reset observations (lane i on level i mod 16)
and then equal boards, observations, rewards and done flags step for step,
bit for bit: with ``auto_reset=False``, or until the first lane finishes
(auto-reset draws from each package's own random stream)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402, F401  (JAX on the CPU before the JAX registry)

from safelife_tpu import registry as JR  # noqa: E402
from safelife_tpu_torch import registry as TR  # noqa: E402

LANES = 6
#: Tensor fields of both packages' level pools.
POOL_FIELDS = ("board", "goals", "agent_locs", "agent_mask", "points_table",
               "min_performance", "spawn_prob", "initial_counts",
               "initial_colors", "exit_mask", "exit_locs", "exit_locs_valid",
               "goals_static", "table_flat", "init_points",
               "required_points", "available_points")


@pytest.fixture(scope="module")
def still_envs():
    """append-still, seed 3, no auto-reset, in both packages."""
    return (JR.make("safelife-append-still-v1", batch_size=LANES, seed=3,
                    auto_reset=False),
            TR.make("safelife-append-still-v1", batch_size=LANES, seed=3,
                    device="cpu", auto_reset=False))


def test_registered_names():
    assert sorted(TR.ENV_REGISTRY) == sorted(JR.ENV_REGISTRY)
    assert len(TR.ENV_REGISTRY) == 8
    for name, spec in JR.ENV_REGISTRY.items():
        assert TR.ENV_REGISTRY[name] == spec
    for make in (JR.make, TR.make):
        with pytest.raises(KeyError, match="unknown environment"):
            make("safelife-nonesuch-v1")
    with pytest.raises(KeyError):
        TR.make("safelife-nonesuch-v1", device="cpu")


def assert_pools_equal(jenv, tenv):
    for f in POOL_FIELDS:
        np.testing.assert_array_equal(
            getattr(tenv.pool, f).numpy(), np.asarray(getattr(jenv.pool, f)),
            err_msg=f)
    assert tenv.pool.all_goals_static == bool(jenv.pool.all_goals_static)
    assert tenv.pool.spawner_free == bool(jenv.pool.spawner_free)
    assert tenv.num_agents == jenv.num_agents


def assert_step_equal(jout, tout, t):
    for name, a, b in zip(("obs", "reward", "done"), jout, tout):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg="%s step %d" % (name, t))


def test_make_against_jax_without_auto_reset(still_envs):
    """20 steps of the same random actions: NumPy [B] rows, NumPy [B, 1]
    and torch tensors, all equal to JAX's, bit for bit."""
    jenv, tenv = still_envs
    assert_pools_equal(jenv, tenv)
    assert tenv.pool.num_levels == 16 and tenv.device.type == "cpu"
    with pytest.raises(RuntimeError, match="reset"):
        tenv.step(np.zeros(LANES, np.int32))
    jobs, tobs = jenv.reset(), tenv.reset()
    assert tobs.dtype == torch.uint8 and tobs.shape == (LANES, 1, 25, 25, 19)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    rng = np.random.default_rng(0)
    for t in range(20):
        a = rng.integers(0, 9, LANES).astype(np.int32)
        given = (a, a[:, None], torch.from_numpy(a))[t % 3]
        jout = jenv.step(a)
        tout = tenv.step(given)
        assert_step_equal(jout, tout, t)
        np.testing.assert_array_equal(tenv.state.board.numpy(),
                                      np.asarray(jenv.state.board))
        np.testing.assert_array_equal(tenv.state.agent_locs.numpy(),
                                      np.asarray(jenv.state.agent_locs))
        for key in ("lane_done", "success", "episode_reward"):
            np.testing.assert_array_equal(tout[3][key].numpy(),
                                          np.asarray(jout[3][key]))
    for lane in (0, LANES - 1):
        assert tenv.render(lane) == jenv.render(lane)


def test_make_against_jax_until_the_first_lane_finishes():
    """prune-still with auto-reset and a 5-step limit: every step up to
    and with the first finish equal (rewards and done flags of that step
    too); then each lane was reset on a level of its own stream's
    choosing."""
    envs = [mk("safelife-prune-still-v1", batch_size=LANES, seed=11,
               time_limit=5, **kw)
            for mk, kw in ((JR.make, {}), (TR.make, {"device": "cpu"}))]
    jenv, tenv = envs
    assert_pools_equal(jenv, tenv)
    np.testing.assert_array_equal(tenv.reset().numpy(),
                                  np.asarray(jenv.reset()))
    rng = np.random.default_rng(1)
    for t in range(5):
        a = rng.integers(0, 9, LANES)
        jout, tout = jenv.step(a), tenv.step(a)
        if t < 4:
            assert_step_equal(jout, tout, t)
        else:
            for a, b in zip(jout[1:3], tout[1:3]):  # reward, done
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert bool(tout[2].all())
    assert (tenv.state.num_steps == 0).all()
    assert tenv.state.level_idx.min() >= 0 and \
        tenv.state.level_idx.max() < 16
