"""The port's multi-process training (``safelife_tpu_torch/parallel/mesh.py``
and the sharded env, PPO, DQN and level pool) on the CPU over ``gloo``:
an R-rank run with global batch B equals the one-process run with batch
B (integer state bit for bit, the learner within 1e-5, its parameters
bitwise equal on every rank), and the one-process port equals the JAX
package (its level streams, its step physics under the same spawn coins,
its sharded PPO iteration on the virtual 8-device mesh). Rank processes
start with the ``spawn`` method, each under a time limit
(``torch_ranks.run_ranks``)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks as R  # noqa: E402
from safelife_tpu.core import actions as JAC, advance as JADV  # noqa: E402
from safelife_tpu.core import scoring as JSC  # noqa: E402
from safelife_tpu.env import env as JE, state as JST  # noqa: E402
from safelife_tpu.env import wrappers as JW  # noqa: E402
from safelife_tpu.io.levels import Level as JLevel  # noqa: E402
from safelife_tpu.models import nets as JN  # noqa: E402
from safelife_tpu.parallel import mesh as JM  # noqa: E402
from safelife_tpu.training import ppo as JP  # noqa: E402
from safelife_tpu_torch import ops as TOPS  # noqa: E402
from safelife_tpu_torch.env import wrappers as TW  # noqa: E402
from safelife_tpu_torch.env.state import pack_levels  # noqa: E402
from safelife_tpu_torch.io.iterator import LevelPoolManager  # noqa: E402
from safelife_tpu_torch.models.convert import (  # noqa: E402
    policy_params_from_flax)
from safelife_tpu_torch.ops import physics as P  # noqa: E402
from safelife_tpu_torch.parallel import mesh as M  # noqa: E402
from safelife_tpu_torch.training import dqn as TD, ppo as TP  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 20260816, np.random.SeedSequence(7)])
def test_per_host_seed_matches_jax(seed):
    for rank in range(4):
        got = M.per_host_seed(seed, rank)
        ref = JM.per_host_seed(seed, rank)
        assert got.spawn_key == ref.spawn_key
        np.testing.assert_array_equal(got.generate_state(8),
                                      ref.generate_state(8))


def test_lane_range_and_draw_global():
    assert M.lane_range(8, 1, 4) == (2, 4, 8)
    with pytest.raises(ValueError, match="must divide over 3"):
        M.lane_range(8, 0, 3)
    whole = torch.rand((8 * 3, 9), generator=torch.Generator().manual_seed(1))
    lanes = M.lane_range(8, 2, 4)
    part = M.draw_global(lambda s: torch.rand(
        s, generator=torch.Generator().manual_seed(1)), (2 * 3, 9), lanes)
    assert torch.equal(part, whole[12:18])


def test_world_size_one_is_a_no_op(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert M.initialize_distributed(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    assert M.training_group() is None and M.is_logging_host()
    pool = pack_levels(R.pool_levels(0)[:2], device="cpu")
    assert M.allgather_level_pool(pool) is pool
    tree = {"x": torch.arange(4)}
    assert M.gather_episodes(tree) is tree
    x = torch.arange(4.0, requires_grad=True) * 2
    summed = M.all_reduce_sum(x)
    assert torch.equal(summed, x) and not summed.requires_grad
    assert M.all_gather(x) == [x]
    assert M.all_gather_object({"a": 1}) == [{"a": 1}]
    net = torch.nn.Linear(3, 2)
    net(torch.ones(1, 3)).sum().backward()
    grads = [p.grad.clone() for p in net.parameters()]
    assert M.allreduce_grads(net) is net and M.broadcast_grads(net) is net
    assert all(torch.equal(p.grad, g)
               for p, g in zip(net.parameters(), grads))
    with pytest.raises(ValueError, match="no rank"):
        M.initialize_distributed(world_size=2, device="cpu")


_FAILING_START = r"""
import sys
from safelife_tpu_torch.parallel import mesh as M
port = int(sys.argv[1])
try:
    M.initialize_distributed(rank=1, world_size=2, device="cpu", timeout=3,
                             init_method="tcp://127.0.0.1:%d" % port)
except Exception as exc:
    print("raised", type(exc).__name__)
else:
    print("started")
"""


def test_configured_group_that_cannot_start_raises():
    # Rank 1 of 2, with nobody serving the store: the start times out.
    out = subprocess.run(
        [sys.executable, "-c", _FAILING_START, str(R.free_port())], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.stdout.startswith("raised"), out.stdout + out.stderr


# ---------------------------------------------------------------------------
# The wrapped env step


ENV_LANES, ENV_STEPS = 8, 20


def _one_process_env(actions, seed, record=None):
    """The one-process run of ``torch_ranks.env_rollout``; ``record``
    collects every K1 call's inputs and outputs."""
    cfg, wcfg, pool = R.env_setup()
    ws, obs = TW.reset(cfg, wcfg, pool, ENV_LANES, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    out = {"board": [], "obs": [obs.numpy()], "reward": [], "done": [],
           "baseline": []}
    real = TOPS.fused_actions_advance
    if record is not None:
        def spy(*args, **kw):
            got = real(*args, **kw)
            record.append(([a.clone() for a in args], kw, got))
            return got
        TOPS.fused_actions_advance = spy
    try:
        for t in range(ENV_STEPS):
            ws, obs, reward, done, _ = TW.step(
                cfg, wcfg, pool, ws, torch.from_numpy(actions[t]), gen)
            out["board"].append(ws.env.board.numpy())
            out["baseline"].append(ws.baseline_board.numpy())
            out["obs"].append(obs.numpy())
            out["reward"].append(reward.numpy())
            out["done"].append(done.numpy())
    finally:
        TOPS.fused_actions_advance = real
    return {k: np.stack(v) for k, v in out.items()}, pool


def test_sharded_env_steps_equal_one_process_and_jax():
    """20 wrapped steps of 8 lanes with spawners, the inaction baseline and
    auto-resets: 2 and 4 ranks equal one process bit for bit, and each
    step's physics of the one-process port equals JAX's (actions, then
    the CA step under the port's Philox coins, then the agents' cells)."""
    actions = np.random.default_rng(5).integers(
        0, 9, (ENV_STEPS, ENV_LANES, 1)).astype(np.int32)
    record = []
    ref, pool = _one_process_env(actions, 11, record)
    assert not pool.spawner_free
    assert ref["done"].any()  # lanes reset mid-run
    for world in (2, 4):
        parts = R.run_ranks(R.env_rollout, world, ENV_LANES, ENV_STEPS, 11,
                            actions)
        for key in ref:
            got = np.concatenate([p[key] for p in parts], axis=1)
            np.testing.assert_array_equal(
                got, ref[key], err_msg="%s, %d ranks" % (key, world))

    assert len(record) == ENV_STEPS
    for args, kw, (board, locs, cells) in record:
        b0, locs0, acts, sp, seed = (a.numpy() for a in args)
        b, h, w = b0.shape[0], kw["h"], kw["w"]
        coins = P.spawn_coins(torch.from_numpy(seed), torch.from_numpy(sp),
                              b, h * w).numpy().reshape(b, h, w)
        grid, jlocs = jax.vmap(JAC.execute_actions)(
            jnp.asarray(b0.reshape(b, h, w)), jnp.asarray(locs0),
            jnp.asarray(acts))
        grid = JADV.advance_board_given_spawns(grid, jnp.asarray(coins))
        np.testing.assert_array_equal(board.numpy().reshape(b, h, w),
                                      np.asarray(grid))
        np.testing.assert_array_equal(locs.numpy(), np.asarray(jlocs))
        np.testing.assert_array_equal(
            cells.numpy(), np.asarray(JSC.agent_cells(grid, jlocs)))


# ---------------------------------------------------------------------------
# PPO


PPO_LANES, PPO_STEPS = 16, 4


def _jax_sharded_iteration(ppo_kwargs):
    """JAX's train_iteration on the virtual 8-device mesh in the set-up of
    its ``tests/test_parallel.py:51-90``, and the actions [T, B, A] and
    permutations it drew."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")
    mesh = JM.make_mesh(8)
    pool = JST.pack_levels([JLevel(**d) for d in R.crafted_arrays(2)])
    env_cfg = JE.EnvConfig(view_shape=(25, 25),
                           output_channels=tuple(range(15)),
                           time_limit=16, goals_may_evolve=False)
    wcfg = JW.WrapperConfig()
    cfg = JP.PPOConfig(**ppo_kwargs)
    ws, obs = JW.reset(env_cfg, wcfg, pool, jax.random.PRNGKey(0),
                       PPO_LANES)
    model = JN.SafeLifePolicyNetwork()
    params = model.init(jax.random.PRNGKey(1),
                        np.zeros((1, 25, 25, 15), np.float32))
    pstate = JP.init_ppo_state(cfg, params)
    key = jax.random.PRNGKey(2)
    krol, ktrain = jax.random.split(key)
    traj, _, _ = JP.rollout(env_cfg, wcfg, pool, model.apply, params, ws,
                            obs, krol, PPO_STEPS)
    with mesh:
        p2, _, _, m2 = JP.train_iteration(
            env_cfg, wcfg, cfg, model.apply, JM.replicate(pool, mesh),
            JM.replicate(pstate, mesh), JM.shard_env_state(ws, mesh),
            JM.shard_env_state(obs, mesh), key)
    actions = np.asarray(traj["actions"]).reshape(PPO_STEPS, PPO_LANES, -1)
    n = actions.size
    perms = []
    for _ in range(cfg.epochs_per_batch):
        ktrain, kshuf = jax.random.split(ktrain)
        perms.append(np.array(jax.random.permutation(kshuf, n)))
    return (jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, p2.params), m2, actions, perms)


@pytest.mark.parametrize("entropy_clip, num_minibatches, epochs", [
    (1.0, 4, 3), (10.0, 0, 1)], ids=["clamp-binds", "clamp-free"])
def test_sharded_ppo_iteration_matches_jax_mesh(entropy_clip,
                                                num_minibatches, epochs):
    """Two ranks of 8 lanes against JAX's iteration on the 8-device mesh
    with its actions and permutations: parameters within 1e-5 of JAX's and
    of the one-process port's, bitwise equal on both ranks; the metrics
    within 1e-5 relative. At the default clip of 1.0 the entropy mean
    (about ln 9 for these near-uniform policies) is clamped: 3 epochs of 5
    minibatches. At 10.0 it is not, and the entropy gradient nearly
    cancels the policy gradient in many elements, so after the first Adam
    step float32 rounding flips the sign of learning-rate-sized steps
    there: that case takes one Adam step on the whole global batch."""
    kwargs = dict(steps_per_env=PPO_STEPS, entropy_clip=entropy_clip,
                  num_minibatches=num_minibatches, epochs_per_batch=epochs)
    params, jparams, jm, actions, perms = _jax_sharded_iteration(kwargs)
    ranks = R.run_ranks(R.ppo_iteration, 2, PPO_LANES,
                        policy_params_from_flax(params), actions, perms,
                        kwargs)
    # One process, the same draws.
    cfg, wcfg, pool, net = R.ppo_setup()
    net.load_state_dict(policy_params_from_flax(params))
    pcfg = TP.PPOConfig(**kwargs)
    ps = TP.init_ppo_state(pcfg, net, device="cpu")
    ws, obs = TW.reset(cfg, wcfg, pool, PPO_LANES, device="cpu")
    ps, ws, _, m1 = TP.train_iteration(
        cfg, wcfg, pcfg, pool, ps, ws, obs, torch.Generator(),
        actions=torch.from_numpy(actions.copy()), perms=perms, device="cpu")

    ref = policy_params_from_flax(jparams)
    one = net.state_dict()
    for name in ref:
        a, b = ranks[0]["params"][name], ranks[1]["params"][name]
        np.testing.assert_array_equal(a, b, err_msg="ranks differ: " + name)
        np.testing.assert_allclose(a, ref[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg="vs JAX: " + name)
        np.testing.assert_allclose(a, one[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg="vs one process: " + name)
    np.testing.assert_array_equal(
        np.concatenate([r["board"] for r in ranks]), ws.env.board.numpy())
    for r in ranks:
        assert r["num_steps"] == ps.num_steps == PPO_STEPS * PPO_LANES
        assert r["metrics"] == ranks[0]["metrics"]
        for k in ("loss", "policy_loss", "value_loss", "entropy",
                  "reward_mean", "values_mean", "advantages_mean"):
            np.testing.assert_allclose(r["metrics"][k], float(m1[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(r["metrics"][k], float(jm[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert (float(m1["entropy"]) > entropy_clip) == (entropy_clip == 1.0)


# ---------------------------------------------------------------------------
# DQN


DQN_LANES = 4
DQN_KW = dict(replay_size=64, replay_initial=24, batch_size=8,
              target_update_interval=16)


def test_sharded_dqn_replay_equals_one_process():
    """Ten units of two steps over two ranks of two lanes: every rank's
    replay equals the one-process replay bit for bit (the pushes wrap the
    64-entry buffer), and the parameters, which moved, are bitwise equal
    on both ranks and equal to the one-process ones."""
    units, steps, seed = 10, 2, 9
    ranks = R.run_ranks(R.dqn_units, 2, DQN_LANES, units, steps, seed,
                        DQN_KW)
    cfg, wcfg, pool, net, obs_shape, obs_dtype = R.dqn_setup()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    dcfg = TD.DQNConfig(**DQN_KW)
    ds = TD.init_dqn_state(dcfg, net, DQN_LANES * pool.num_agents,
                           obs_shape, obs_dtype, device="cpu")
    ws, obs = TW.reset(cfg, wcfg, pool, DQN_LANES, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for _ in range(units):
        ds, ws, obs, _ = TD.collect_and_optimize(cfg, wcfg, dcfg, pool, ds,
                                                 ws, obs, gen, steps,
                                                 device="cpu")
    assert ds.replay.idx > dcfg.replay_size  # wrapped
    for r in ranks:
        assert r["idx"] == ds.replay.idx
        assert r["num_steps"] == ds.num_steps == units * steps * DQN_LANES
        for k, v in r["replay"].items():
            np.testing.assert_array_equal(
                v, getattr(ds.replay, k).numpy(), err_msg=k)
    moved = False
    for name, p in net.state_dict().items():
        np.testing.assert_array_equal(ranks[0]["params"][name],
                                      ranks[1]["params"][name],
                                      err_msg=name)
        np.testing.assert_array_equal(ranks[0]["params"][name], p.numpy(),
                                      err_msg=name)
        moved |= not torch.equal(p, before[name])
    assert moved


# ---------------------------------------------------------------------------
# The level pool


def test_pool_manager_gathers_and_guards_busy_slots():
    """Two ranks of four slots: the pool is the concatenation of the
    ranks' pools with their flags ANDed; rank 0's refresh skips its slot
    0, on which a lane of rank 1 is, and both ranks see the new level and
    its name."""
    ranks = R.run_ranks(R.pool_manager, 2)
    levels = [R.pool_levels(r)[:4] for r in range(2)]
    whole = pack_levels(levels[0] + levels[1], device="cpu")
    for r in ranks:
        for k, v in r["before"].items():
            np.testing.assert_array_equal(v, getattr(whole, k).numpy(), k)
        assert r["flags"] == (whole.all_goals_static, whole.spawner_free)
        assert r["flags"][1] is False  # rank 1's spawners
        assert r["meta"] == ranks[0]["meta"]
        assert [r["meta"][i]["name"] for i in range(8)] == [
            lv.name for lv in levels[0] + levels[1]]
    assert [r["swapped"] for r in ranks] == [1, 0]
    new = R.pool_levels(0)[4]
    for r in ranks:
        after = r["after"]
        np.testing.assert_array_equal(after[0], whole.board[0].numpy())
        np.testing.assert_array_equal(after[1], new.board)
        np.testing.assert_array_equal(after[2:], whole.board[2:].numpy())
        assert r["meta_after"][1]["name"] == new.name
        assert r["meta_after"][0] == r["meta"][0]


def test_pool_manager_one_process_unchanged():
    """In one process the manager is the one it was: its pool is
    ``pack_levels`` of its levels."""
    levels = R.pool_levels(0)
    mgr = LevelPoolManager(iter(levels), pool_size=4, device="cpu")
    ref = pack_levels(levels[:4], device="cpu")
    assert torch.equal(mgr.pool.board, ref.board)
    assert mgr._local_pool is mgr.pool
    assert mgr.refresh(1, in_use=[0]) == 1
    assert torch.equal(mgr.pool.board[1], torch.from_numpy(levels[4].board))
