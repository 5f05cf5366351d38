"""Runs a function on the ranks of a ``gloo`` process group on the CPU, one
process a rank, and the rank functions the multi-process tests use.

Each rank is a process of its own, started with the ``spawn`` method; it
joins the group over a local TCP store, caps torch at one thread, runs
``fn(rank, world, *args)`` and returns what it returns (numpy arrays and
Python values). A rank that fails or outlives the time limit fails the
run, and every rank process is ended before :func:`run_ranks` returns.
This module imports torch and the port only, so a rank process never
imports JAX.
"""

import multiprocessing
import queue
import socket
import time
import traceback

import numpy as np


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, args, results):
    import torch

    torch.set_num_threads(1)
    from safelife_tpu_torch.parallel import mesh as M

    try:
        M.initialize_distributed(
            backend="gloo", rank=rank, world_size=world,
            init_method="tcp://127.0.0.1:%d" % port, device="cpu",
            timeout=120)
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_ranks(fn, world, *args, timeout=240):
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    in its own rank process; raises with the rank's traceback if one
    fails, or if the ranks are not done within ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(fn, r, world, port, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        # Drain the queue before joining: a rank blocks on a full pipe.
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("ranks %s not done within %d s" % (
                    sorted(set(range(world)) - set(out)), timeout))
            try:
                rank, ok, value = results.get(timeout=min(left, 5))
            except queue.Empty:
                if not errors and any(p.exitcode not in (None, 0)
                                      for p in procs):
                    raise RuntimeError("a rank process died: exit codes %s"
                                       % [p.exitcode for p in procs])
                continue
            if ok:
                out[rank] = value
            else:
                errors.append("rank %d:\n%s" % (rank, value))
                break
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise AssertionError("\n".join(errors))
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# Set-ups, built alike in every process


def crafted_arrays(n=2, size=(14, 14)):
    """The levels of the JAX package's ``tests/test_parallel.py::_crafted``
    as dicts of arrays (either package builds its ``Level`` from them)."""
    from safelife_tpu_torch.core import cells as C
    from safelife_tpu_torch.core.scoring import DEFAULT_POINTS_TABLE

    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        h, w = size
        board = np.zeros(size, np.int64)
        goals = np.zeros(size, np.int64)
        board |= (rng.random(size) < 0.1) * (C.ALIVE | C.DESTRUCTIBLE)
        goals |= (rng.random(size) < 0.15) * C.COLOR_B
        board[h // 2, w // 2] = C.PLAYER
        board[2, 2] = C.LEVEL_EXIT
        out.append(dict(
            board=board.astype(np.int32), goals=goals.astype(np.int32),
            agent_locs=np.array([[h // 2, w // 2]]),
            agent_names=np.array(["agent0"]),
            points_table=np.tile(DEFAULT_POINTS_TABLE, (1, 1, 1)),
            min_performance=0.1, spawn_prob=0.3, name="p-%d" % seed))
    return out


#: The env run: append-spawn (spawners), packed 15x15 views, episodes of 7
#: steps, the inaction baseline (K2 a step).
ENV_LEVELS = ("benchmarks/v1.0/append-spawn.npz", 3)


def env_setup():
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.io.levels import load_levels

    path, n = ENV_LEVELS
    pool = pack_levels(load_levels(path)[:n], device="cpu")
    cfg = E.EnvConfig(view_shape=(15, 15), output_channels=None,
                      time_limit=7)
    return cfg, W.WrapperConfig(se_baseline="inaction"), pool


def ppo_setup():
    """The JAX package's sharded-iteration set-up (``tests/test_parallel.py
    :51-90``): two crafted 14x14 levels, 25x25 views of 15 channels,
    episodes of 16 steps, the default wrappers."""
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.io.levels import Level
    from safelife_tpu_torch.models.nets import SafeLifePolicyNetwork

    pool = pack_levels([Level(**d) for d in crafted_arrays(2)],
                       device="cpu")
    cfg = E.EnvConfig(view_shape=(25, 25), output_channels=tuple(range(15)),
                      time_limit=16)
    net = SafeLifePolicyNetwork(view_shape=(25, 25), num_channels=15,
                                device="cpu")
    return cfg, W.WrapperConfig(), pool, net


def dqn_setup():
    """Two append-spawn levels, packed 17x17 views, episodes of 5 steps,
    the inaction baseline; the Q network from torch seed 3."""
    import torch

    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.io.levels import load_levels
    from safelife_tpu_torch.models.nets import (SafeLifeQNetwork,
                                                TRAINING_CHANNELS)

    pool = pack_levels(load_levels(ENV_LEVELS[0])[:2], device="cpu")
    cfg = E.EnvConfig(view_shape=(17, 17), output_channels=None,
                      time_limit=5)
    torch.manual_seed(3)
    net = SafeLifeQNetwork(view_shape=(17, 17),
                           unpack_channels=TRAINING_CHANNELS, device="cpu")
    return (cfg, W.WrapperConfig(se_baseline="inaction"), pool, net,
            (17, 17), torch.int32)


def pool_levels(rank):
    """Rank 0: five append-still levels (no spawners); rank 1: five
    append-spawn levels. The last of each waits for a refresh."""
    from safelife_tpu_torch.io.levels import load_levels

    task = "append-still" if rank == 0 else "append-spawn"
    return load_levels("benchmarks/v1.0/%s.npz" % task)[5 * rank:
                                                        5 * rank + 5]


# ---------------------------------------------------------------------------
# Rank functions


def _np(x):
    """A host copy (a CPU tensor's ``numpy()`` would share its memory)."""
    return x.detach().cpu().numpy().copy()


def env_rollout(rank, world, lanes_total, steps, seed, actions):
    """The wrapped env run of :func:`env_setup` on this rank's lanes: each
    step's boards, baselines, views, rewards and done flags, stacked."""
    import torch

    from safelife_tpu_torch.env import wrappers as W
    from safelife_tpu_torch.parallel import mesh as M

    cfg, wcfg, pool = env_setup()
    lanes = M.lane_range(lanes_total, rank, world)
    ws, obs = W.reset(cfg, wcfg, pool, lanes_total, device="cpu",
                      lanes=lanes)
    gen = torch.Generator().manual_seed(seed)
    out = {"board": [], "obs": [_np(obs)], "reward": [], "done": [],
           "baseline": []}
    for t in range(steps):
        act = torch.from_numpy(actions[t][lanes.start:lanes.stop])
        ws, obs, reward, done, _ = W.step(cfg, wcfg, pool, ws, act, gen,
                                          lanes=lanes)
        out["board"].append(_np(ws.env.board))
        out["baseline"].append(_np(ws.baseline_board))
        out["obs"].append(_np(obs))
        out["reward"].append(_np(reward))
        out["done"].append(_np(done))
    return {k: np.stack(v) for k, v in out.items()}


def ppo_iteration(rank, world, lanes_total, state_dict, actions, perms,
                  ppo_kwargs):
    """One sharded ``ppo.train_iteration`` of :func:`ppo_setup` from
    ``state_dict`` with the given actions [T, B, A] and permutations: the
    parameters after it, the boards and the scalar metrics."""
    import torch

    from safelife_tpu_torch.env import wrappers as W
    from safelife_tpu_torch.parallel import mesh as M
    from safelife_tpu_torch.training import ppo as P

    cfg, wcfg, pool, net = ppo_setup()
    net.load_state_dict(state_dict)
    lanes = M.lane_range(lanes_total, rank, world)
    pcfg = P.PPOConfig(**ppo_kwargs)
    ps = P.init_ppo_state(pcfg, net, device="cpu")
    ws, obs = W.reset(cfg, wcfg, pool, lanes_total, device="cpu",
                      lanes=lanes)
    acts = torch.from_numpy(actions[:, lanes.start:lanes.stop].copy())
    ps, ws, obs, m = P.train_iteration(
        cfg, wcfg, pcfg, pool, ps, ws, obs, torch.Generator().manual_seed(0),
        actions=acts, perms=perms, device="cpu", lanes=lanes)
    return {"params": {k: _np(v) for k, v in net.state_dict().items()},
            "num_steps": ps.num_steps, "board": _np(ws.env.board),
            "metrics": {k: float(v) for k, v in m.items()
                        if k not in ("episodes", "ep_samples")}}


def dqn_units(rank, world, lanes_total, units, steps, seed, dqn_kwargs):
    """``units`` sharded ``dqn.collect_and_optimize`` units of
    :func:`dqn_setup`: the replay and the parameters after them."""
    import torch

    from safelife_tpu_torch.env import wrappers as W
    from safelife_tpu_torch.parallel import mesh as M
    from safelife_tpu_torch.training import dqn as D

    cfg, wcfg, pool, net, obs_shape, obs_dtype = dqn_setup()
    lanes = M.lane_range(lanes_total, rank, world)
    dcfg = D.DQNConfig(**dqn_kwargs)
    ds = D.init_dqn_state(dcfg, net, lanes.size * pool.num_agents,
                          obs_shape, obs_dtype, device="cpu")
    ws, obs = W.reset(cfg, wcfg, pool, lanes_total, device="cpu",
                      lanes=lanes)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(units):
        ds, ws, obs, _ = D.collect_and_optimize(
            cfg, wcfg, dcfg, pool, ds, ws, obs, gen, steps, device="cpu",
            lanes=lanes)
    replay = {k: _np(getattr(ds.replay, k)) for k in
              ("obs", "action", "reward", "next_obs", "done")}
    return {"replay": replay, "idx": ds.replay.idx,
            "num_steps": ds.num_steps,
            "params": {k: _np(v) for k, v in net.state_dict().items()}}


def pool_manager(rank, world):
    """A ``LevelPoolManager`` over :func:`pool_levels` of every rank: the
    gathered pool, then a refresh of one level on rank 0 while a lane of
    rank 1 is on rank 0's slot 0."""
    from safelife_tpu_torch.io.iterator import LevelPoolManager

    levels = pool_levels(rank)
    n = len(levels) - 1
    mgr = LevelPoolManager(iter(levels), pool_size=n, device="cpu")
    before = {k: _np(getattr(mgr.pool, k)) for k in ("board", "goals",
                                                     "agent_mask")}
    flags = (mgr.pool.all_goals_static, mgr.pool.spawner_free)
    meta = {k: dict(v) for k, v in mgr.level_meta().items()}
    in_use = [0] if rank == 1 else [2 * n - 1]
    swapped = mgr.refresh(1 if rank == 0 else 0, in_use=in_use)
    return {"before": before, "flags": flags, "meta": meta,
            "after": _np(mgr.pool.board), "swapped": swapped,
            "meta_after": {k: dict(v) for k, v in mgr.level_meta().items()}}


def spatial(rank, world, board, draws, seeds, spawn_prob):
    """This rank's rows after the sharded advances of ``board``: given
    spawns, deterministic, stochastic (K2's plain version on slabs) and
    ``len(seeds)`` stochastic steps."""
    import torch

    from safelife_tpu_torch.parallel import spatial as S

    hl = board.shape[0] // world
    rows = torch.from_numpy(board[rank * hl:(rank + 1) * hl])
    coins = torch.from_numpy(draws[rank * hl:(rank + 1) * hl])
    seeds = torch.from_numpy(seeds)
    return {
        "given": _np(S.advance_sharded_given_spawns(rows, coins)),
        "deterministic": _np(S.advance_sharded(rows, seeds[0], spawn_prob,
                                               stochastic=False)),
        "stochastic": _np(S.advance_sharded(rows, seeds[0], spawn_prob)),
        "nstep": _np(S.advance_sharded_nstep(rows, seeds, spawn_prob)),
    }
