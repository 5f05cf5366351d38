"""Drive the PyTorch/CUDA port on one NVIDIA card and check its kernels.

    python3 chip_smoke.py

from the root of a checkout, on a host with a CUDA card and ``nvcc``. It
imports torch, numpy and ``safelife_tpu_torch``, never JAX nor
``safelife_tpu``, and runs in phases; any failure raises and exits
non-zero:

0. Environment: the card, its power limit, torch, CUDA and nvcc versions;
   builds the three kernels from ``safelife_tpu_torch/ops/csrc``.
1. Each kernel against its plain PyTorch version on the card, bit for bit,
   on seeded random soups and real level boards: K1
   ``fused_actions_advance`` and K2 ``advance`` on boards (1,4), (2,5),
   (3,3), (4,4), (7,13), (26,26), (33,40) and (96,128) x B in {1, 7, 512,
   4096}, K1 with 1-3 adjacent agents, both deterministic and with
   Philox spawns at p in {0, 0.3, 1}; K3 ``recenter_views`` for views (25,25), (15,15), (7,9) x
   A in {1,3} x E in {0,1,2} on 26x26 boards and (3,3) on 3x3 boards.
2. The main path: the prune-dynamic v1.0 benchmark (100 levels) through
   ``run_episodes`` at 512 lanes x 1000 steps and ``benchmark`` over the
   100 levels, with the 25x25 / dense-512 policy on packed observations
   from seeded parameters in the JAX package's layout. Launch counts are
   zeroed just before and read just after; each kernel must have run. A
   64-lane x 200-step run with a peaked policy is held against the port's
   own CPU path: boards, rewards, done flags and final boards exact,
   policy probabilities within 1e-4.
3. The stochastic path: the navigation benchmark (spawners) for 64 lanes x
   200 steps, K1 and K2 drawing spawns; one agent per live lane and finite
   rewards. Then 3x3 levels, where an action's four cells alias, for 64
   lanes x 20 steps on the card against the port's CPU path.

Then it times each kernel and its plain version at the main path's shapes,
holding their outputs there against each other too, and prints, before
the last line, the card's name and power limit as ``nvidia-smi`` reports
them and one ``{"kernels": [...]}`` JSON line. The last line is
``{"ok": true, "device": {...}}``.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

#: Device memory rate of one H100 SXM (data sheet), and its 32-bit integer
#: rate: add, shift, logic and compare issue at 64 per SM per clock on
#: compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
#: instruction throughput), times 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: Integer operations a cell of one CA step needs in the separable form
#: (pack 20, neighbourhood sum and OR 8, rule 27), and an agent's action.
CA_OPS_PER_CELL = 55
ACTION_OPS_PER_AGENT = 60
#: Operations of one view element (wrap, pack) and of one exit test there.
VIEW_OPS_PER_ELEMENT = 10
EXIT_OPS_PER_ELEMENT = 12

VIEW = (25, 25)
LANES = 512
STEPS = 1000

#: Board shapes and batch sizes on which phase 1 holds K1 and K2 against
#: their plain versions: every block layout of the kernels (one board or
#: many a block, W above 32, H != W, the last block partly empty, the main
#: path's B = 512, and MAX_CELLS = 96 x 128, which needs more than 48 KB of
#: shared memory), and boards on which an action's cells coincide with the
#: agent's own (two ahead of it on 2 rows or columns, one ahead on 1).
PHASE1_SHAPES = ((1, 4), (2, 5), (3, 3), (4, 4), (7, 13), (26, 26), (33, 40),
                 (96, 128))
PHASE1_BATCHES = (1, 7, LANES, 4096)


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_release(nvcc):
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    m = re.search(r"release ([0-9.]+)", out)
    return m.group(1) if m else out.strip().splitlines()[-1]


# ---------------------------------------------------------------------------
# Inputs


def soup(rng, b, h, w, n_agents, spawners=False):
    """Random boards with every cell flag, exits and colours, and agents
    next to one another (in a row or a column, wrapping), so that their
    actions touch each other's cells."""
    from safelife_tpu_torch.core import cells as C

    shape = (b, h, w)
    board = np.zeros(shape, np.int32)
    alive = rng.random(shape, np.float32) < 0.25
    board |= alive * (C.ALIVE | C.DESTRUCTIBLE)
    for flag, p in ((C.FROZEN, 0.08), (C.PUSHABLE, 0.05), (C.PULLABLE, 0.05),
                    (C.PRESERVING, 0.03), (C.INHIBITING, 0.03),
                    (C.EXIT, 0.03), (C.DESTRUCTIBLE, 0.05)):
        board |= (rng.random(shape, np.float32) < p) * np.int32(flag)
    board |= alive * (rng.integers(0, 8, shape, np.int32) << C.COLOR_BIT)
    if spawners:
        board |= (rng.random(shape, np.float32) < 0.03) * np.int32(
            C.SPAWNING | C.FROZEN)
    locs = np.zeros((b, n_agents, 2), np.int32)
    y0, x0 = rng.integers(0, h, b), rng.integers(0, w, b)
    down = rng.random(b) < 0.5
    for k in range(n_agents):
        locs[:, k, 0] = (y0 + k * down) % h
        locs[:, k, 1] = (x0 + k * ~down) % w
        board[np.arange(b), locs[:, k, 0], locs[:, k, 1]] = C.PLAYER | (
            rng.integers(0, 8, b) << C.COLOR_BIT)
    return board, locs


def random_policy_tree(rng, n_channels, view):
    """Policy parameters in the JAX package's flax layout, uniform in
    +-1/sqrt(fan_in) as torch initialises its layers."""
    from safelife_tpu_torch.models.nets import (HIDDEN_WIDTH as width,
                                                NUM_ACTIONS as n_actions,
                                                cnn_output_features)

    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    feat = cnn_output_features(tuple(view) + (n_channels,))
    convs = [(5, n_channels, 32), (3, 32, 64), (3, 64, 64)]
    cnn = {"Conv_%d" % i: {"kernel": u((k, k, i_, o), k * k * i_),
                           "bias": u((o,), k * k * i_)}
           for i, (k, i_, o) in enumerate(convs)}
    return {"params": {
        "SafeLifeCNN_0": cnn,
        "Dense_0": {"kernel": u((feat, width), feat),
                    "bias": u((width,), feat)},
        "Dense_1": {"kernel": u((width, 1), width), "bias": u((1,), width)},
        "Dense_2": {"kernel": u((width, n_actions), width),
                    "bias": u((n_actions,), width)},
    }}


def policy(tree, device):
    from safelife_tpu_torch.models.convert import policy_params_from_flax
    from safelife_tpu_torch.models.nets import (SafeLifePolicyNetwork,
                                                TRAINING_CHANNELS)

    net = SafeLifePolicyNetwork(view_shape=VIEW,
                                unpack_channels=TRAINING_CHANNELS,
                                device=device)
    net.load_state_dict(policy_params_from_flax(tree))
    return net.eval()


# ---------------------------------------------------------------------------
# Phase 1: kernels against plain versions


def max_err(pairs):
    """Largest absolute difference over (kernel, plain) output pairs; raises
    if any pair differs (every kernel is exact)."""
    err = 0
    for got, ref in pairs:
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError("shape/dtype %s %s vs %s %s" % (
                tuple(got.shape), got.dtype, tuple(ref.shape), ref.dtype))
        d = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        err = max(err, d)
    if err:
        raise AssertionError("kernel differs from its plain version by %d"
                             % err)
    return err


def check_physics(dev, pool_boards, pool_locs):
    from safelife_tpu_torch.core import advance as ADV
    from safelife_tpu_torch.ops import physics as P

    rng = np.random.default_rng(1)
    errs = {"fused_actions_advance": 0, "advance": 0}
    seed = torch.tensor([-1640531527, 1013904223], dtype=torch.int32,
                        device=dev)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa

    def run_k1(board, locs, acts, p, stochastic):
        b, h, w = board.shape
        args = (t(board.reshape(b, h * w)), t(locs), t(acts),
                torch.full((b,), p, device=dev), seed)
        got = P.fused_actions_advance(*args, h=h, w=w, stochastic=stochastic)
        ref = P.fused_actions_advance_plain(*args, h=h, w=w,
                                            stochastic=stochastic)
        errs["fused_actions_advance"] = max(errs["fused_actions_advance"],
                                            max_err(zip(got, ref)))

    def run_k2(flat, h, w, p, stochastic):
        sp = torch.full((flat.shape[0],), p, device=dev)
        got = P.advance(flat, sp, seed, h=h, w=w, stochastic=stochastic)
        ref = P.advance_plain(flat, sp, seed, h=h, w=w, stochastic=stochastic)
        errs["advance"] = max(errs["advance"], max_err([(got, ref)]))

    for h, w in PHASE1_SHAPES:
        for b in PHASE1_BATCHES:
            # Three adjacent agents; A = 1 and 2 act with the first ones
            # while the others stay on the board as agent cells.
            board, locs = soup(rng, b, h, w, 3, spawners=True)
            acts = rng.integers(0, 9, (b, 3)).astype(np.int32)
            for a in (1, 2, 3):
                run_k1(board, locs[:, :a], acts[:, :a], 0.3, False)
                for p in (0.0, 0.3, 1.0):
                    run_k1(board, locs[:, :a], acts[:, :a], p, True)
            flat = t(board.reshape(b, h * w))
            run_k2(flat, h, w, 0.0, False)
            for p in (0.0, 0.3, 1.0):
                run_k2(flat, h, w, p, True)
        layouts = ", ".join(
            "B=%d: %d boards a block, %d rows a thread, %d threads, %d B "
            "shared" % ((b,) + P.launch_shape(h, w, b))
            for b in PHASE1_BATCHES)
        log("K1, K2 %dx%d (%s) x A in {1,2,3} x (deterministic, p in {0, "
            "0.3, 1}): exact" % (h, w, layouts))

    # Real level boards (prune-dynamic), tiled to B lanes.
    b = 4096
    h, w = pool_boards.shape[1:]
    reps = -(-b // len(pool_boards))
    rb = np.tile(pool_boards, (reps, 1, 1))[:b]
    rl = np.tile(pool_locs, (reps, 1, 1))[:b]
    for _ in range(3):
        acts = rng.integers(0, 9, (b, 1)).astype(np.int32)
        run_k1(rb, rl, acts, 0.3, False)
    log("K1 on prune-dynamic boards: exact")

    h, w = 26, 26
    board, _ = soup(rng, b, h, w, 1, spawners=True)
    flat = t(board.reshape(b, h * w))
    grid = flat.reshape(b, h, w)
    elig = ADV.spawn_eligible(grid)
    det = ADV.advance_board_deterministic(grid)
    got = P.advance(flat, torch.full((b,), 0.3, device=dev), seed, h=h, w=w,
                    stochastic=True).reshape(b, h, w)
    frac = float(((got != det) & elig).sum()) / max(int(elig.sum()), 1)
    if not 0.25 < frac < 0.35:
        raise AssertionError("K2 spawn fraction %.4f outside (0.25, 0.35)"
                             % frac)
    log("K2 spawn fraction at p=0.3 (26x26, B=4096): %.4f" % frac)
    return errs


def check_obs(dev):
    from safelife_tpu_torch import ops

    rng = np.random.default_rng(2)
    b, h, w = 4096, 26, 26
    err = 0
    for view in ((25, 25), (15, 15), (7, 9)):
        for a in (1, 3):
            for e in (0, 1, 2):
                t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
                words = rng.integers(0, 2 ** 16, (2, b, h, w)).astype(np.int32)
                args = (t(words[0]), t(words[1]),
                        t(rng.integers(0, h, (b, a)).astype(np.int32)),
                        t(rng.integers(0, w, (b, a)).astype(np.int32)),
                        t(rng.integers(0, h, (b, e, 2)).astype(np.int32)),
                        t(rng.random((b, e)) < 0.7))
                for rw in (True, False):
                    got = ops.recenter_views(*args, view_shape=view,
                                             remove_white_goals=rw)
                    ref = ops.recenter_views_plain(*args, view_shape=view,
                                                   remove_white_goals=rw)
                    err = max(err, max_err([(got, ref)]))
    # 3x3 boards with a 3x3 view, the largest the board allows.
    b, h, w = 4096, 3, 3
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    words = rng.integers(0, 2 ** 16, (2, b, h, w)).astype(np.int32)
    args = (t(words[0]), t(words[1]),
            t(rng.integers(0, h, (b, 2)).astype(np.int32)),
            t(rng.integers(0, w, (b, 2)).astype(np.int32)),
            t(rng.integers(0, h, (b, 1, 2)).astype(np.int32)),
            t(rng.random((b, 1)) < 0.7))
    got = ops.recenter_views(*args, view_shape=(3, 3))
    ref = ops.recenter_views_plain(*args, view_shape=(3, 3))
    err = max(err, max_err([(got, ref)]))
    log("K3 views (25,25),(15,15),(7,9) x A {1,3} x E {0,1,2} on 26x26, "
        "and (3,3) on 3x3: exact")
    return err


# ---------------------------------------------------------------------------
# Phase 2: the main path, and the card against the port's CPU path


def run_main_path(dev, levels, net, card):
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.training import runner as R

    pool = pack_levels(levels, device=dev)
    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None, time_limit=STEPS)
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.arange(LANES, device=dev) % pool.num_levels

    # Warm-up outside the counted window (allocator, cuDNN plans).
    R.run_episodes(cfg, pool, net, idx, gen, 3)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = R.run_episodes(cfg, pool, net, idx, gen, STEPS)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    records, summary = R.benchmark(net, levels, len(levels), env_cfg=cfg,
                                   generator=gen, device=dev)
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t0
    launches = ops.launch_counts()

    for k in ("episode_reward", "episode_length", "final_board"):
        if not torch.isfinite(out[k].float()).all():
            raise AssertionError("non-finite %s" % k)
    if out["final_board"].shape != (LANES,) + pool.board_shape:
        raise AssertionError("final_board shape %s"
                             % (tuple(out["final_board"].shape),))
    if len(records) != len(levels):
        raise AssertionError("benchmark returned %d records" % len(records))
    expected = {"fused_actions_advance": 2 * STEPS, "advance": 2 * STEPS,
                "recenter_views": 2 * STEPS + 2}
    for name, n in expected.items():
        if launches[name] == 0:
            raise AssertionError("kernel %s was never launched on the main "
                                 "path" % name)
        if launches[name] != n:
            raise AssertionError("kernel %s launched %d times, expected %d"
                                 % (name, launches[name], n))
    rate = LANES * STEPS / rollout_s
    log("main path: run_episodes %d lanes x %d steps in %.3f s = %.0f "
        "env-steps/s; benchmark %d episodes in %.3f s  [%s]"
        % (LANES, STEPS, rollout_s, rate, len(records), bench_s, card))
    log("benchmark summary prune-dynamic (random policy): reward fraction "
        "%.4f, success %.4f, mean length %.1f  [%s]"
        % (summary["reward"], summary["success"], summary["avg_length"],
           card))
    log("launches on the main path: %s (%d + %d steps)"
        % (json.dumps(launches), STEPS, STEPS))
    return launches, {"env_steps_per_s": rate, "rollout_s": rollout_s,
                      "benchmark_s": bench_s, "summary": summary}


def check_against_cpu(dev, levels, tree, lanes=64, steps=200):
    """The card's run against the port's own CPU path, step by step: a
    peaked policy picks the same actions on both, so boards, rewards, done
    flags and views must agree exactly; the seeded network's probabilities
    on the same views must agree within 1e-4 (TF32 off on the card)."""
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.training.runner import _policy_sample

    bias = np.zeros(9, np.float32)
    bias[2] = 60.0  # p ~ 1 on "move right": both samplers agree
    peaked = {"params": {**tree["params"],
                         "Dense_2": {**tree["params"]["Dense_2"],
                                     "bias": bias}}}
    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None, time_limit=150,
                      auto_reset=False)
    runs = []
    for d in (dev, torch.device("cpu")):
        pool = pack_levels(levels, device=d)
        idx = torch.arange(lanes, device=d) % len(levels)
        state = E.reset_batch(cfg, pool, idx)
        runs.append(dict(pool=pool, net=policy(peaked, d), state=state,
                         net_random=policy(tree, d),
                         obs=E._batch_obs(cfg, pool, state),
                         gen=torch.Generator(device=d).manual_seed(1)))
    worst_p = 0.0
    with torch.no_grad():
        for t in range(steps):
            out = []
            for r in runs:
                # The seeded (unpeaked) network's probabilities on the same
                # observations: the check of the policy's float math.
                _, probs = r["net_random"](r["obs"].reshape(lanes, *VIEW))
                acts = _policy_sample(r["net"], r["obs"], r["gen"])
                r["state"], rew, done, _ = E.step_core(
                    cfg, r["pool"], r["state"], acts, r["gen"])
                r["obs"] = E._batch_obs(cfg, r["pool"], r["state"])
                out.append([x.cpu() for x in (probs, acts, r["state"].board,
                                              rew, done, r["obs"])])
            card, host = out
            worst_p = max(worst_p, float((card[0] - host[0]).abs().max()))
            if worst_p > 1e-4:
                raise AssertionError("policy probabilities differ by %g at "
                                     "step %d" % (worst_p, t))
            for i, what in ((1, "actions"), (2, "boards"), (3, "rewards"),
                            (4, "done"), (5, "observations")):
                if not torch.equal(card[i], host[i]):
                    raise AssertionError("%s differ at step %d" % (what, t))
    final = [r["state"].board.cpu() for r in runs]
    if not torch.equal(*final):
        raise AssertionError("final boards differ")
    start = runs[1]["pool"].board[torch.arange(lanes) % len(levels)]
    moved = int((final[1] != start).any(-1).any(-1).sum())
    log("card vs CPU path, %d lanes x %d steps: boards, rewards, done, "
        "observations exact; policy max |dp| %.2e; %d lanes changed"
        % (lanes, steps, worst_p, moved))
    return worst_p


# ---------------------------------------------------------------------------
# Phase 3: the stochastic path


def check_stochastic(dev, levels, net, lanes=64, steps=200):
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.core import cells as C
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.training.runner import _policy_sample

    pool = pack_levels(levels, device=dev)
    if pool.spawner_free:
        raise AssertionError("navigation pool has no spawners")
    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None, auto_reset=False)
    gen = torch.Generator(device=dev).manual_seed(2)
    state = E.reset_batch(cfg, pool, torch.arange(lanes, device=dev)
                          % pool.num_levels)
    obs = E._batch_obs(cfg, pool, state)
    before = ops.launch_counts()
    spawned = 0
    with torch.no_grad():
        for _ in range(steps):
            acts = _policy_sample(net, obs, gen)
            prev = state.board
            state, rew, done, _ = E.step_core(cfg, pool, state, acts, gen)
            obs = E._batch_obs(cfg, pool, state)
            if not torch.isfinite(rew).all():
                raise AssertionError("non-finite reward")
            agents = ((state.board & C.AGENT) != 0).sum((-1, -2))
            live = state.is_active[:, 0]
            if not (agents[live] == 1).all():
                raise AssertionError("a live lane lost or gained an agent")
            spawned += int(((prev & C.ALIVE) == 0).logical_and(
                (state.board & C.ALIVE) != 0).sum())
    after = ops.launch_counts()
    if after["fused_actions_advance"] - before["fused_actions_advance"] \
            != steps or after["advance"] - before["advance"] != steps:
        raise AssertionError("stochastic path skipped a kernel")
    log("stochastic navigation %d lanes x %d steps: one agent per live "
        "lane, finite rewards, %d cells came alive" % (lanes, steps, spawned))


def check_tiny_levels(dev, lanes=64, steps=20, n_levels=16):
    """3x3 levels, where an action's four cells alias: the card's step_core
    (K1, and K3 for the 3x3 views) against the port's CPU path, random
    actions, boards, locations, rewards, done flags and views exact."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.core import cells as C
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.io.levels import level_from_data

    rng = np.random.default_rng(6)
    levels = []
    for _ in range(n_levels):
        board = np.zeros((3, 3), np.int32)
        board |= (rng.random((3, 3)) < 0.3) * (C.ALIVE | C.DESTRUCTIBLE)
        board |= (rng.random((3, 3)) < 0.2) * (C.PUSHABLE | C.PULLABLE)
        board[0, 2] = C.EXIT
        board[1, 1] = C.PLAYER
        goals = ((rng.random((3, 3)) < 0.4)
                 * (rng.integers(1, 8, (3, 3)) << C.COLOR_BIT))
        levels.append(level_from_data(dict(
            board=board, goals=goals.astype(np.int32),
            agent_locs=np.array([[1, 1]]))))
    acts = rng.integers(0, 9, (steps, lanes, 1)).astype(np.int32)
    cfg = E.EnvConfig(view_shape=(3, 3), output_channels=None,
                      time_limit=steps, auto_reset=False)
    before = ops.launch_counts()
    runs = []
    for d in (dev, torch.device("cpu")):
        pool = pack_levels(levels, device=d)
        state = E.reset_batch(cfg, pool,
                              torch.arange(lanes, device=d) % n_levels)
        gen = torch.Generator(device=d).manual_seed(0)
        out = []
        for t in range(steps):
            state, rew, done, _ = E.step_core(
                cfg, pool, state, torch.from_numpy(acts[t]).to(d), gen)
            obs = E._batch_obs(cfg, pool, state)
            out.append([x.cpu() for x in (state.board, state.agent_locs,
                                          rew, done, obs)])
        runs.append(out)
    after = ops.launch_counts()
    if after["fused_actions_advance"] - before["fused_actions_advance"] \
            != steps:
        raise AssertionError("3x3 levels skipped K1")
    moves = 0
    for t, (card, host) in enumerate(zip(*runs)):
        for i, what in enumerate(("boards", "locations", "rewards", "done",
                                  "views")):
            if not torch.equal(card[i], host[i]):
                raise AssertionError("3x3 levels: %s differ at step %d"
                                     % (what, t))
        if t:
            moves += int((card[1] != runs[0][t - 1][1]).any(-1).sum())
    log("3x3 levels, %d lanes x %d steps: card equals the CPU path exactly "
        "(boards, locations, rewards, done, 3x3 views); %d agent moves"
        % (lanes, steps, moves))


# ---------------------------------------------------------------------------
# Timing


def device_ms(fn, kernel_name, n=50):
    """Kernel time on the card per launch: the profiler's device time over
    the launches it recorded when that is at least half of n (it may drop
    a few), else CUDA events around n launches."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel_name in evt.key:
            total += getattr(evt, "device_time_total", 0.0)
            count += evt.count
    if 2 * count >= n and total > 0:
        return total / count / 1e3, "profiler, %d of %d launches" % (count, n)
    return events_ms(fn, n), "events"


def events_ms(fn, n=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes, nops):
    """(bound_ms, bound_by, bytes_ms, ops_ms): the larger of the time to move
    the bytes and the time to issue the integer operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_bytes, t_ops


def time_kernels(dev, pool, b):
    """Time each kernel and its plain version at the main path's shapes
    (prune-dynamic boards, one agent, one exit, 25x25 views) for b lanes,
    and hold their outputs on these inputs against each other."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.env import env as E

    idx = torch.arange(b, device=dev) % pool.num_levels
    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None)
    state = E.reset_batch(cfg, pool, idx)
    h, w = pool.board_shape
    hw = h * w
    a = pool.num_agents
    e = pool.exit_locs.shape[1]
    flat = state.board.reshape(b, hw).contiguous()
    goals = state.goals.reshape(b, hw).contiguous()
    locs = state.agent_locs.contiguous()
    gen = torch.Generator(device=dev).manual_seed(3)
    acts = torch.randint(0, 9, (b, a), generator=gen, device=dev,
                         dtype=torch.int32)
    sp = pool.spawn_prob.index_select(0, idx).contiguous()
    seed = torch.zeros(2, dtype=torch.int32, device=dev)
    el = pool.exit_locs.index_select(0, idx)
    ev = pool.exit_locs_valid.index_select(0, idx)
    cy = locs[..., 0].contiguous()
    cx = locs[..., 1].contiguous()
    vh, vw = VIEW

    k1 = dict(h=h, w=w, stochastic=False)
    cases = {
        "fused_actions_advance": (
            "physics_kernel",
            lambda: ops.fused_actions_advance(flat, locs, acts, sp, seed,
                                              **k1),
            lambda: ops.fused_actions_advance_plain(flat, locs, acts, sp,
                                                    seed, **k1),
            2 * b * hw * 4 + b * a * (2 * 2 * 4 + 4 + 4) + b * 4 + 8,
            b * hw * CA_OPS_PER_CELL + b * a * ACTION_OPS_PER_AGENT),
        "advance": (
            "advance_kernel",
            lambda: ops.advance(goals, sp, seed, **k1),
            lambda: ops.advance_plain(goals, sp, seed, **k1),
            2 * b * hw * 4 + b * 4 + 8,
            b * hw * CA_OPS_PER_CELL),
        "recenter_views": (
            "recenter_kernel",
            lambda: ops.recenter_views(state.board, state.goals, cy, cx, el,
                                       ev, view_shape=VIEW),
            lambda: ops.recenter_views_plain(state.board, state.goals, cy,
                                             cx, el, ev, view_shape=VIEW),
            2 * b * hw * 4 + 2 * b * a * 4 + b * e * 9 + b * a * vh * vw * 4,
            b * a * vh * vw * (VIEW_OPS_PER_ELEMENT
                               + e * EXIT_OPS_PER_ELEMENT)),
    }
    out = {}
    for name, (kname, kern, plain, nbytes, nops) in cases.items():
        ms, how = device_ms(kern, kname)
        call_ms = events_ms(kern)
        plain_ms = events_ms(plain)
        bound_ms, bound_by, bytes_ms, ops_ms = bound(nbytes, nops)
        got, ref = kern(), plain()
        if not isinstance(got, tuple):
            got, ref = (got,), (ref,)
        out[name] = dict(ms=ms, timed_by=how, call_ms=call_ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
                         err=max_err(zip(got, ref)))
    return out


def rollout_rate(dev, pool, net, lanes, steps=200):
    """env-steps/s of run_episodes at ``lanes`` lanes (after a warm-up)."""
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.training import runner as R

    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None, time_limit=STEPS)
    gen = torch.Generator(device=dev).manual_seed(5)
    idx = torch.arange(lanes, device=dev) % pool.num_levels
    R.run_episodes(cfg, pool, net, idx, gen, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    R.run_episodes(cfg, pool, net, idx, gen, steps)
    torch.cuda.synchronize()
    return lanes * steps / (time.perf_counter() - t0)


def profile_rollout(dev, pool, net, lanes, steps=50):
    """Device busy share and device time by kernel over ``steps`` rollout
    steps (the profiler's own cost inflates the wall time a little)."""
    from torch.profiler import ProfilerActivity, profile

    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.training import runner as R

    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None, time_limit=STEPS)
    gen = torch.Generator(device=dev).manual_seed(4)
    idx = torch.arange(lanes, device=dev) % pool.num_levels
    R.run_episodes(cfg, pool, net, idx, gen, 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        R.run_episodes(cfg, pool, net, idx, gen, steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    kernels = sorted(((e.device_time_total, e.count, e.key)
                      for e in prof.key_averages() if e.device_type == cuda),
                     reverse=True)
    total = sum(k[0] for k in kernels) or 1.0
    log("profile of %d rollout steps at %d lanes: wall %.1f us/step, device "
        "busy %.1f us/step (%.1f%%), %d device activities/step"
        % (steps, lanes, wall_us / steps, busy / steps,
           100 * busy / wall_us, len(spans) / steps))
    for t, n, key in kernels[:10]:
        log("  %6.1f%% %9.1f us  x%-6d %s"
            % (100 * t / total, t / steps, n // steps, key[:90]))
    return busy / wall_us


# ---------------------------------------------------------------------------


KERNELS = {
    "fused_actions_advance": ("safelife_tpu_torch/ops/csrc/physics.cu",
                              "safelife_tpu/ops/physics.py:296"),
    "advance": ("safelife_tpu_torch/ops/csrc/advance.cu",
                "safelife_tpu/ops/physics.py:371"),
    "recenter_views": ("safelife_tpu_torch/ops/csrc/obs.cu",
                       "safelife_tpu/ops/obs.py:146"),
}


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)\n")
        return 1
    from safelife_tpu_torch.io.levels import load_levels
    from safelife_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    card = smi
    log("environment: %s | torch %s | CUDA %s | nvcc %s | python %s"
        % (smi, torch.__version__, torch.version.cuda,
           nvcc_release(_build.nvcc_path()), sys.version.split()[0]))
    t0 = time.perf_counter()
    _build.kernels()
    log("kernels built in %.1f s" % (time.perf_counter() - t0))
    for source, text in _build.build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("  %s: %s" % (source, line.strip()))

    prune = load_levels("benchmarks/v1.0/prune-dynamic.npz")
    nav = load_levels("benchmarks/v1.0/navigation.npz")
    if len(prune) != 100 or len(nav) != 100:
        raise AssertionError("expected 100 levels per archive")

    # Phase 1
    errs = check_physics(dev, np.stack([lv.board for lv in prune]),
                         np.stack([lv.agent_locs for lv in prune]
                                  ).astype(np.int32))
    errs["recenter_views"] = check_obs(dev)

    # Phase 2
    from safelife_tpu_torch.models.nets import TRAINING_CHANNELS

    tree = random_policy_tree(np.random.default_rng(0),
                              len(TRAINING_CHANNELS), VIEW)
    net = policy(tree, dev)
    launches, main_stats = run_main_path(dev, prune, net, card)
    check_against_cpu(dev, prune, tree)

    # Phase 3
    check_stochastic(dev, nav, net)
    check_tiny_levels(dev)

    # Timings at the main path's shapes (B = 512) and at B = 4096.
    from safelife_tpu_torch.env.state import pack_levels

    pool = pack_levels(prune, device=dev)
    times = time_kernels(dev, pool, LANES)
    times_4096 = time_kernels(dev, pool, 4096)
    for name in KERNELS:
        for b, tt in ((LANES, times), (4096, times_4096)):
            t = tt[name]
            log("timing %-22s B=%-4d kernel %.5f ms (%s; %.5f ms a call "
                "with the wrapper), plain %.5f ms, bound %.5f ms (%s; bytes "
                "%.5f, operations %.5f)  [%s]"
                % (name, b, t["ms"], t["timed_by"], t["call_ms"],
                   t["plain_ms"], t["bound_ms"], t["bound_by"],
                   t["bytes_ms"], t["ops_ms"], card))
    log("rollout at 512 lanes x 200 steps: %.0f env-steps/s  [%s]"
        % (rollout_rate(dev, pool, net, LANES), card))
    log("rollout at 4096 lanes x 200 steps: %.0f env-steps/s  [%s]"
        % (rollout_rate(dev, pool, net, 4096), card))
    profile_rollout(dev, pool, net, LANES)
    profile_rollout(dev, pool, net, 4096)
    log("main path per step: %s" % json.dumps(
        {k: v / (2 * STEPS) for k, v in launches.items()}))
    log("elapsed %.1f s" % (time.perf_counter() - t_start))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[name], t["err"]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
