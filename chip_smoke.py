"""Drive the PyTorch/CUDA port on one NVIDIA card and check its kernels.

    python3 chip_smoke.py

from the root of a checkout, on a host with a CUDA card and ``nvcc``. It
imports torch, numpy and ``safelife_tpu_torch``, never JAX nor
``safelife_tpu``, and runs in phases; any failure raises and exits
non-zero:

0. Environment: the card, its power limit, torch, CUDA and nvcc versions;
   builds the kernels from ``safelife_tpu_torch/ops/csrc`` (one library a
   source, each holding a staged and a global-memory form).
1. Each kernel form against its plain PyTorch version on the card, bit for
   bit, on seeded random soups and real level boards: K1
   ``fused_actions_advance`` and K2 ``advance`` on boards (1,4), (2,5),
   (3,3), (4,4), (7,13), (26,26), (33,40) and (96,128) x B in {1, 7, 512,
   4096} (staged), and (112,112), (6,2100) and (128,128) x B in {1, 7, 64}
   (above MAX_CELLS: the global-memory form), K1 with 1-3 adjacent agents,
   both deterministic and with Philox spawns at p in {0, 0.3, 1}; K3
   ``recenter_views`` for views (25,25), (15,15), (7,9) on 26x26 boards,
   views larger than the board ((25,25) on 3x3, (15,15) on 10x12, (7,6) on
   6x6), and (25,25) on 192x192 boards (too large to stage: the
   global-memory form), each x A in {1,3} x E in {0,1,2}, and (3,3) on 3x3.
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
   lanes x 20 steps on the card against the port's CPU path, at 3x3 views
   and at 25x25 views (larger than the board).
4. The large-board path: generated 192x192 levels (spawners, goals that
   evolve) through ``run_episodes`` at 64 lanes x 40 steps with the same
   policy, counts zeroed just before and read just after; the global-memory
   forms of all three kernels must have run. Then 16 lanes x 10 steps of
   such levels without spawners (the card's and the CPU's generators draw
   different seeds) on the card against the port's CPU path.

Then it times each kernel form and its plain version at the shapes of the
path that runs it (the main path's at B = 512 and 4096, the large-board
path's at B = 64), holding their outputs there against each other too, and
prints, before the last line, the card's name and power limit as
``nvidia-smi`` reports them and one ``{"kernels": [...]}`` JSON line. The
last line is ``{"ok": true, "device": {...}}``.
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
#: Operations of one view element (wrap, pack), and of one exit of one view
#: (its projection onto the view).
VIEW_OPS_PER_ELEMENT = 10
EXIT_OPS_PER_VIEW = 12

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
#: Boards above MAX_CELLS (the global-memory form of K1 and K2): square,
#: far from square, and a power of two.
LARGE_SHAPES = ((112, 112), (6, 2100), (128, 128))
LARGE_BATCHES = (1, 7, 64)
#: The large-board path: boards too large for any staged form (K3's too).
LARGE_LEVEL = (192, 192)
LARGE_LANES = 64


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


def compare(errs, kern, plain):
    """Hold ``kern()`` (a wrapper call on the card) against ``plain()`` (its
    plain version on the same inputs) and fold the error into ``errs``
    under each kernel form the call launched; raises if it launched none.
    Returns the forms."""
    from safelife_tpu_torch import ops

    before = ops.launch_counts()
    got = kern()
    after = ops.launch_counts()
    forms = [k for k in after if after[k] > before[k]]
    if not forms:
        raise AssertionError("the wrapper launched no kernel")
    ref = plain()
    if not isinstance(got, tuple):
        got, ref = (got,), (ref,)
    err = max_err(zip(got, ref))
    for f in forms:
        errs[f] = max(errs.get(f, 0), err)
    return forms


def check_physics(dev, errs, pool_boards, pool_locs):
    from safelife_tpu_torch.core import advance as ADV
    from safelife_tpu_torch.ops import physics as P

    rng = np.random.default_rng(1)
    seed = torch.tensor([-1640531527, 1013904223], dtype=torch.int32,
                        device=dev)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa

    def run_k1(board, locs, acts, p, stochastic):
        b, h, w = board.shape
        args = (t(board.reshape(b, h * w)), t(locs), t(acts),
                torch.full((b,), p, device=dev), seed)
        k = dict(h=h, w=w, stochastic=stochastic)
        return compare(errs, lambda: P.fused_actions_advance(*args, **k),
                       lambda: P.fused_actions_advance_plain(*args, **k))

    def run_k2(flat, h, w, p, stochastic):
        sp = torch.full((flat.shape[0],), p, device=dev)
        k = dict(h=h, w=w, stochastic=stochastic)
        return compare(errs, lambda: P.advance(flat, sp, seed, **k),
                       lambda: P.advance_plain(flat, sp, seed, **k))

    def run_shape(h, w, batches, probs):
        forms = set()
        for b in batches:
            # Three adjacent agents; A = 1 and 2 act with the first ones
            # while the others stay on the board as agent cells.
            board, locs = soup(rng, b, h, w, 3, spawners=True)
            acts = rng.integers(0, 9, (b, 3)).astype(np.int32)
            for a in (1, 2, 3):
                forms.update(run_k1(board, locs[:, :a], acts[:, :a], 0.3,
                                    False))
                for p in probs:
                    forms.update(run_k1(board, locs[:, :a], acts[:, :a], p,
                                        True))
            flat = t(board.reshape(b, h * w))
            forms.update(run_k2(flat, h, w, 0.0, False))
            for p in probs:
                forms.update(run_k2(flat, h, w, p, True))
        return sorted(forms)

    for h, w in PHASE1_SHAPES:
        forms = run_shape(h, w, PHASE1_BATCHES, (0.0, 0.3, 1.0))
        layouts = ", ".join(
            "B=%d: %d boards a block, %d rows a thread, %d threads, %d B "
            "shared" % ((b,) + P.launch_shape(h, w, b))
            for b in PHASE1_BATCHES)
        log("K1, K2 %dx%d (%s) x A in {1,2,3} x (deterministic, p in {0, "
            "0.3, 1}): %s exact" % (h, w, layouts, ", ".join(forms)))
    for h, w in LARGE_SHAPES:
        forms = run_shape(h, w, LARGE_BATCHES, (0.3, 1.0))
        log("K1, K2 %dx%d (%d cells) x B in %s x A in {1,2,3} x "
            "(deterministic, p in {0.3, 1}): %s exact"
            % (h, w, h * w, LARGE_BATCHES, ", ".join(forms)))

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


#: K3 cases of phase 1: (board shape, view shape, batch). Views larger
#: than the board tile it; 192x192 lanes are too large to stage.
OBS_CASES = (((26, 26), (25, 25), 4096), ((26, 26), (15, 15), 4096),
             ((26, 26), (7, 9), 4096), ((3, 3), (25, 25), 4096),
             ((10, 12), (15, 15), 4096), ((6, 6), (7, 6), 4096),
             (LARGE_LEVEL, (25, 25), 64))


def check_obs(dev, errs):
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.ops import obs as O

    rng = np.random.default_rng(2)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    for (h, w), view, b in OBS_CASES:
        forms = set()
        for a in (1, 3):
            for e in (0, 1, 2):
                words = rng.integers(0, 2 ** 16, (2, b, h, w)).astype(np.int32)
                args = (t(words[0]), t(words[1]),
                        t(rng.integers(0, h, (b, a)).astype(np.int32)),
                        t(rng.integers(0, w, (b, a)).astype(np.int32)),
                        t(np.stack([rng.integers(0, h, (b, e)),
                                    rng.integers(0, w, (b, e))],
                                   -1).astype(np.int32)),
                        t(rng.random((b, e)) < 0.7))
                for rw in (True, False):
                    k = dict(view_shape=view, remove_white_goals=rw)
                    forms.update(compare(
                        errs, lambda: ops.recenter_views(*args, **k),
                        lambda: ops.recenter_views_plain(*args, **k)))
        log("K3 view %s on %dx%d, B=%d (lanes a block, threads, shared "
            "bytes at A=1: %s) x A in {1,3} x E in {0,1,2}: %s exact"
            % (view, h, w, b, O.view_launch_shape(b, 1, h, w, *view),
               ", ".join(sorted(forms))))
    # 3x3 boards with a 3x3 view.
    b, h, w = 4096, 3, 3
    words = rng.integers(0, 2 ** 16, (2, b, h, w)).astype(np.int32)
    args = (t(words[0]), t(words[1]),
            t(rng.integers(0, h, (b, 2)).astype(np.int32)),
            t(rng.integers(0, w, (b, 2)).astype(np.int32)),
            t(rng.integers(0, h, (b, 1, 2)).astype(np.int32)),
            t(rng.random((b, 1)) < 0.7))
    compare(errs, lambda: ops.recenter_views(*args, view_shape=(3, 3)),
            lambda: ops.recenter_views_plain(*args, view_shape=(3, 3)))
    log("K3 view (3,3) on 3x3: exact")


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
    for name in ("fused_actions_advance_global", "advance_global",
                 "recenter_views_global"):
        if launches[name]:
            raise AssertionError("kernel %s ran on 26x26 boards" % name)
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


def tiny_levels(n_levels=16):
    """3x3 levels, where an action's four cells alias."""
    from safelife_tpu_torch.core import cells as C
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
    return levels


def large_levels(n_levels=4, spawners=True):
    """Generated LARGE_LEVEL levels with every cell flag, goals that evolve
    (live goal cells), one agent, one exit and, if asked, spawners."""
    from safelife_tpu_torch.core import cells as C
    from safelife_tpu_torch.io.levels import level_from_data

    rng = np.random.default_rng(7)
    b, locs = soup(rng, n_levels, *LARGE_LEVEL, 1, spawners=spawners)
    levels = []
    for i in range(n_levels):
        board = b[i] & ~C.EXIT
        board[(locs[i, 0, 0] + 5) % LARGE_LEVEL[0], locs[i, 0, 1]] = C.EXIT
        goals = ((rng.random(LARGE_LEVEL) < 0.1)
                 * (rng.integers(1, 8, LARGE_LEVEL) << C.COLOR_BIT))
        goals |= (rng.random(LARGE_LEVEL) < 0.05) * (C.ALIVE | C.COLOR_G)
        levels.append(level_from_data(dict(
            board=board, goals=goals.astype(np.int32), agent_locs=locs[i])))
    return levels


def check_levels_against_cpu(dev, levels, view, what, lanes=64, steps=20):
    """The card's step_core and _batch_obs against the port's CPU path on
    ``levels`` under random actions: boards, locations, rewards, done flags
    and views exact. Returns the kernel forms the card's run launched."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.env.state import pack_levels

    rng = np.random.default_rng(6)
    acts = rng.integers(0, 9, (steps, lanes, 1)).astype(np.int32)
    cfg = E.EnvConfig(view_shape=view, output_channels=None,
                      time_limit=steps, auto_reset=False)
    runs, launched = [], None
    for d in (dev, torch.device("cpu")):
        before = ops.launch_counts()
        pool = pack_levels(levels, device=d)
        state = E.reset_batch(cfg, pool,
                              torch.arange(lanes, device=d) % len(levels))
        gen = torch.Generator(device=d).manual_seed(0)
        out = []
        for t in range(steps):
            state, rew, done, _ = E.step_core(
                cfg, pool, state, torch.from_numpy(acts[t]).to(d), gen)
            obs = E._batch_obs(cfg, pool, state)
            out.append([x.cpu() for x in (state.board, state.agent_locs,
                                          rew, done, obs)])
        runs.append(out)
        if launched is None:
            after = ops.launch_counts()
            launched = {k: after[k] - before[k] for k in after
                        if after[k] > before[k]}
    if launched.get("fused_actions_advance", 0) \
            + launched.get("fused_actions_advance_global", 0) != steps:
        raise AssertionError("%s skipped K1" % what)
    moves = 0
    for t, (card, host) in enumerate(zip(*runs)):
        for i, name in enumerate(("boards", "locations", "rewards", "done",
                                  "views")):
            if not torch.equal(card[i], host[i]):
                raise AssertionError("%s: %s differ at step %d"
                                     % (what, name, t))
        if t:
            moves += int((card[1] != runs[0][t - 1][1]).any(-1).sum())
    log("%s, %d lanes x %d steps, %dx%d views: card equals the CPU path "
        "exactly (boards, locations, rewards, done, views); %d agent moves; "
        "launches %s" % (what, lanes, steps, view[0], view[1], moves,
                         json.dumps(launched)))
    return launched


# ---------------------------------------------------------------------------
# Phase 4: the large-board path


#: The kernel forms the large-board path runs.
LARGE_PATH_FORMS = ("fused_actions_advance_global", "advance_global",
                    "recenter_views_global")


def run_large_path(dev, levels, net, card, steps=40):
    """``run_episodes`` on LARGE_LEVEL levels, counts zeroed just before and
    read just after: each global-memory form must have run, and no staged
    form of K1/K2."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.training import runner as R

    pool = pack_levels(levels, device=dev)
    if pool.all_goals_static or pool.spawner_free:
        raise AssertionError("large levels must have spawners and goals "
                             "that evolve")
    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None,
                      time_limit=steps)
    gen = torch.Generator(device=dev).manual_seed(8)
    idx = torch.arange(LARGE_LANES, device=dev) % pool.num_levels
    R.run_episodes(cfg, pool, net, idx, gen, 2)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = R.run_episodes(cfg, pool, net, idx, gen, steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ops.launch_counts()
    if out["final_board"].shape != (LARGE_LANES,) + LARGE_LEVEL:
        raise AssertionError("final_board shape %s"
                             % (tuple(out["final_board"].shape),))
    if not torch.isfinite(out["episode_reward"]).all():
        raise AssertionError("non-finite episode reward")
    for name in LARGE_PATH_FORMS:
        if launches[name] == 0:
            raise AssertionError("kernel %s was never launched on the "
                                 "large-board path" % name)
    if launches["fused_actions_advance"] or launches["advance"]:
        raise AssertionError("a staged K1/K2 ran on boards above MAX_CELLS")
    log("large-board path: run_episodes %d lanes x %d steps of %dx%d levels "
        "in %.3f s = %.0f env-steps/s; launches %s  [%s]"
        % (LARGE_LANES, steps, LARGE_LEVEL[0], LARGE_LEVEL[1], elapsed,
           LARGE_LANES * steps / elapsed, json.dumps(launches), card))
    return launches


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


def covered_cells(h, w, cy, cx, exit_locs, exit_valid, view):
    """Board cells that the views and the valid exits of all lanes cover,
    summed over lanes: what K3 must read of the boards, and as much of the
    goals."""
    b = cy.shape[0]
    vh, vw = view
    dev = cy.device
    rows = (cy[..., None] - vh // 2 + torch.arange(vh, device=dev)) % h
    cols = (cx[..., None] - vw // 2 + torch.arange(vw, device=dev)) % w
    idx = (rows[..., :, None] * w + cols[..., None, :]).reshape(b, -1)
    hit = torch.zeros((b, h * w), dtype=torch.int32, device=dev)
    hit.scatter_(1, idx.long(), 1)
    hit.scatter_reduce_(1, (exit_locs[..., 0] * w + exit_locs[..., 1]).long(),
                        exit_valid.to(torch.int32), "amax")
    return int(hit.sum())


def time_kernels(dev, pool, b):
    """Time each kernel and its plain version at the shapes of ``pool``'s
    levels (one agent, their exits, 25x25 views) for b lanes, and hold
    their outputs on these inputs against each other. Keyed by the kernel
    form each wrapper launched there."""
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
    cases = (
        (lambda: ops.fused_actions_advance(flat, locs, acts, sp, seed, **k1),
         lambda: ops.fused_actions_advance_plain(flat, locs, acts, sp, seed,
                                                 **k1),
         2 * b * hw * 4 + b * a * (2 * 2 * 4 + 4 + 4) + b * 4 + 8,
         b * hw * CA_OPS_PER_CELL + b * a * ACTION_OPS_PER_AGENT),
        (lambda: ops.advance(goals, sp, seed, **k1),
         lambda: ops.advance_plain(goals, sp, seed, **k1),
         2 * b * hw * 4 + b * 4 + 8,
         b * hw * CA_OPS_PER_CELL),
        (lambda: ops.recenter_views(state.board, state.goals, cy, cx, el, ev,
                                    view_shape=VIEW),
         lambda: ops.recenter_views_plain(state.board, state.goals, cy, cx,
                                          el, ev, view_shape=VIEW),
         2 * covered_cells(h, w, cy, cx, el, ev, VIEW) * 4 + 2 * b * a * 4
         + b * e * 9 + b * a * vh * vw * 4,
         b * a * (vh * vw * VIEW_OPS_PER_ELEMENT + e * EXIT_OPS_PER_VIEW)),
    )
    out = {}
    for kern, plain, nbytes, nops in cases:
        errs = {}
        (form,) = compare(errs, kern, plain)
        ms, how = device_ms(kern, KERNELS[form][2])
        call_ms = events_ms(kern)
        plain_ms = events_ms(plain)
        bound_ms, bound_by, bytes_ms, ops_ms = bound(nbytes, nops)
        out[form] = dict(ms=ms, timed_by=how, call_ms=call_ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
                         err=errs[form], batch=b)
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


#: Kernel form -> (source, the TPU kernel it replaces, its kernel's name in
#: the profiler).
KERNELS = {
    "fused_actions_advance": ("safelife_tpu_torch/ops/csrc/physics.cu",
                              "safelife_tpu/ops/physics.py:296",
                              "physics_kernel"),
    "fused_actions_advance_global": (
        "safelife_tpu_torch/ops/csrc/physics.cu",
        "safelife_tpu/ops/physics.py:296", "physics_global_kernel"),
    "advance": ("safelife_tpu_torch/ops/csrc/advance.cu",
                "safelife_tpu/ops/physics.py:371", "advance_kernel"),
    "advance_global": ("safelife_tpu_torch/ops/csrc/advance.cu",
                       "safelife_tpu/ops/physics.py:371",
                       "advance_global_kernel"),
    "recenter_views": ("safelife_tpu_torch/ops/csrc/obs.cu",
                       "safelife_tpu/ops/obs.py:146", "recenter_kernel"),
    "recenter_views_global": ("safelife_tpu_torch/ops/csrc/obs.cu",
                              "safelife_tpu/ops/obs.py:146",
                              "recenter_global_kernel"),
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
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  %s: %s" % (source, line.strip()))

    prune = load_levels("benchmarks/v1.0/prune-dynamic.npz")
    nav = load_levels("benchmarks/v1.0/navigation.npz")
    if len(prune) != 100 or len(nav) != 100:
        raise AssertionError("expected 100 levels per archive")

    # Phase 1
    errs = {}
    check_physics(dev, errs, np.stack([lv.board for lv in prune]),
                  np.stack([lv.agent_locs for lv in prune]).astype(np.int32))
    check_obs(dev, errs)
    missing = sorted(set(KERNELS) - set(errs))
    if missing:
        raise AssertionError("phase 1 never ran %s" % missing)

    # Phase 2
    from safelife_tpu_torch.models.nets import TRAINING_CHANNELS

    tree = random_policy_tree(np.random.default_rng(0),
                              len(TRAINING_CHANNELS), VIEW)
    net = policy(tree, dev)
    launches, main_stats = run_main_path(dev, prune, net, card)
    check_against_cpu(dev, prune, tree)

    # Phase 3
    check_stochastic(dev, nav, net)
    tiny = tiny_levels()
    check_levels_against_cpu(dev, tiny, (3, 3), "3x3 levels")
    check_levels_against_cpu(dev, tiny, VIEW, "3x3 levels")

    # Phase 4
    large = large_levels()
    large_launches = run_large_path(dev, large, net, card)
    # Without spawners: the card's and the CPU's generators draw different
    # seed words (phase 1 holds the spawn draws under one seed).
    check_levels_against_cpu(dev, large_levels(spawners=False), VIEW,
                             "%dx%d levels without spawners" % LARGE_LEVEL,
                             lanes=16, steps=10)

    # Timings at the main path's shapes (B = 512 and 4096) and at the
    # large-board path's.
    from safelife_tpu_torch.env.state import pack_levels

    pool = pack_levels(prune, device=dev)
    times = time_kernels(dev, pool, LANES)
    times_4096 = time_kernels(dev, pool, 4096)
    times_large = time_kernels(dev, pack_levels(large, device=dev),
                               LARGE_LANES)
    for tt in (times, times_4096, times_large):
        for name, t in tt.items():
            log("timing %-28s B=%-4d kernel %.5f ms (%s; %.5f ms a call "
                "with the wrapper), plain %.5f ms, bound %.5f ms (%s; bytes "
                "%.5f, operations %.5f)  [%s]"
                % (name, t["batch"], t["ms"], t["timed_by"], t["call_ms"],
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
    timed = {**times_large, **times}
    for name, (source, replaces, _) in KERNELS.items():
        t = timed[name]
        # Each form's launches on the path that runs it.
        path = large_launches if name in LARGE_PATH_FORMS else launches
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path[name],
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
