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
5. The training path: ``ppo.train_iteration`` (a wrapped rollout of 20
   steps with the inaction baseline, GAE, 3 epochs x 5 Adam minibatches)
   on the append-spawn v1.0 benchmark (100 levels, spawners, static goals)
   at 4096 lanes (the training batch) and 64 lanes (the CLI's default
   batch), with the dense-512 policy on packed 25x25 views: one warm-up
   iteration, then 3 timed ones with the launch counts zeroed just before
   and read just after (K1, K2 and K3 20 times an iteration each, no
   global form); finite losses, parameters that moved, ``num_steps``; a
   rollout and an update timed apart, and a profile of one iteration and
   of its two halves. Then the wrapped step on prune-dynamic (goals that
   evolve: K2 twice a step under the inaction baseline), 64 lanes x 40
   steps on the card against the port's CPU path under the same actions,
   both baselines, with and without resets: exact. Last, one
   ``train_on_batch`` of a 4096-lane and of a 64-lane card rollout on the
   card and on the CPU, from the parameters that collected each and with
   the same permutations: first-minibatch loss within 1e-5 relative, its
   gradients within 6e-5 of their norm, then the parameters within 5% of
   the update's norm; TF32 off in every forward and backward of every
   layer on the card.
6. The evaluation path: ``train.run_benchmark`` on the prune-spawn v1.0
   benchmark (100 levels, spawners) with the same policy, 100 episodes in
   one batch of 1000 steps, side effects scored with ``num_samples`` 1000
   and logged by ``SafeLifeLogger`` into a fresh directory under ``runs/``;
   launch counts zeroed just before and read just after (K1, K2 and K3
   ran; in the occupancy K2 exactly the pre-steps plus 2 x 1000 times);
   ``summarize_run`` of the log equals the returned summary within 1e-9;
   the batch split into rollout, occupancy (device) and EMD (host). Then
   ``batched_occupancy`` alone at 512 lanes (boards and step counts of a
   512-lane ``run_episodes``), timed with CUDA events, launches read; 64
   of those lanes on the card and on the CPU under the same seed words,
   at most 100 pre-steps and 2 x 100 occupancy steps: counts bit for bit
   and ``episode_side_effects`` of 8 of them equal.
   Last, a 32-slot ``LevelPoolManager`` of prune-dynamic levels on the
   card, refreshed with ``in_use`` from a live 64-lane ``env.step`` state:
   no busy slot changes, the pool equals ``pack_levels`` of the manager's
   levels, and pool and state round-trip through ``CheckpointManager``.

Then it times each kernel form and its plain version at the shapes of the
path that runs it (the main path's at B = 512 and 4096, the large-board
path's at B = 64), holding their outputs there against each other too, and
prints, before the last line, the card's name and power limit as
``nvidia-smi`` reports them and one ``{"kernels": [...]}`` JSON line. The
last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import re
import subprocess
import sys
import time
import warnings

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
                                   generator=gen, calc_side_effects=False,
                                   device=dev)
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


def profile_window(fn, what, per, n_per, top=10):
    """Run ``fn()`` once under the profiler and log the wall time, the
    device busy time (the union of device activity spans) and the top
    device operations, each per ``per`` (``n_per`` of them); the
    profiler's own cost inflates the wall time a little. Returns (wall us,
    busy us)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    def on_device(e):
        # A user annotation (e.g. ``Optimizer.step``) spans the device work
        # it launched, gaps included: not an activity of its own.
        return (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if on_device(e))
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    kernels = sorted(((e.device_time_total, e.count, e.key)
                      for e in prof.key_averages() if on_device(e)),
                     reverse=True)
    total = sum(k[0] for k in kernels) or 1.0
    log("profile of %s: wall %.1f us/%s, device busy %.1f us/%s (%.1f%%), "
        "%d device activities/%s"
        % (what, wall_us / n_per, per, busy / n_per, per,
           100 * busy / wall_us, len(spans) / n_per, per))
    for t, n, key in kernels[:top]:
        log("  %6.1f%% %9.1f us  x%-6d %s"
            % (100 * t / total, t / n_per, n // n_per, key[:90]))
    return wall_us, busy


def profile_rollout(dev, pool, net, lanes, steps=50):
    """Device busy share and device time by kernel over ``steps`` rollout
    steps."""
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.training import runner as R

    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None, time_limit=STEPS)
    gen = torch.Generator(device=dev).manual_seed(4)
    idx = torch.arange(lanes, device=dev) % pool.num_levels
    R.run_episodes(cfg, pool, net, idx, gen, 3)
    wall_us, busy = profile_window(
        lambda: R.run_episodes(cfg, pool, net, idx, gen, steps),
        "%d rollout steps at %d lanes" % (steps, lanes), "step", steps)
    return busy / wall_us


# ---------------------------------------------------------------------------
# Phase 5: the PPO training path


TRAIN_LEVELS = "benchmarks/v1.0/append-spawn.npz"
TRAIN_LANES = (4096, 64)
TRAIN_ITERS = 3


def training_setup(dev, levels, tree, lanes, seed):
    """The training path at full width: the inaction baseline, PPOConfig
    defaults, packed 25x25 views, the dense-512 policy from ``tree``."""
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.training import ppo as P

    pool = pack_levels(levels, device=dev)
    run = dict(
        pool=pool, cfg=E.EnvConfig(view_shape=VIEW, output_channels=None),
        wcfg=W.WrapperConfig(se_baseline="inaction"), pcfg=P.PPOConfig(),
        gen=torch.Generator(device=dev).manual_seed(seed), dev=dev)
    run["ps"] = P.init_ppo_state(run["pcfg"], policy(tree, dev), device=dev)
    run["ws"], run["obs"] = W.reset(run["cfg"], run["wcfg"], pool, lanes,
                                    device=dev)
    return run


def train_iteration(run):
    """One ``ppo.train_iteration`` of ``run`` (se_penalty_coef 1,
    min_perf_fraction 1); returns its metrics."""
    from safelife_tpu_torch.training import ppo as P

    run["ps"], run["ws"], run["obs"], metrics = P.train_iteration(
        run["cfg"], run["wcfg"], run["pcfg"], run["pool"], run["ps"],
        run["ws"], run["obs"], run["gen"], 1.0, 1.0, device=run["dev"])
    return metrics


def rollout_batch(run):
    """A rollout and GAE of ``run``, without the update: the learner
    batch."""
    from safelife_tpu_torch.training import ppo as P

    traj, (run["ws"], run["obs"]), final = P.rollout(
        run["cfg"], run["wcfg"], run["pool"], run["ps"].model, run["ws"],
        run["obs"], run["gen"], run["pcfg"].steps_per_env, 1.0, 1.0)
    return P.flatten_batch(traj, *P.compute_gae(run["pcfg"], traj, final))


def event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def run_training_path(dev, levels, tree, lanes, card):
    """Warm-up, then TRAIN_ITERS timed ``train_iteration``s with the launch
    counts zeroed just before and read just after; then a rollout and an
    update timed apart. Returns the run, the last rollout's batch and the
    parameters that collected it."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.training import ppo as P

    run = training_setup(dev, levels, tree, lanes, seed=10)
    pool, pcfg = run["pool"], run["pcfg"]
    if not pool.all_goals_static or pool.spawner_free:
        raise AssertionError("append-spawn must have static goals and "
                             "spawners")
    train_iteration(run)
    before = model_state(run)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    iter_ms = []
    for _ in range(TRAIN_ITERS):
        ms, metrics = event_ms(lambda: train_iteration(run))
        iter_ms.append(ms)
    launches = ops.launch_counts()

    steps = pcfg.steps_per_env
    expected = {"fused_actions_advance": steps * TRAIN_ITERS,
                "advance": steps * TRAIN_ITERS,
                "recenter_views": steps * TRAIN_ITERS}
    for name, n in launches.items():
        if n != expected.get(name, 0):
            raise AssertionError("training path at %d lanes launched %s %d "
                                 "times, expected %d"
                                 % (lanes, name, n, expected.get(name, 0)))
    for k in ("loss", "policy_loss", "value_loss", "entropy", "reward_mean",
              "values_mean", "advantages_mean"):
        if not torch.isfinite(metrics[k]).all():
            raise AssertionError("non-finite %s" % k)
    moved = max(float((v - before[k]).abs().max())
                for k, v in run["ps"].model.state_dict().items())
    if not moved > 0:
        raise AssertionError("the parameters did not change")
    if run["ps"].num_steps != (TRAIN_ITERS + 1) * steps * lanes:
        raise AssertionError("num_steps %d" % run["ps"].num_steps)

    state = model_state(run)
    rollout_ms, batch = event_ms(lambda: rollout_batch(run))
    update_ms, _ = event_ms(lambda: P.train_on_batch(
        pcfg, run["ps"], batch, run["gen"]))
    mean_ms = sum(iter_ms) / len(iter_ms)
    samples = pcfg.epochs_per_batch * batch["obs"].shape[0]
    log("training path (append-spawn, inaction baseline, PPOConfig "
        "defaults) at %d lanes: train_iteration %s ms (mean %.3f), rollout "
        "of %d steps %.3f ms, update (%d epochs x %d minibatches over %d "
        "samples) %.3f ms; %.0f training env-steps/s, %.0f learner "
        "samples/s; loss %.5f, entropy %.5f, max |dparam| %.3e, num_steps "
        "%d; launches %s  [%s]"
        % (lanes, ", ".join("%.3f" % m for m in iter_ms), mean_ms, steps,
           rollout_ms, pcfg.epochs_per_batch, pcfg.num_minibatches + 1,
           batch["obs"].shape[0], update_ms, steps * lanes / mean_ms * 1e3,
           samples / update_ms * 1e3, float(metrics["loss"]),
           float(metrics["entropy"]), moved, run["ps"].num_steps,
           json.dumps(launches), card))
    return run, batch, state


def profile_training(run):
    """Device busy share and top device operations of one train_iteration
    of ``run``, then of its rollout and its update apart."""
    from safelife_tpu_torch.training import ppo as P

    steps = run["pcfg"].steps_per_env
    lanes = run["obs"].shape[0]
    wall, busy = profile_window(
        lambda: train_iteration(run),
        "one train_iteration at %d lanes" % lanes, "iteration", 1, top=12)
    holder = {}
    profile_window(lambda: holder.update(batch=rollout_batch(run)),
                   "its rollout (and GAE) at %d lanes" % lanes, "step",
                   steps)
    profile_window(lambda: P.train_on_batch(run["pcfg"], run["ps"],
                                            holder["batch"], run["gen"]),
                   "its update at %d lanes" % lanes, "iteration", 1)
    return busy / wall


def check_wrapped_env_against_cpu(dev, levels, lanes=64, steps=40):
    """The wrapped step on the card against the port's CPU path on
    prune-dynamic (no spawners, goals that evolve) under the same numpy
    actions, for both baselines: with the 64-level pool and no resets, and
    with a one-level pool whose lanes reset (time limit 15). Boards, the
    ring, counts, side effects, baseline and start boards and views bit for
    bit, shaped rewards and done flags exactly. K2 runs once a step for the
    goals and once more for the inaction baseline."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels

    rng = np.random.default_rng(11)
    acts = rng.integers(0, 9, (steps, lanes, 1)).astype(np.int32)
    fields = ("prior_positions", "prior_count", "last_side_effect",
              "baseline_board", "episode_start_board")
    for baseline in ("inaction", "starting-state"):
        wcfg = W.WrapperConfig(se_baseline=baseline)
        for pool_levels, auto_reset, limit in ((levels[:lanes], False, 1000),
                                               (levels[:1], True, 15)):
            cfg = E.EnvConfig(view_shape=VIEW, output_channels=None,
                              time_limit=limit, auto_reset=auto_reset)
            runs, resets, launched = [], 0, None
            for d in (dev, torch.device("cpu")):
                before = ops.launch_counts()
                pool = pack_levels(pool_levels, device=d)
                ws, obs = W.reset(cfg, wcfg, pool, lanes, device=d)
                gen = torch.Generator(device=d).manual_seed(0)
                out = []
                for t in range(steps):
                    ws, obs, rew, done, info = W.step(
                        cfg, wcfg, pool, ws, torch.from_numpy(acts[t]).to(d),
                        gen, 1.0, 1.0)
                    out.append([x.cpu() for x in (
                        ws.env.board, ws.env.agent_locs, obs, rew, done)]
                        + [getattr(ws, f).cpu() for f in fields])
                    resets += int(info["lane_done"].sum())
                runs.append(out)
                if launched is None:
                    after = ops.launch_counts()
                    launched = {k: after[k] - before[k] for k in after
                                if after[k] > before[k]}
            want = steps * (2 if baseline == "inaction" else 1)
            if launched.get("advance") != want \
                    or launched.get("fused_actions_advance") != steps:
                raise AssertionError("wrapped step launched %s, expected K2 "
                                     "%d times" % (launched, want))
            names = ("boards", "locations", "views", "shaped rewards",
                     "done") + fields
            for t, (card, host) in enumerate(zip(*runs)):
                for name, x, y in zip(names, card, host):
                    if not torch.equal(x, y):
                        raise AssertionError(
                            "wrapped step (%s, %d levels): %s differ at "
                            "step %d" % (baseline, len(pool_levels), name, t))
            log("wrapped step on the card equals the CPU path (%s baseline, "
                "%d lanes x %d steps, %d-level pool, %d lane resets on both "
                "sides): boards, ring, counts, side effects, baseline and "
                "start boards, views, shaped rewards, done exact; launches %s"
                % (baseline, lanes, steps, len(pool_levels), resets // 2,
                   json.dumps(launched)))


def model_state(run):
    """A copy of the parameters of ``run``'s learner."""
    return {k: v.detach().clone()
            for k, v in run["ps"].model.state_dict().items()}


@contextlib.contextmanager
def tf32_probe(model):
    """Record, each time a convolution or dense layer of ``model`` runs
    forward or backward, whether TF32 was allowed for cuBLAS or cuDNN.
    Yields the list of records (True where it was)."""
    seen = []

    def record(*_):
        seen.append(torch.backends.cuda.matmul.allow_tf32
                    or torch.backends.cudnn.allow_tf32)

    handles = []
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            handles.append(m.register_forward_pre_hook(record))
            handles.append(m.register_full_backward_pre_hook(record))
    try:
        with warnings.catch_warnings():
            # conv0's input needs no gradient: its hook fires on outputs.
            warnings.filterwarnings("ignore", message="Full backward hook")
            yield seen
    finally:
        for h in handles:
            h.remove()


def learner_diffs(dev, tree, state, batch, seed=12):
    """The learner on the card against the CPU path: from parameters
    ``state`` (loaded into ``tree``'s network), the first minibatch's loss
    and gradients, then one ``train_on_batch`` of ``batch`` with the same
    permutations on both. Returns the loss's relative difference; the
    gradients' difference over all parameters (norm), and per tensor (the
    largest norm ratio, and the largest element over the tensor's largest
    magnitude); the parameters' difference after the update, as a norm
    over the norm of the update, its largest element and how many differ
    by more than 1e-5; and, on the card, how many layer runs (forward and
    backward) allowed TF32, of how many."""
    from safelife_tpu_torch.models import nets
    from safelife_tpu_torch.training import ppo as P

    cfg = P.PPOConfig()
    n = batch["obs"].shape[0]
    rng = np.random.default_rng(seed)
    perms = [rng.permutation(n) for _ in range(cfg.epochs_per_batch)]
    first = torch.from_numpy(perms[0][slice(*P._minibatch_bounds(
        n, cfg.num_minibatches)[0])])
    sides = []
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        net = policy(tree, d)
        net.load_state_dict(state)
        b = {k: v.to(d) for k, v in batch.items()}
        mb = {k: v.index_select(0, first.to(d)) for k, v in b.items()}
        with tf32_probe(net) as tf32:
            with nets.strict_float32():
                loss, _ = P.calculate_loss(
                    cfg, net, mb["obs"], mb["actions"], mb["action_prob"],
                    mb["values"], mb["returns"], mb["advantages"],
                    mb["weight"])
                loss.backward()
            grads = {k: p.grad.detach().cpu()
                     for k, p in net.named_parameters()}
            net.zero_grad(set_to_none=True)
            P.train_on_batch(cfg, P.init_ppo_state(cfg, net, device=d), b,
                             None, perms=perms)
        sides.append((loss.item(), grads, tf32,
                      {k: v.cpu() for k, v in net.state_dict().items()},
                      time.perf_counter() - t0))
    (lc, gc, tf32, pc, card_s), (lh, gh, _, ph, cpu_s) = sides

    def flat(tree_):
        return torch.cat([tree_[k].flatten() for k in gh]).double()

    g_diff, g_ref = flat({k: gc[k] - gh[k] for k in gh}), flat(gh)
    p_diff = flat({k: pc[k] - ph[k] for k in gh})
    moved = flat({k: ph[k] - state[k].cpu() for k in gh})
    return {
        "loss": abs(lc - lh) / max(abs(lh), 1e-30),
        "grad_norm": float(g_diff.norm() / g_ref.norm()),
        "grad_tensor_norm": max(float((gc[k] - gh[k]).norm() / gh[k].norm())
                                for k in gh),
        "grad_tensor_max": max(float((gc[k] - gh[k]).abs().max()
                                     / gh[k].abs().max()) for k in gh),
        "update_norm": float(p_diff.norm() / moved.norm()),
        "param_max": float(p_diff.abs().max()),
        "params_over_1e-5": int((p_diff.abs() > 1e-5).sum()),
        "params": p_diff.numel(),
        "tf32_layer_runs": sum(tf32),
        "layer_runs": len(tf32),
        "steps": cfg.epochs_per_batch * (cfg.num_minibatches + 1),
        "card_s": card_s,
        "cpu_s": cpu_s,
    }


def learner_line(r):
    return ("first-minibatch loss rel %.2e, gradients |dg| / |g| %.2e (per "
            "tensor: norm %.2e, max element / max |g| %.2e); parameters "
            "after %d Adam steps: |dp| / |update| %.2e, max |dp| %.2e, %d "
            "of %d above 1e-5; TF32 allowed in %d of %d layer runs on the "
            "card; %.1f s on the card, %.1f s on the CPU"
            % (r["loss"], r["grad_norm"], r["grad_tensor_norm"],
               r["grad_tensor_max"], r["steps"], r["update_norm"],
               r["param_max"], r["params_over_1e-5"], r["params"],
               r["tf32_layer_runs"], r["layer_runs"], r["card_s"],
               r["cpu_s"]))


#: The learner check's bounds (``check_learner_against_cpu``). Over 48
#: batches at 64 lanes and 7 at 4096 (``chip_sweep.py learner`` and
#: ``learner-4096``, and this script) strict float32 put the gradients at
#: most 2.2e-5 of their norm apart and TF32 at least 1.8e-4: the gradient
#: bound lies between, near their geometric mean. The update's norm ratio
#: of the two overlaps (strict up to 9.2e-3, TF32 from 3.2e-3), so its
#: bound catches gross faults only.
LEARNER_LOSS_REL = 1e-5
LEARNER_GRAD_NORM = 6e-5
LEARNER_UPDATE_NORM = 5e-2


def check_learner_against_cpu(dev, tree, state, batch, card):
    """The learner on the card against the CPU path from the parameters
    that collected ``batch`` (``learner_diffs``): TF32 off in every
    forward and backward run of every convolution and dense layer on the
    card; the first minibatch's loss within 1e-5 relative and its
    gradients within 6e-5 of their norm, which TF32 misses; the parameters
    after the 15 Adam steps within 5% of the update's norm.

    Why norms and not elements: an activation or a clip within float32
    rounding of its threshold can take the other branch on the other
    device, and Adam turns a rounding difference in a gradient near zero
    into a whole step of the learning rate. In strict float32 a few
    batches in a hundred then show one tensor's gradient up to 1e-3 of its
    largest element apart, or thousands of parameters up to 6e-4 apart
    after 15 steps (``chip_sweep.py learner``). The layer probe is a second
    witness of TF32."""
    r = learner_diffs(dev, tree, state, batch)
    log("learner on the card vs the CPU (%d samples of a card rollout): %s"
        "  [%s]" % (batch["obs"].shape[0], learner_line(r), card))
    if r["tf32_layer_runs"] or not r["layer_runs"]:
        raise AssertionError("TF32 was allowed in %d of %d layer runs"
                             % (r["tf32_layer_runs"], r["layer_runs"]))
    if r["loss"] > LEARNER_LOSS_REL or r["grad_norm"] > LEARNER_GRAD_NORM \
            or r["update_norm"] > LEARNER_UPDATE_NORM:
        raise AssertionError("the learner on the card differs from the CPU "
                             "path beyond its tolerance")


# ---------------------------------------------------------------------------
# Phase 6: the evaluation path


EVAL_LEVELS = "benchmarks/v1.0/prune-spawn.npz"
#: Benchmark episodes: the 100 levels once, in one batch of 100 lanes.
EVAL_EPISODES = 100
EVAL_SAMPLES = 1000
OCC_LANES = 512
OCC_CPU_LANES = 64
#: Pre-steps (at most) and occupancy samples of the card-vs-CPU check: the
#: same kernel at the same shape as the full run, with fresh seed words
#: every step, at a tenth of the CPU's time.
OCC_CPU_STEPS = 100
#: Card-vs-CPU lanes whose EMD is computed from both sides' counts.
EMD_CHECK_LANES = 8
POOL_SLOTS = 32
POOL_LANES = 64


@contextlib.contextmanager
def timed_calls(module, names):
    """Wrap ``module``'s functions ``names`` (looked up at call time by the
    module's own code) so that each call is timed on the host clock between
    two ``torch.cuda.synchronize()``; yields {name: [seconds of each call]}
    and, under ``name + ":launches"``, the kernel launches of each call."""
    from safelife_tpu_torch import ops

    record = {}
    originals = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            before = ops.launch_counts()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record.setdefault(name, []).append(time.perf_counter() - t0)
            after = ops.launch_counts()
            record.setdefault(name + ":launches", []).append(
                {k: after[k] - before[k] for k in after
                 if after[k] > before[k]})
            record.setdefault(name + ":args", []).append((args, kwargs))
            return out
        return timed

    for name, fn in originals.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield record
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def eval_bundle(levels):
    """The evaluation bundle of a prune-spawn run: packed 25x25 views, the
    1000-step time limit, the tasks' side-effect weights."""
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.loggers import SafeLifeLogger
    from safelife_tpu_torch.models.nets import TRAINING_CHANNELS
    from safelife_tpu_torch.training import env_factory as F

    return F.EnvBundle(
        env_cfg=E.EnvConfig(view_shape=VIEW, output_channels=None,
                            time_limit=STEPS),
        wrapper_cfg=W.WrapperConfig(), pool_manager=None,
        training_logger=SafeLifeLogger(None), se_penalty_schedule=None,
        exit_difficulty_schedule=None, validation_levels=[],
        benchmark_levels=levels,
        side_effect_weights=dict(F.SIDE_EFFECT_WEIGHTS),
        obs_channels=TRAINING_CHANNELS)


def occupancy_launches(call_launches, call_args):
    """K2's launches in each ``batched_occupancy`` call, and what each call
    must launch: its pre-steps (the largest step count, at most
    ``max_pre_steps``) plus 2 x ``num_samples``."""
    got, want = [], []
    for launches, (args, kwargs) in zip(call_launches, call_args):
        if kwargs["num_samples"] != EVAL_SAMPLES:
            raise AssertionError("the benchmark scored %d samples"
                                 % kwargs["num_samples"])
        steps = int(torch.as_tensor(args[2]).max())
        want.append(min(steps, kwargs["max_pre_steps"])
                    + 2 * kwargs["num_samples"])
        got.append(launches.get("advance", 0))
        other = set(launches) - {"advance"}
        if other:
            raise AssertionError("the occupancy launched %s" % sorted(other))
    return got, want


def run_evaluation_path(dev, levels, net, card):
    """``train.run_benchmark`` on prune-spawn: EVAL_EPISODES episodes in one
    batch, side effects scored, logged by ``SafeLifeLogger`` into a fresh
    directory under ``runs/``. Launch counts zeroed just before and read
    just after; the batch timed by parts."""
    import os
    import tempfile

    from safelife_tpu_torch import ops
    from safelife_tpu_torch.loggers import summarize_run
    from safelife_tpu_torch.training import runner as R, train as T

    bundle = eval_bundle(levels)
    os.makedirs("runs", exist_ok=True)
    data_dir = tempfile.mkdtemp(prefix="chip-smoke-eval-", dir="runs")
    gen = torch.Generator(device=dev).manual_seed(20)
    parts = ("run_episodes", "batched_occupancy", "episode_side_effects")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with timed_calls(R, parts) as rec:
        t0 = time.perf_counter()
        summary = T.run_benchmark(net, bundle, data_dir, gen,
                                  num_episodes=EVAL_EPISODES, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()

    if summary["episodes"] != EVAL_EPISODES or len(rec["run_episodes"]) != 1:
        raise AssertionError("the benchmark played %d episodes in %d "
                             "batches" % (summary["episodes"],
                                          len(rec["run_episodes"])))
    for k, v in summary.items():
        if not np.isfinite(v):
            raise AssertionError("non-finite summary %s" % k)
    for name in ("fused_actions_advance", "advance", "recenter_views"):
        if launches[name] == 0:
            raise AssertionError("kernel %s was never launched on the "
                                 "evaluation path" % name)
    for name in LARGE_PATH_FORMS:
        if launches[name]:
            raise AssertionError("kernel %s ran on 26x26 boards" % name)
    got, want = occupancy_launches(rec["batched_occupancy:launches"],
                                   rec["batched_occupancy:args"])
    if got != want:
        raise AssertionError("the occupancy launched K2 %s times, expected "
                             "%s" % (got, want))
    # prune-spawn's goals are static: the rollout launches no K2.
    if launches["advance"] != sum(want):
        raise AssertionError("K2 launched %d times, the occupancy %d"
                             % (launches["advance"], sum(want)))
    with open(os.path.join(data_dir, "benchmark-data.json")) as f:
        logged = json.load(f)
    if len(logged) != EVAL_EPISODES or not all(
            "total" in e["side_effects"] for e in logged):
        raise AssertionError("benchmark-data.json holds %d episodes"
                             % len(logged))
    read = summarize_run(data_dir)["benchmark-data.json"]
    worst = max(abs(read[k] - summary[k]) for k in read)
    if worst > 1e-9:
        raise AssertionError("summarize_run differs from the summary by %g"
                             % worst)

    t_roll = sum(rec["run_episodes"])
    t_occ = sum(rec["batched_occupancy"])
    t_emd = sum(rec["episode_side_effects"])
    log("evaluation path (train.run_benchmark, prune-spawn v1.0, %d "
        "episodes in one batch, %d steps, num_samples %d): %.3f s = %.3f "
        "evaluation episodes/s; rollout %.3f s, occupancy (device, K2 %d "
        "launches = %d pre-steps + 2 x %d) %.3f s, EMD (host, %d episodes) "
        "%.3f s, the rest %.3f s  [%s]"
        % (EVAL_EPISODES, STEPS, EVAL_SAMPLES, wall, EVAL_EPISODES / wall,
           t_roll, got[0], got[0] - 2 * EVAL_SAMPLES, EVAL_SAMPLES, t_occ,
           len(rec["episode_side_effects"]), t_emd,
           wall - t_roll - t_occ - t_emd, card))
    log("evaluation summary prune-spawn (random policy): reward fraction "
        "%.4f, success %.4f, mean length %.1f, side effects %.4f, score "
        "%.3f; summarize_run(%s) within %.1e; launches %s  [%s]"
        % (summary["reward"], summary["success"], summary["avg_length"],
           summary["side_effects"], summary["score"], data_dir, worst,
           json.dumps(launches), card))
    return {"episodes_per_s": EVAL_EPISODES / wall, "wall_s": wall,
            "rollout_s": t_roll, "occupancy_s": t_occ, "emd_s": t_emd}


def occupancy_inputs(dev, levels, net, lanes):
    """Initial boards, final boards, step counts and spawn probabilities of
    a ``lanes``-lane ``run_episodes`` on ``levels`` (lane i plays level
    i mod 100)."""
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.training import runner as R

    pool = pack_levels(levels, device=dev)
    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None, time_limit=STEPS)
    idx = torch.arange(lanes, device=dev) % pool.num_levels
    out = R.run_episodes(cfg, pool, net, idx,
                         torch.Generator(device=dev).manual_seed(21), STEPS)
    return (pool.board.index_select(0, idx), out["final_board"],
            out["final_steps"], pool.spawn_prob.index_select(0, idx))


def check_occupancy(dev, levels, net, card):
    """``batched_occupancy`` alone at OCC_LANES lanes, timed with CUDA events
    and its launches read; then OCC_CPU_LANES of those lanes on the card
    and on the CPU under the same seed words, OCC_CPU_STEPS pre-steps at
    most and OCC_CPU_STEPS samples: counts bit for bit, and
    ``episode_side_effects`` of EMD_CHECK_LANES of them equal."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.env.env import seed_words
    from safelife_tpu_torch.training import runner as R

    init, final, steps, sp = occupancy_inputs(dev, levels, net, OCC_LANES)
    n_seeds = STEPS + 2 * EVAL_SAMPLES
    gen = torch.Generator(device=dev).manual_seed(22)
    seeds = seed_words(gen, n_seeds, dev)
    kw = dict(num_samples=EVAL_SAMPLES, max_pre_steps=STEPS)
    R.batched_occupancy(init[:8], final[:8], steps[:8], sp[:8], None,
                        num_samples=2, max_pre_steps=2, seeds=seeds)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ms, (inaction, action) = event_ms(lambda: R.batched_occupancy(
        init, final, steps, sp, None, seeds=seeds, **kw))
    launches = ops.launch_counts()
    n_pre = min(int(steps.max()), STEPS)
    if launches["advance"] != n_pre + 2 * EVAL_SAMPLES or any(
            v for k, v in launches.items() if k != "advance"):
        raise AssertionError("batched_occupancy launched %s, expected K2 "
                             "%d times" % (launches,
                                           n_pre + 2 * EVAL_SAMPLES))
    for occ in (inaction, action):
        if occ.shape != init.shape + (8,) or occ.dtype != torch.int32 \
                or int(occ.min()) < 0 or int(occ.max()) > EVAL_SAMPLES:
            raise AssertionError("occupancy counts out of range")
    log("batched_occupancy at %d lanes (%d pre-steps + 2 x %d occupancy "
        "steps, 26x26): %.3f ms (CUDA events), %.2f us a K2 step; "
        "launches %s  [%s]"
        % (OCC_LANES, n_pre, EVAL_SAMPLES, ms,
           1e3 * ms / launches["advance"], json.dumps(launches), card))

    n = OCC_CPU_LANES
    n_cmp = OCC_CPU_STEPS + 2 * OCC_CPU_STEPS
    sides = []
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        args = [x[:n].to(d) for x in (init, final, steps, sp)]
        occ = R.batched_occupancy(*args, None, seeds=seeds[:n_cmp].to(d),
                                  num_samples=OCC_CPU_STEPS,
                                  max_pre_steps=OCC_CPU_STEPS)
        sides.append([x.cpu().numpy() for x in occ])
        if d.type == "cuda":
            torch.cuda.synchronize()
        sides[-1].append(time.perf_counter() - t0)
    (ci, ca, card_s), (hi, ha, cpu_s) = sides
    if not (np.array_equal(ci, hi) and np.array_equal(ca, ha)):
        raise AssertionError("occupancy counts on the card differ from the "
                             "CPU path")
    host = [x[:n].cpu().numpy() for x in (init, final, steps, sp)]
    worst = 0.0
    for lane in range(EMD_CHECK_LANES):
        res = [R.episode_side_effects(
            host[0][lane], host[1][lane], int(host[2][lane]),
            float(host[3][lane]), i[lane], a[lane], OCC_CPU_STEPS,
            side_effect_weights={"life-green": 1.0, "spawner-yellow": 2.0})
            for i, a in ((ci, ca), (hi, ha))]
        if set(res[0]) != set(res[1]):
            raise AssertionError("side-effect types differ")
        for k in res[0]:
            worst = max(worst, float(np.abs(np.subtract(res[0][k],
                                                        res[1][k])).max()))
    if worst:
        raise AssertionError("episode_side_effects differ by %g" % worst)
    log("occupancy on the card vs the CPU path (%d lanes, at most %d "
        "pre-steps + 2 x %d occupancy steps, the same %d seed words): counts "
        "bit for bit (%d occupied cell-colours), episode_side_effects of %d "
        "lanes equal; %.1f s on the card, %.1f s on the CPU"
        % (n, OCC_CPU_STEPS, OCC_CPU_STEPS, n_cmp,
           int((ci > 0).sum() + (ca > 0).sum()), EMD_CHECK_LANES, card_s,
           cpu_s))
    return ms


class _LevelList:
    """An iterator over a list of levels (no worker processes)."""

    def __init__(self, levels):
        self.levels = list(levels)

    def __next__(self):
        if not self.levels:
            raise StopIteration
        return self.levels.pop(0)


def check_pool_manager(dev, levels):
    """A POOL_SLOTS-slot ``LevelPoolManager`` of prune-dynamic levels on the
    card, fed from the rest of the 100: a live POOL_LANES-lane
    ``env.step`` state on three quarters of the slots, a refresh with
    ``in_use`` from it; no busy slot changes, the pool equals
    ``pack_levels`` of the manager's levels, the state steps on, and the
    pool and the state round-trip through ``CheckpointManager``."""
    import dataclasses
    import tempfile

    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.io.iterator import LevelPoolManager
    from safelife_tpu_torch.training.checkpoints import CheckpointManager

    mgr = LevelPoolManager(_LevelList(levels), pool_size=POOL_SLOTS,
                           device=dev)
    pool = mgr.pool
    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None)
    gen = torch.Generator(device=dev).manual_seed(23)
    live = 3 * POOL_SLOTS // 4
    state = E.reset_batch(cfg, pool,
                          torch.arange(POOL_LANES, device=dev) % live)
    with torch.no_grad():
        for _ in range(5):
            acts = torch.randint(0, 9, (POOL_LANES, 1), generator=gen,
                                 device=dev)
            state, *_ = E.step(cfg, pool, state, acts, gen)
    fields = [f.name for f in dataclasses.fields(pool)
              if isinstance(getattr(pool, f.name), torch.Tensor)]
    before = {f: getattr(pool, f).clone() for f in fields}
    names = [lv.name for lv in mgr._host_levels]
    in_use = state.level_idx
    busy = sorted(set(in_use.cpu().tolist()))
    swapped = mgr.refresh(2 * (POOL_SLOTS - live), in_use=in_use)
    if mgr.pool is not pool or swapped != POOL_SLOTS - live:
        raise AssertionError("refresh swapped %d levels" % swapped)
    for s in busy:
        if mgr._host_levels[s].name != names[s] or any(
                not torch.equal(getattr(pool, f)[s], before[f][s])
                for f in fields):
            raise AssertionError("refresh changed busy slot %d" % s)
    ref = pack_levels(mgr._host_levels, pool.num_agents,
                      pool.exit_locs.shape[1], device=dev)
    for f in fields:
        if not torch.equal(getattr(pool, f), getattr(ref, f)):
            raise AssertionError("pool %s differs from pack_levels of the "
                                 "manager's levels" % f)
    with torch.no_grad():
        state, *_ = E.step(cfg, pool, state, acts, gen)

    ckpt = CheckpointManager(tempfile.mkdtemp(prefix="chip-smoke-ckpt-",
                                              dir="runs"))
    ckpt.save(1, {"pool": pool, "env_state": state}, {"training_steps": 1})
    restored, extra, _ = ckpt.restore(device=dev)
    rpool = mgr.restore_pool(restored["pool"])
    for f in fields:
        if not torch.equal(getattr(rpool, f), getattr(ref, f)):
            raise AssertionError("restored pool %s differs" % f)
    for f in dataclasses.fields(state):
        if not torch.equal(getattr(restored["env_state"], f.name),
                           getattr(state, f.name)):
            raise AssertionError("restored env state %s differs" % f.name)
    if extra != {"training_steps": 1} or rpool.board.device != pool.device:
        raise AssertionError("checkpoint extra or device differs")
    log("LevelPoolManager on the card: %d slots, %d live lanes on %d busy "
        "slots, refresh swapped %d levels into free slots, no busy slot "
        "changed, pool equals pack_levels of its levels; pool and env state "
        "round-trip CheckpointManager exactly" % (POOL_SLOTS, POOL_LANES,
                                                  len(busy), swapped))



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

    # Phase 5
    spawn = load_levels(TRAIN_LEVELS)
    if len(spawn) != 100:
        raise AssertionError("expected 100 append-spawn levels")
    learner_batches = []
    for lanes in TRAIN_LANES:
        run, batch, state = run_training_path(dev, spawn, tree, lanes,
                                              card)
        profile_training(run)
        del run
        learner_batches.append((batch, state))
    check_wrapped_env_against_cpu(dev, prune)
    # At 4096 lanes cuDNN takes the FFT and wgrad_alg0 engines of the
    # main path's 16,384-sample minibatches; at 64 lanes, others.
    for batch, state in learner_batches:
        check_learner_against_cpu(dev, tree, state, batch, card)

    # Phase 6
    prune_spawn = load_levels(EVAL_LEVELS)
    if len(prune_spawn) != 100:
        raise AssertionError("expected 100 prune-spawn levels")
    run_evaluation_path(dev, prune_spawn, net, card)
    check_occupancy(dev, prune_spawn, net, card)
    check_pool_manager(dev, prune)

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
