"""Drive the PyTorch/CUDA port on one NVIDIA card and check its kernels.

    python3 chip_smoke.py

from the root of a checkout, on a host with a CUDA card and ``nvcc``. It
imports torch, numpy and ``safelife_tpu_torch``, never JAX nor
``safelife_tpu``, and runs in phases; any failure raises and exits
non-zero:

0. Environment: the card, its power limit, torch, CUDA and nvcc versions;
   builds the kernels from ``safelife_tpu_torch/ops/csrc`` (one library a
   source, each holding a staged form and one for shapes too large to
   stage whole: K1 and K2 tiled, K3 windowed).
1. Each kernel form against its plain PyTorch version on the card, bit for
   bit, on seeded random soups and real level boards: K1
   ``fused_actions_advance`` and K2 ``advance`` on boards (1,4), (2,5),
   (3,3), (4,4), (7,13), (26,26), (33,40) and (96,128) x B in {1, 7, 512,
   4096} (staged), and (112,112), (6,2100), (128,128), (3,4200) and
   (131,97) x B in {1, 7, 64} (above MAX_CELLS: the tiled form), K1 with
   1-3 adjacent agents, both deterministic and with Philox spawns at p in
   {0, 0.3, 1}, and on the large boards K1 with 2 and 3 agents in a line
   across a tile edge or the wrap, acting into one another
   (``edge_boards``); K1 and K2 at non-zero counter offsets in both forms
   (slices of a 4096-lane batch of 26x26 boards, of a 64-lane batch of
   112x112 boards and of an 8-lane batch of 192x192 boards, each launched
   at its first lane as ``lane_offset``, equal the whole batch's launch;
   K2 on halo slabs of a board at ``cell_offset``, the row-sharded
   advance's 98x192 ones among them, equals those rows of the whole
   board's step, the toroidal wrap included); K3
   ``recenter_views`` for views (25,25), (15,15), (7,9) on 26x26 boards,
   views larger than the board ((25,25) on 3x3, (15,15) on 10x12, (7,6) on
   6x6), and (25,25) on 192x192 boards (too large to stage: the windowed
   form), each x A in {1,3} x E in {0,1,2}, and (3,3) on 3x3; the windowed
   form also on 173x173 (just above the staging limit), 12x2600 (a view
   taller than the board), 191x157 and the boards above MAX_CELLS named
   above x B in {1, 7, 64} x A in {1,3} x E in {0,1,2}, view centres and
   exits on the wrap edges and corners. K4 ``unpack_planes`` at N in {1,
   25, 64, 96, 100, 512, 4097, 16384} (the widths the phases run it at)
   x views (25,25) and (7,9) x three channel sets (the training channels,
   the top byte with bit 0, every bit) on random words over all 32 bits,
   the floats' bits compared.
2. The main path: the prune-dynamic v1.0 benchmark (100 levels) through
   ``run_episodes`` at 512 lanes x 1000 steps and ``benchmark`` over the
   100 levels, with the 25x25 / dense-512 policy on packed observations
   from seeded parameters in the JAX package's layout. Launch counts are
   zeroed just before and read just after; each kernel must have run, K4
   once a step. A
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
   policy, counts zeroed just before and read just after; the tiled forms
   of K1 and K2 and the windowed form of K3 must have run, and no
   staged K1 or K2. Then 16 lanes x 10 steps of
   such levels without spawners (the card's and the CPU's generators draw
   different seeds) on the card against the port's CPU path.
5. The training path: ``ppo.train_iteration`` (a wrapped rollout of 20
   steps with the inaction baseline, GAE, 3 epochs x 5 Adam minibatches)
   on the append-spawn v1.0 benchmark (100 levels, spawners, static goals)
   at 4096 lanes (the training batch) and 64 lanes (the CLI's default
   batch), with the dense-512 policy on packed 25x25 views: one warm-up
   iteration, then 3 timed ones with the launch counts zeroed just before
   and read just after (K1, K2 and K3 20 times an iteration each, no
   global form, K4 once a policy forward: 41 an iteration); finite
   losses, parameters that moved, ``num_steps``; a rollout and an update
   timed apart, and a profile of one iteration and
   of its two halves. Then the wrapped step on prune-dynamic (goals that
   evolve: K2 twice a step under the inaction baseline), 64 lanes x 40
   steps on the card against the port's CPU path under the same actions,
   both baselines, with and without resets: exact. Last, one
   ``train_on_batch`` of a 4096-lane and of a 64-lane card rollout on the
   card and on the CPU, from the parameters that collected each and with
   the same permutations: first-minibatch loss within 1e-5 relative; the
   samples whose ReLUs, policy clip, value term and entropy clamp take
   another branch on the two devices excluded (at most 1% of the
   minibatch), the loss of the others within 1e-5 relative and their
   gradients within 6e-5 of their norm; then the parameters within 5% of
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
7. The trainer, after phase 6 (the procgen workers fork from a process
   that holds a CUDA context): 8 append-still levels from 4 forked workers
   equal 8 made in the process, byte for byte; ``build_environments`` for
   append-still at 64 and 4096 lanes (start-up pools of 128 and 256
   generated levels), timed, each with one ``refresh(4, in_use=...)``;
   ``train.train_ppo`` at 4096 lanes for one chunk of 8 iterations with a
   validation run, split into training, refresh, report and validation;
   then the CLI in this process, ``__main__.main(["train",
   "runs/chip-smoke-train-<pid>", "-e", "append-still", "--batch", "64",
   "--steps", "20480", "--seed", "1", "--benchmark-episodes", "8"])``:
   ``num_steps``, finite parameters, logs, a checkpoint, ``summarize_run``
   equal to the returned summary; the same command to 30720 steps resumes
   the learner, the env state and the pool; ``--run-type benchmark`` reads
   the checkpoint back. Around each run the launch counts are zeroed and
   read, and must equal what the code launches for the calls the run made
   (``predicted_launches``).
8. The DQN path: ``dqn.collect_and_optimize`` on phase 5's append-spawn
   levels with the inaction baseline, at 64 and 4096 lanes, with the Q
   network (dueling heads of 256) on packed 25x25 views and
   ``DQNConfig()``'s 100,000-entry replay and batch of 96, cut:
   ``replay_initial`` to min(4096, 16 x lanes) and ``target_update_interval``
   to min(10,000, 16 x lanes). A warm-up chunk of 32 units, each checked:
   ``replay.idx`` grows by the valid emissions, the parameters stay while
   the buffer is cold and move once it is warm, the target equals the
   model right after a crossing and differs on a warm unit before one,
   finite loss, TF32 off in every forward and backward of both networks.
   Then one ``dqn.train_chunk`` of 32 units, launch counts zeroed just
   before and read just after (equal to ``predicted_launches``), CUDA
   events around its collect and optimize halves. Then 8 units at 64
   lanes on the card and on the CPU under the same actions and sample
   indices (one prune-dynamic level, lanes timing out after 5 steps):
   replay and ``idx`` bit for bit, the first warm unit's loss within 1e-5
   relative and gradients within 6e-5 of their norm. Last the CLI with
   ``--algo dqn`` at 64 lanes into ``runs/chip-smoke-dqn-<pid>``: train
   20,480 steps (``replay_initial`` 4096), resume to 30,720 (learner,
   target network, Adam, env state and pool restored) and ``--run-type
   benchmark --algo dqn``, each run's launches equal to
   ``predicted_launches``.
9. The front end: ``registry.make("safelife-append-still-v1",
   batch_size=64, auto_reset=False)`` on the card against the same on the
   CPU (equal generated pools, then 200 steps of the same NumPy actions:
   observations, rewards, done flags and boards exact; K1/K2/K3 launches
   equal to ``make_launches``); ``make("safelife-prune-spawn-v1")`` with
   auto-reset at 512 and 4096 lanes, a reset and 200 steps timed with
   ``torch.cuda.synchronize()`` in turns with the bare ``env.step`` on the
   same pool (actions already on the card), launches equal to
   ``make_launches``; an ``interactive.GameLoop`` on the card and one on
   the CPU played by ``PLAY_KEYS`` to the end of a 26x26 level without
   spawners, their end-of-level summaries within 1e-9, the card's K2
   launches equal to the occupancy's pre-steps plus 2 x 200, timed; a
   1000-step history recorded on the card rendered by
   ``render/graphics.render_board`` there and on the host (equal frames,
   frames/s of each; no ``imageio``); ``variants.advance_board_general``
   on the card against the CPU at ``spawn_prob`` 0.
10. The modes the trainer once refused. Precision: phase 5's training
   iteration at 4096 and 64 lanes under ``float32``, ``tensorfloat32`` and
   ``bfloat16`` (a warm-up and 2 timed iterations, launches K1-K3 20 an
   iteration and K4 41, a rollout and an update timed apart, a profile of the
   update); each new mode's first-minibatch loss and gradients against
   strict float32 on the card (``MODE_BOUNDS``; the layer probe sees TF32
   exactly under ``tensorfloat32`` and bfloat16 layer outputs under
   ``bfloat16``), and at 64 lanes the card against the CPU in that mode.
   Channels (``packed_obs`` false): 200 steps of prune-dynamic at 64 lanes,
   uint8 channels and boards card vs CPU exact, launches as derived; a PPO
   iteration and a 32-unit DQN chunk (100,000-entry replay) at 4096 lanes
   in turns with the packed mode, their observation bytes, and the same
   loss from both forms of the same samples. The oracle step: 100 steps of
   a 26x26 board with spawners on the card and the CPU from equal PCG64
   states, boards and states equal. Device procgen: ``gen_games_batched``
   for append-still at batches 8 and 256 beside the host generator (one
   process, 4 forked workers), every level checked for its still-life
   invariant. The CLI at 64 lanes, 20,480 steps and an 8-episode
   benchmark, once with ``-x '{"train.precision": "bfloat16",
   "env.packed_obs": false}'`` and once with ``-x '{"env.device_procgen":
   64, "env.pool_size": 64}'`` (its start-up and each 64-level device
   round timed); each run
   logs, checkpoints and benchmarks with launches equal to
   ``predicted_launches``.

11. Multi-process training (``safelife_tpu_torch/parallel``). Each helper
   of ``parallel/mesh.py`` on CUDA tensors in an NCCL group of one rank,
   against the identity it must give there. Two rank processes (the
   ``spawn`` method, each under a time limit) on the one card over
   ``gloo``, 2 x 2048 lanes of the 4096-lane training cell on
   append-spawn (25x25 views, the inaction baseline), against this
   process on all 4096: K1 and K2 timed at each rank's lanes; 200 wrapped
   steps, every step's boards, views, rewards and done flags equal lane
   for lane (64-bit fingerprints); a warm-up and a timed
   ``ppo.train_iteration`` (``PPOConfig()``), the first rollout's loss
   within 1e-5 relative, the parameters bitwise equal on the ranks and
   within ``P11_UPDATE_NORM`` of the update's norm of this process's, the
   all-reduces timed, each rank's K1-K3 launches 20 an iteration and K4
   41; a
   32-unit DQN chunk with ``DQNConfig()``'s 100,000-view replay, every
   rank's replay equal to this process's row for row, the Q parameters
   bitwise equal on the ranks and within ``P11_DQN_MAX_ABS`` of this
   process's; 100 stochastic steps of a 192x192 board with spawners
   row-sharded over the ranks (K2 on halo slabs) equal to 100 K2 steps of
   the whole board. Then the CLI under ``torchrun --nproc-per-node 1``
   (NCCL): ``train runs/chip-smoke-torchrun-<pid> -e append-still
   --batch 64 --steps 10240 --skip-benchmark -x '{"env.pool_size":
   32}'``, then the same to 20480
   (the reports' ``pcheck``, the checkpoint restored). With two cards or
   more, the iteration under NCCL, one rank a card; otherwise it prints
   ``{"nccl_two_ranks": "not run: 1 card"}``.

12. The bench verb and flax's init. ``python -m safelife_tpu_torch bench``
   at its headline (append-still v1.0, 4096 lanes, 100-step chunks, a
   warm-up and 20 timed ones, packed and channels views) as a subprocess:
   one stdout line with ``metric``, ``value`` and ``unit``, the sidecar
   (``runs/chip-smoke-bench-<pid>.json``) with both modes, each mode's timed chunks launching K1 and K3 once a
   step and K2 never, and K3 once at the reset. One bench chunk in this
   process, launch counts zeroed just before and read just after (the
   ``kernels`` line's ``launches_bench``). 64 lanes x 50 steps of the
   bench's loop on the card and on the CPU under the same injected base
   actions, on one append-still level with lanes timing out every 15
   steps: every step's checksum and reward sum and the final boards bit
   for bit, in both modes. Both networks built by ``train.build_model``
   on the card under ``train.torch_init: false``: zero biases, weights
   inside the truncation at two scales, each large layer's std within 5%
   of sqrt(1 / fan_in).

Between phases 9 and 10 it times each kernel form and its plain version
at the shapes of the path that runs it (the main path's at B = 512 and
4096, the large-board path's at B = 64), holding their outputs there
against each other too (a kernel's time is the profiler's device time, or
a CUDA graph's on the device's clock, or "not timed": ``device_ms``), K4
at 25, 4096 and 16,384 samples beside its bound, its plain version and
the parent's ``unpack_obs``, then the policy's forward at 16,384 samples
on K4 against the parent's chain (bit for bit, one K4 launch) with both
forwards profiled, and prints, before the last line, the card's name and
power limit as ``nvidia-smi`` reports them and one ``{"kernels": [...]}`` JSON line (each
form's ``launches`` on its path and ``launches_bench`` in phase 12's
chunk). The last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from perfbench import peaks
from perfbench.peaks import (ACTION_OPS_PER_AGENT, CA_OPS_PER_CELL,
                             HBM_BYTES_PER_S, INT32_OPS_PER_S, view_work)

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
#: Boards above MAX_CELLS (the tiled form of K1 and K2): square, far from
#: square (cut into columns of tiles), a power of two, fewer than 4 rows
#: (an action's cells alias across the wrap, the halo rows wrap onto the
#: tile), and an odd width whose tiles do not divide the board (4-byte
#: copies, ragged tiles).
LARGE_SHAPES = ((112, 112), (6, 2100), (128, 128), (3, 4200), (131, 97))
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


def policy(tree, device, precision="float32", channels=False):
    """The dense-512 policy of ``tree`` in ``precision``, on packed views
    or, with ``channels``, on uint8 channels."""
    from safelife_tpu_torch.models.convert import policy_params_from_flax
    from safelife_tpu_torch.models.nets import (SafeLifePolicyNetwork,
                                                TRAINING_CHANNELS)

    obs = ({"num_channels": len(TRAINING_CHANNELS)} if channels
           else {"unpack_channels": TRAINING_CHANNELS})
    net = SafeLifePolicyNetwork(view_shape=VIEW, device=device,
                                precision=precision, **obs)
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

    def run_edges(h, w, b, probs):
        """K1 on ``edge_boards``: every arrangement at every batch."""
        forms = set()
        for turn in range(4 if b < 4 else 1):
            board, locs, acts = edge_boards(rng, b, h, w, turn)
            for a in (2, 3):
                forms.update(run_k1(board, locs[:, :a], acts[:, :a], 0.3,
                                    False))
                for p in probs:
                    forms.update(run_k1(board, locs[:, :a], acts[:, :a], p,
                                        True))
        return forms

    def run_shape(h, w, batches, probs):
        forms = set()
        for b in batches:
            if h * w > P.MAX_CELLS:
                forms.update(run_edges(h, w, b, probs))
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
        tiles = ", ".join("B=%d: %dx%d tiles, %d rows a thread, %d threads, "
                          "%d B shared" % ((b,) + P.tile_shape(h, w, b))
                          for b in LARGE_BATCHES)
        log("K1, K2 %dx%d (%d cells; %s) x B in %s x A in {1,2,3} x "
            "(deterministic, p in {0.3, 1}), and K1 with 2 and 3 agents "
            "across tile edges and the wrap: %s exact"
            % (h, w, h * w, tiles, LARGE_BATCHES, ", ".join(forms)))

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


def edge_boards(rng, b, h, w, turn=0):
    """Soups whose three agents stand in a line across a tile edge of the
    tiled forms (``ops.physics.tile_shape`` at this batch) or across the
    board's wrap, acting along that line into one another's cells: lane i
    takes arrangement (i + turn) % 4, a column across the first row edge
    of tiles, a row across the first column edge, a column across the wrap
    row, a row across the wrap column (an edge that the board has not
    falls on the wrap). Returns (board, locs, actions)."""
    from safelife_tpu_torch.core import cells as C
    from safelife_tpu_torch.ops import physics as P

    board, _ = soup(rng, b, h, w, 3, spawners=True)
    tr, tc = P.tile_shape(h, w, b)[:2]
    locs = np.zeros((b, 3, 2), np.int32)
    acts = np.zeros((b, 3), np.int32)
    for i in range(b):
        kind = (i + turn) % 4
        down = kind in (0, 2)
        edge = (tr % h if down else tc % w) if kind < 2 else 0
        y, x = rng.integers(0, h), rng.integers(0, w)
        for k in range(3):
            if down:
                locs[i, k] = ((edge - 1 + k) % h, x)
            else:
                locs[i, k] = (y, (edge - 1 + k) % w)
            board[i, locs[i, k, 0], locs[i, k, 1]] = C.PLAYER | (
                int(rng.integers(0, 8)) << C.COLOR_BIT)
        # Moves (1-4) and toggles (5-8) along the line: 1, 3, 5, 7 face up
        # or down, 2, 4, 6, 8 right or left.
        acts[i] = rng.choice([1, 3, 5, 7] if down else [2, 4, 6, 8], 3)
    return board, locs, acts


def check_offsets(dev, errs):
    """K1 and K2 at non-zero counter offsets, in both forms: each slice of
    a global batch launched with its first lane as ``lane_offset`` equals
    the global launch and the plain version bit for bit, and K2 on a halo
    slab of rows r-1 .. r+k of one lane's board, at ``cell_offset =
    (r - 1) * W`` and that lane's ``lane_offset``, equals rows r .. r+k-1
    of the whole batch's step (r = 0 wraps round the torus)."""
    from safelife_tpu_torch.ops import physics as P

    rng = np.random.default_rng(9)
    seed = torch.tensor([123456789, -987654321], dtype=torch.int32,
                        device=dev)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    forms = set()
    for (h, w), b, cuts, slabs in (
            ((26, 26), 4096, (0, 1000, 2048, 4096), ((0, 10), (5, 12))),
            ((112, 112), 64, (0, 7, 32, 64), ((2, 108), (0, 30))),
            # The row-sharded advance's 98x192 slabs of two ranks, and one
            # across the middle.
            ((192, 192), 8, (0, 3, 8), ((0, 96), (96, 96), (50, 96)))):
        board, locs = soup(rng, b, h, w, 1, spawners=True)
        flat, locs = t(board.reshape(b, h * w)), t(locs)
        acts = t(rng.integers(0, 9, (b, 1)).astype(np.int32))
        sp = torch.full((b,), 0.3, device=dev)
        kw = dict(h=h, w=w, stochastic=True)
        whole1 = P.fused_actions_advance(flat, locs, acts, sp, seed, **kw)
        whole2 = P.advance(flat, sp, seed, **kw)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            a1 = tuple(x[lo:hi].contiguous() for x in (flat, locs, acts, sp))
            forms.update(compare(
                errs,
                lambda: P.fused_actions_advance(*a1, seed, lane_offset=lo,
                                                **kw),
                lambda: P.fused_actions_advance_plain(
                    *a1, seed, lane_offset=lo, **kw)))
            max_err(zip(P.fused_actions_advance(*a1, seed, lane_offset=lo,
                                                **kw),
                        (x[lo:hi] for x in whole1)))
            forms.update(compare(
                errs, lambda: P.advance(a1[0], a1[3], seed, lane_offset=lo,
                                        **kw),
                lambda: P.advance_plain(a1[0], a1[3], seed, lane_offset=lo,
                                        **kw)))
            max_err([(P.advance(a1[0], a1[3], seed, lane_offset=lo, **kw),
                      whole2[lo:hi])])
        lane = b // 2
        grid = flat[lane].reshape(h, w)
        for r, k in slabs:
            rows = torch.arange(r - 1, r + k + 1, device=dev) % h
            slab = grid.index_select(0, rows).reshape(1, -1).contiguous()
            skw = dict(h=k + 2, w=w, stochastic=True, lane_offset=lane,
                       cell_offset=(r - 1) * w)
            forms.update(compare(
                errs, lambda: P.advance(slab, sp[:1], seed, **skw),
                lambda: P.advance_plain(slab, sp[:1], seed, **skw)))
            got = P.advance(slab, sp[:1], seed, **skw).reshape(k + 2, w)
            max_err([(got[1:-1], whole2[lane].reshape(h, w)[r:r + k])])
    log("K1, K2 at lane offsets (slices of B=4096 at 26x26, B=64 at "
        "112x112 and B=8 at 192x192 equal the whole batch's launch) and K2 "
        "at cell offsets (halo slabs, 98x192 ones and the wrap included): "
        "%s exact" % ", ".join(sorted(forms)))


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
    check_window_obs(dev, errs, rng)
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


#: Boards above the staging limit on which phase 1 holds K3's windowed
#: form besides LARGE_LEVEL: just above it (29,929 cells), a 25x25 view
#: taller than the board (it tiles the board), odd sides. LARGE_SHAPES,
#: above MAX_CELLS, take the windowed form too.
WINDOW_SHAPES = ((173, 173), (12, 2600), (191, 157))


def edge_centres(rng, b, a, n):
    """int32[b, a] view centres (or exit rows) on 0..n-1, most of them on
    the wrap edges (0, 1, n-2, n-1), the rest anywhere."""
    edges = np.array([0, 1, n - 2, n - 1]) % n
    pick = rng.integers(0, n, (b, a))
    on_edge = rng.random((b, a)) < 0.75
    return np.where(on_edge, edges[rng.integers(0, 4, (b, a))],
                    pick).astype(np.int32)


def check_window_obs(dev, errs, rng):
    """K3's windowed form against its plain version on WINDOW_SHAPES and
    LARGE_SHAPES at B in {1, 7, 64}, A in {1, 3}, E in {0, 1, 2}, both
    white-goal modes, with centres and exits on the wrap edges and
    corners."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.ops import obs as O

    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    for h, w in WINDOW_SHAPES + LARGE_SHAPES:
        for b in (1, 7, 64):
            forms = set()
            for a in (1, 3):
                if O.view_launch_shape(b, a, h, w, *VIEW)[0]:
                    raise AssertionError("%dx%d lanes were staged" % (h, w))
                for e in (0, 1, 2):
                    words = rng.integers(0, 2 ** 16, (2, b, h, w)).astype(
                        np.int32)
                    args = (t(words[0]), t(words[1]),
                            t(edge_centres(rng, b, a, h)),
                            t(edge_centres(rng, b, a, w)),
                            t(np.stack([edge_centres(rng, b, e, h),
                                        edge_centres(rng, b, e, w)], -1)),
                            t(rng.random((b, e)) < 0.7))
                    for rw in (True, False):
                        k = dict(view_shape=VIEW, remove_white_goals=rw)
                        forms.update(compare(
                            errs, lambda: ops.recenter_views(*args, **k),
                            lambda: ops.recenter_views_plain(*args, **k)))
            log("K3 view %s on %dx%d, B=%d (views a block, threads, shared "
                "bytes at A=1, E=1: %s) x A in {1,3} x E in {0,1,2}, centres "
                "on the wrap edges: %s exact"
                % (VIEW, h, w, b, O.window_launch_shape(b, 1, 1, *VIEW),
                   ", ".join(sorted(forms))))


#: K4 cases of phase 1: samples, and view shapes (25x25, and one that is
#: neither square nor a multiple of 4) under three channel sets: the
#: training channels, the top byte with bit 0, and every bit. The samples
#: are the widths the phases run K4 at: evaluation's 25 lanes, the CLI's
#: 64, the DQN batch of 96, the benchmark over 100 levels, the main
#: path's 512, an odd count above the training rollout's 4,096, and the
#: learner minibatch and rollout cell's 16,384.
UNPACK_SAMPLES = (1, 25, 64, 96, 100, 512, 4097, 16384)
UNPACK_VIEWS = ((25, 25), (7, 9))
UNPACK_CHANNEL_SETS = ("training", (0, 24, 25, 26, 27, 28, 29, 30, 31),
                       tuple(range(32)))


def unpack_channel_set(name):
    from safelife_tpu_torch.models.nets import TRAINING_CHANNELS

    return TRAINING_CHANNELS if name == "training" else name


def check_unpack(dev, errs):
    """K4 against its plain version, bit for bit (the floats' bits compared
    as int32), on random words over all 32 bits at UNPACK_SAMPLES x
    UNPACK_VIEWS x UNPACK_CHANNEL_SETS."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.ops import unpack as U

    rng = np.random.default_rng(9)
    for n in UNPACK_SAMPLES:
        for view in UNPACK_VIEWS:
            views = torch.from_numpy(rng.integers(
                -2 ** 31, 2 ** 31, (n,) + view).astype(np.int32)).to(dev)
            for name in UNPACK_CHANNEL_SETS:
                ch = unpack_channel_set(name)
                compare(errs,
                        lambda: ops.unpack_planes(views, ch).view(torch.int32),
                        lambda: U.unpack_planes_plain(views, ch).view(
                            torch.int32))
        log("K4 unpack_planes N=%d (%d threads a sample) x views %s x %d "
            "channel sets: exact" % (n, U.THREADS, list(UNPACK_VIEWS),
                                     len(UNPACK_CHANNEL_SETS)))


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
                "recenter_views": 2 * STEPS + 2,
                "unpack_planes": 2 * STEPS}
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
    if any(after[k] - before[k] != steps for k in (
            "fused_actions_advance", "advance", "unpack_planes")):
        raise AssertionError("stochastic path launched %s over %d steps"
                             % ({k: after[k] - before[k] for k in after},
                                steps))
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
    read just after: the tiled K1 and K2 and the windowed K3 must have
    run, and no staged form of K1/K2."""
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
    if launches["unpack_planes"] != steps:
        raise AssertionError("K4 launched %d times over %d steps"
                             % (launches["unpack_planes"], steps))
    log("large-board path: run_episodes %d lanes x %d steps of %dx%d levels "
        "in %.3f s = %.0f env-steps/s; launches %s  [%s]"
        % (LARGE_LANES, steps, LARGE_LEVEL[0], LARGE_LEVEL[1], elapsed,
           LARGE_LANES * steps / elapsed, json.dumps(launches), card))
    return launches


# ---------------------------------------------------------------------------
# Timing


#: Profiled windows of n launches ``device_ms`` may take.
PROFILE_WINDOWS = 4


def device_ms(fn, kernel_name, n=50):
    """A kernel's time a launch on the card's clock, and how it was taken:
    the profiler's device time over the launches of ``kernel_name`` it
    recorded, over up to ``PROFILE_WINDOWS`` windows of n launches until it
    has n (it may drop some); if it recorded fewer than n / 2 in all, CUDA
    events around a CUDA graph of n launches replayed (the device's time
    for the launches back to back, the gaps between them included and no
    host launch overhead); if that cannot be captured, (None, "not
    timed: ..."). Never a host-side time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total, count = 0.0, 0
    for window in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if kernel_name in evt.key:
                total += getattr(evt, "device_time_total", 0.0)
                count += evt.count
        if count >= n:
            break
    if 2 * count >= n and total > 0:
        return total / count / 1e3, "profiler, %d of %d launches" % (
            count, window * n)
    why = "the profiler kept %d of %d launches" % (count, window * n)
    try:
        ms = graph_ms(fn, n)
    except RuntimeError as exc:
        log("%s not timed: %s; CUDA graph capture failed: %s"
            % (kernel_name, why, exc))
        return None, "not timed: %s, no CUDA graph" % why
    return ms, "CUDA graph of %d launches, events (%s)" % (n, why)


def graph_ms(fn, n=50):
    """Milliseconds a call of ``fn`` replayed n times in one CUDA graph,
    between CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def fmt_ms(ms):
    """A device time for a log line: "not timed" where there is none."""
    return "not timed" if ms is None else "%.5f" % ms


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
    """(bound_ms, bound_by, bytes_ms, ops_ms): :func:`perfbench.peaks.bound`
    in milliseconds, with the time to move the bytes and the time to issue
    the integer operations beside it."""
    seconds, by = peaks.bound(nbytes, nops)
    return (seconds * 1e3, by, nbytes / HBM_BYTES_PER_S * 1e3,
            nops / INT32_OPS_PER_S * 1e3)


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
         *view_work(h, w, cy, cx, el, ev, VIEW)),
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


#: Samples at which K4 is timed: evaluation's rollout (25 lanes), a
#: training rollout step (4096) and the rollout cell's step and a learner
#: minibatch (16,384).
UNPACK_TIMED = (25, 4096, 16384)
#: Integer operations of one K4 output float: the shift, the mask and the
#: select.
UNPACK_OPS_PER_OUTPUT = 3


def old_forward(net, obs):
    """A network's outputs on packed views as the port ran it before K4:
    ``unpack_obs`` (the shifts copied to the card, the shift, the mask and
    the cast), the trunk's input a permuted view of it, which cuDNN
    copies."""
    from safelife_tpu_torch.models import nets as N

    net.unpack = lambda o: N.unpack_obs(
        o, net.unpack_channels).permute(0, 3, 2, 1)
    try:
        out = net(obs)
    finally:
        del net.unpack
    return out if isinstance(out, tuple) else (out,)


def time_unpack(dev, net, card):
    """K4 at UNPACK_TIMED samples of 25x25 views and the training channels:
    its device time beside its bound (bytes: each view word read once,
    each float written once), the plain version's and the parent's
    ``unpack_obs`` on its own; then the policy ``net``'s forward at
    16,384 samples against :func:`old_forward`, bit for bit, with one K4
    launch, and both forwards profiled (the parent's elementwise passes
    that K4 replaces, by name). Returns {samples: timing}."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.models import nets as N
    from safelife_tpu_torch.ops import unpack as U

    ch = N.TRAINING_CHANNELS
    rng = np.random.default_rng(11)
    out = {}
    for n in UNPACK_TIMED:
        views = torch.from_numpy(rng.integers(
            0, 2 ** 28, (n,) + VIEW).astype(np.int32)).to(dev)
        errs = {}
        compare(errs, lambda: ops.unpack_planes(views, ch).view(torch.int32),
                lambda: U.unpack_planes_plain(views, ch).view(torch.int32))
        ms, how = device_ms(lambda: ops.unpack_planes(views, ch),
                            KERNELS["unpack_planes"][2])
        floats = n * len(ch) * VIEW[0] * VIEW[1]
        bound_ms, bound_by, bytes_ms, ops_ms = bound(
            4 * n * VIEW[0] * VIEW[1] + 4 * floats,
            UNPACK_OPS_PER_OUTPUT * floats)
        out[n] = dict(ms=ms, timed_by=how,
                      call_ms=events_ms(lambda: ops.unpack_planes(views, ch)),
                      plain_ms=events_ms(
                          lambda: U.unpack_planes_plain(views, ch)),
                      unpack_obs_ms=events_ms(
                          lambda: N.unpack_obs(views, ch)),
                      bound_ms=bound_ms, bound_by=bound_by,
                      bytes_ms=bytes_ms, ops_ms=ops_ms,
                      err=errs["unpack_planes"], batch=n)
        log("timing unpack_planes B=%-5d kernel %s ms (%s; %.5f ms a call "
            "with the wrapper), plain %.5f ms, the parent's unpack_obs "
            "alone %.5f ms, bound %.5f ms (%s; bytes %.5f, operations "
            "%.5f); %s%% of the bound  [%s]"
            % (n, fmt_ms(ms), how, out[n]["call_ms"], out[n]["plain_ms"],
               out[n]["unpack_obs_ms"], bound_ms, bound_by, bytes_ms,
               ops_ms, "not timed" if ms is None
               else "%.1f" % (100 * bound_ms / ms), card))

    n = UNPACK_TIMED[-1]
    obs = torch.from_numpy(rng.integers(0, 2 ** 28, (n,) + VIEW).astype(
        np.int32)).to(dev)
    with torch.no_grad():
        ref = old_forward(net, obs)
        before = ops.launch_counts()["unpack_planes"]
        got = net(obs)
        if ops.launch_counts()["unpack_planes"] != before + 1:
            raise AssertionError("a policy forward launched K4 %d times"
                                 % (ops.launch_counts()["unpack_planes"]
                                    - before))
        for g, r in zip(got, ref):
            if not torch.equal(g.view(torch.int32), r.view(torch.int32)):
                raise AssertionError("the policy forward on K4 differs from "
                                     "the old chain at %d samples" % n)
        log("policy forward at %d samples: bit for bit the old chain's, one "
            "K4 launch  [%s]" % (n, card))
        for what, fn in (("the parent's forward (unpack_obs, permute)",
                          lambda: old_forward(net, obs)),
                         ("the forward on K4", lambda: net(obs))):
            fn()
            profile_window(fn, "%s at %d samples" % (what, n), "forward", 1,
                           top=12)
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


def training_setup(dev, levels, tree, lanes, seed, precision="float32",
                   channels=False):
    """The training path at full width: the inaction baseline, PPOConfig
    defaults, packed 25x25 views (uint8 channels with ``channels``), the
    dense-512 policy from ``tree`` in ``precision``."""
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.models.nets import TRAINING_CHANNELS
    from safelife_tpu_torch.training import ppo as P

    pool = pack_levels(levels, device=dev)
    out = TRAINING_CHANNELS if channels else None
    run = dict(
        pool=pool, cfg=E.EnvConfig(view_shape=VIEW, output_channels=out),
        wcfg=W.WrapperConfig(se_baseline="inaction"), pcfg=P.PPOConfig(),
        gen=torch.Generator(device=dev).manual_seed(seed), dev=dev)
    run["ps"] = P.init_ppo_state(
        run["pcfg"], policy(tree, dev, precision, channels), device=dev)
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


def ppo_forwards(pcfg, obs):
    """Policy forwards of one ``train_iteration`` from observations ``obs``
    [lanes, agents, ...] (a process's or a rank's), one K4 launch each on
    packed views: one a rollout step, one for the final values, one a
    learner minibatch, and one a chunk of the metrics' loss
    (``ppo._batch_loss``, in chunks of the first minibatch's size): 41 at
    ``PPOConfig()``'s defaults."""
    from safelife_tpu_torch.training import ppo as P

    n = obs.shape[0] * obs.shape[1] * pcfg.steps_per_env
    chunk = P._minibatch_bounds(n, pcfg.num_minibatches)[0][1]
    return (pcfg.steps_per_env + 1
            + pcfg.epochs_per_batch * (pcfg.num_minibatches + 1)
            + -(-n // max(chunk, 1)))


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
                "recenter_views": steps * TRAIN_ITERS,
                "unpack_planes": ppo_forwards(pcfg, run["obs"]) * TRAIN_ITERS}
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


#: The policy network's layers whose outputs go through a ReLU.
RELU_INPUTS = ("cnn.conv0", "cnn.conv1", "cnn.conv2", "dense")


def first_minibatch(cfg, net, batch, first, branches=False):
    """The loss of the samples ``first`` of ``batch`` and its gradients
    ({name: tensor on the CPU}), in ``net``'s precision; with ``branches``
    also the branches that forward took (``loss_branches``)."""
    from safelife_tpu_torch.models.nets import learner_precision
    from safelife_tpu_torch.training import ppo as P

    d = next(net.parameters()).device
    mb = {k: v.index_select(0, first.to(d)) for k, v in batch.items()}
    seen, hooks = {}, []
    if branches:
        for name in RELU_INPUTS:
            hooks.append(net.get_submodule(name).register_forward_hook(
                lambda m, i, o, name=name: seen.__setitem__(
                    name, (o > 0).flatten(1).cpu())))
        hooks.append(net.register_forward_hook(
            lambda m, i, o: seen.__setitem__(
                "out", tuple(x.detach() for x in o))))
    try:
        with learner_precision(net.precision, d.type):
            loss, metrics = P.calculate_loss(
                cfg, net, mb["obs"], mb["actions"], mb["action_prob"],
                mb["values"], mb["returns"], mb["advantages"], mb["weight"])
            loss.backward()
    finally:
        for h in hooks:
            h.remove()
    grads = {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
    net.zero_grad(set_to_none=True)
    if not branches:
        return loss.item(), grads
    return loss.item(), grads, loss_branches(cfg, mb, seen, metrics)


def loss_branches(cfg, mb, seen, metrics):
    """The branches one forward of ``ppo.calculate_loss`` took, per sample
    of the minibatch ``mb`` ({name: [n, k] on the CPU}): each ReLU's input
    above zero (``RELU_INPUTS``), the policy clip passing the gradient,
    and the value term's branch (0 inside the clip, where both terms of
    the max pass the same gradient; outside it 1 or 2 by the term the max
    takes, 3 on a tie), recomputed on the forward's device from its
    outputs as ``ppo._loss_terms`` computes them; and, under
    ``"entropy_clamp"``, whether the minibatch's mean entropy passed the
    clamp."""
    values, policy = seen["out"]
    with torch.no_grad():
        a_policy = policy.gather(-1, mb["actions"][..., None])[..., 0]
        prob_diff = torch.sign(mb["advantages"]) * (
            1 - a_policy / mb["action_prob"])
        d = values - mb["values"]
        clipped = (mb["values"] + torch.clamp(d, -cfg.eps_value,
                                              cfg.eps_value)
                   - mb["returns"]) ** 2
        unclipped = (values - mb["returns"]) ** 2
        inside = (d >= -cfg.eps_value) & (d <= cfg.eps_value)
        value = torch.where(
            inside, 0, torch.where(clipped > unclipped, 1,
                                   torch.where(clipped < unclipped, 2, 3)))
    out = {name: seen[name] for name in RELU_INPUTS}
    out["policy_clip"] = (prob_diff >= -cfg.eps_policy)[:, None].cpu()
    out["value_clip"] = value[:, None].cpu()
    out["entropy_clamp"] = bool(metrics["entropy"] <= cfg.entropy_clip)
    return out


def first_indices(cfg, n, seed):
    """The epochs' permutations of ``learner_diffs`` for ``n`` samples and
    the first minibatch's indices."""
    from safelife_tpu_torch.training import ppo as P

    rng = np.random.default_rng(seed)
    perms = [rng.permutation(n) for _ in range(cfg.epochs_per_batch)]
    first = torch.from_numpy(perms[0][slice(*P._minibatch_bounds(
        n, cfg.num_minibatches)[0])])
    return perms, first


def trained_policy(tree, state, device, precision="float32"):
    """``policy`` of ``tree`` on ``device`` with the parameters ``state``."""
    net = policy(tree, device, precision)
    net.load_state_dict(state)
    return net


def learner_side(cfg, net, batch, first):
    """One device's first minibatch: its network and batch (on the
    network's device), loss, gradients and branches, and the seconds it
    took."""
    t0 = time.perf_counter()
    d = next(net.parameters()).device
    b = {k: v.to(d) for k, v in batch.items()}
    loss, grads, branches = first_minibatch(cfg, net, b, first,
                                            branches=True)
    return dict(net=net, batch=b, loss=loss, grads=grads,
                branches=branches, seconds=time.perf_counter() - t0)


def branch_flips(a, b, weight, by):
    """The samples whose branches (``loss_branches``) differ between the
    forwards ``a`` and ``b``: a ReLU, the policy clip or the value term,
    only samples of non-zero ``weight``, all of them when the entropy
    clamp differs; each branch's count added to ``by``. Returns the mask
    and whether the entropy clamp differs."""
    flips = torch.zeros(weight.numel(), dtype=torch.bool)
    for name in a:
        if name != "entropy_clamp":
            diff = (a[name] != b[name]).any(1) & weight
            by[name] = by.get(name, 0) + int(diff.sum())
            flips |= diff
    entropy_flip = a["entropy_clamp"] != b["entropy_clamp"]
    if entropy_flip:
        flips[:] = True
    return flips, entropy_flip


#: Forwards over the agreeing samples before the exclusion gives up.
EXCLUSION_ROUNDS = 3


def exclusion_diffs(cfg, side, ref, first):
    """``side``'s first minibatch against ``ref``'s (``learner_side``):
    the loss and gradients of the whole minibatch (``grad_diffs``), the
    samples whose branches differ between the two forwards
    (``branch_flips``), and, under ``agree_*``, the loss and gradients of
    both over the samples that agree. The forward over those samples
    records its branches too: a smaller batch may take other convolution
    engines, and its mean entropy meets the clamp anew, so samples that
    flip there are excluded as well and the forward is run again, at most
    ``EXCLUSION_ROUNDS`` times (NaN readings, which miss every bound,
    when no sample is left or the flips go on)."""
    weight = ref["batch"]["weight"].cpu() != 0
    by = {}
    excluded, entropy_flip = branch_flips(
        side["branches"], ref["branches"],
        weight.index_select(0, first), by)
    r = grad_diffs(side["loss"], side["grads"], ref["loss"], ref["grads"])
    agree = {k: float("nan") for k in r}
    t0 = time.perf_counter()
    for _ in range(EXCLUSION_ROUNDS):
        kept = (~excluded).nonzero()[:, 0]
        if not kept.numel():
            break
        keep = first[kept]
        (loss, grads, a), (ref_loss, ref_grads, b) = (
            first_minibatch(cfg, s["net"], s["batch"], keep, branches=True)
            for s in (side, ref))
        flips, flip = branch_flips(a, b, weight.index_select(0, keep), by)
        entropy_flip |= flip
        if not flips.any():
            agree = grad_diffs(loss, grads, ref_loss, ref_grads)
            break
        excluded[kept[flips]] = True
    return {**r, **{"agree_" + k: v for k, v in agree.items()},
            "excluded": int(excluded.sum()), "minibatch": first.numel(),
            "excluded_by": by, "entropy_flip": entropy_flip,
            "agree_s": time.perf_counter() - t0}


def card_diffs(cfg, net, batch, first, ref):
    """The card's network ``net`` against ``ref``, the CPU's
    ``learner_side`` of the same parameters: ``exclusion_diffs``'s
    readings, each side's seconds, and how many layer runs (forward and
    backward) on the card allowed TF32, of how many. Returns the readings
    and the card's side."""
    with tf32_probe(net) as tf32:
        card = learner_side(cfg, net, batch, first)
        r = exclusion_diffs(cfg, card, ref, first)
    r.update(tf32_layer_runs=sum(tf32), layer_runs=len(tf32),
             card_s=card["seconds"], cpu_s=ref["seconds"])
    return r, card


def learner_diffs(dev, tree, state, batch, seed=12, precision="float32"):
    """The learner on the card against the CPU path, both in
    ``precision``: from parameters ``state``, the first minibatch's
    readings (``card_diffs``), then one ``train_on_batch`` of ``batch``
    with the same permutations on both. Returns those readings, with the
    update's layer runs in the TF32 count; and the parameters' difference
    after the update, as a norm over the norm of the update, its largest
    element and how many differ by more than 1e-5."""
    from safelife_tpu_torch.training import ppo as P

    cfg = P.PPOConfig()
    perms, first = first_indices(cfg, batch["obs"].shape[0], seed)
    cpu = learner_side(cfg, trained_policy(tree, state, torch.device("cpu"),
                                           precision), batch, first)
    r, card = card_diffs(cfg, trained_policy(tree, state, dev, precision),
                         batch, first, cpu)
    params = []
    with tf32_probe(card["net"]) as tf32:
        for side, key in ((card, "card_s"), (cpu, "cpu_s")):
            t0 = time.perf_counter()
            d = side["batch"]["obs"].device
            P.train_on_batch(cfg, P.init_ppo_state(cfg, side["net"],
                                                   device=d),
                             side["batch"], None, perms=perms)
            r[key] += time.perf_counter() - t0
            params.append({k: v.cpu()
                           for k, v in side["net"].state_dict().items()})
    r["tf32_layer_runs"] += sum(tf32)
    r["layer_runs"] += len(tf32)
    pc, ph = params
    keys = list(cpu["grads"])

    def flat(tree_):
        return torch.cat([tree_[k].flatten() for k in keys]).double()

    p_diff = flat({k: pc[k] - ph[k] for k in keys})
    moved = flat({k: ph[k] - state[k].cpu() for k in keys})
    r.update(update_norm=float(p_diff.norm() / moved.norm()),
             param_max=float(p_diff.abs().max()),
             params_over_1e5=int((p_diff.abs() > 1e-5).sum()),
             params=p_diff.numel(),
             steps=cfg.epochs_per_batch * (cfg.num_minibatches + 1))
    return r


def grad_diffs(loss, grads, ref_loss, ref_grads):
    """The loss's relative difference from ``ref_loss``; the gradients'
    over all parameters (norm), and per tensor (the largest norm ratio,
    and the largest element over the tensor's largest magnitude)."""
    keys = list(ref_grads)
    diff = torch.cat([(grads[k] - ref_grads[k]).flatten()
                      for k in keys]).double()
    ref = torch.cat([ref_grads[k].flatten() for k in keys]).double()
    return {
        "loss": abs(loss - ref_loss) / max(abs(ref_loss), 1e-30),
        "grad_norm": float(diff.norm() / ref.norm()),
        "grad_tensor_norm": max(float((grads[k] - ref_grads[k]).norm()
                                      / ref_grads[k].norm()) for k in keys),
        "grad_tensor_max": max(float((grads[k] - ref_grads[k]).abs().max()
                                     / ref_grads[k].abs().max())
                               for k in keys),
    }


def exclusion_line(r):
    return ("first minibatch (%d samples): loss rel %.2e, gradients |dg| / "
            "|g| %.2e (per tensor: norm %.2e, max element / max |g| %.2e); "
            "%d samples excluded (%s%s), over the %d that agree: loss rel "
            "%.2e, gradients |dg| / |g| %.2e (per tensor: norm %.2e, max "
            "element / max |g| %.2e)"
            % (r["minibatch"], r["loss"], r["grad_norm"],
               r["grad_tensor_norm"], r["grad_tensor_max"], r["excluded"],
               ", ".join("%s %d" % kv for kv in r["excluded_by"].items()),
               "; the entropy clamp differs" if r["entropy_flip"] else "",
               r["minibatch"] - r["excluded"], r["agree_loss"],
               r["agree_grad_norm"], r["agree_grad_tensor_norm"],
               r["agree_grad_tensor_max"]))


def learner_line(r):
    return ("%s; parameters after %d Adam steps: |dp| / |update| %.2e, max "
            "|dp| %.2e, %d of %d above 1e-5; TF32 allowed in %d of %d layer "
            "runs on the card; %.1f s on the card, %.1f s on the CPU"
            % (exclusion_line(r), r["steps"], r["update_norm"],
               r["param_max"], r["params_over_1e5"], r["params"],
               r["tf32_layer_runs"], r["layer_runs"], r["card_s"],
               r["cpu_s"]))


#: The learner check's bounds (``check_learner_against_cpu``). The
#: gradient bound holds the first minibatch's samples whose branches agree
#: on both devices. Over two sweeps of 48 batches at 64 lanes and 20 at
#: 4096 (``chip_sweep.py learner`` and ``learner-4096``) strict float32
#: put those gradients at most 1.1e-5 of their norm apart, excluding at
#: most 1 of 256 and 31 of 16,384 samples, while the whole minibatch's
#: reached 1.6e-3 and 1.3e-4; TF32 put the agreeing gradients at least
#: 8.6e-5 apart and excluded 0-10 of 256 and 719-2,507 of 16,384. The
#: gradient bound lies between (it was set at 6e-5 from whole minibatches,
#: strict up to 2.2e-5 then); the excluded share's,
#: LEARNER_EXCLUDED_SHARE, keeps the exclusion from hiding a fault that
#: flips many samples. The update's norm ratio of the two modes overlaps
#: (strict up to 9.2e-3, TF32 from 3.2e-3), so its bound catches gross
#: faults only.
LEARNER_LOSS_REL = 1e-5
LEARNER_GRAD_NORM = 6e-5
LEARNER_UPDATE_NORM = 5e-2
LEARNER_EXCLUDED_SHARE = 0.01


def check_learner_against_cpu(dev, tree, state, batch, card):
    """The learner on the card against the CPU path from the parameters
    that collected ``batch`` (``learner_diffs``): TF32 off in every
    forward and backward run of every convolution and dense layer on the
    card; the first minibatch's loss within 1e-5 relative; the samples
    whose ReLUs, policy clip, value term and entropy clamp take the same
    branch on both devices at least 1 - LEARNER_EXCLUDED_SHARE of it, and
    their loss within 1e-5 relative and gradients within 6e-5 of their
    norm, which TF32 misses; the parameters after the 15 Adam steps within
    5% of the update's norm.

    Why the exclusion: an activation or a clip within float32 rounding of
    its threshold can take the other branch on the other device, and that
    sample's gradient then differs by its whole contribution through the
    unit; in strict float32 a few batches in a hundred showed the
    gradients of the whole minibatch up to 8.5e-5 of their norm apart.
    Why norms and not elements: such flips, and Adam turning a rounding
    difference in a gradient near zero into a whole step of the learning
    rate (``chip_sweep.py learner``). The layer probe is a second witness
    of TF32."""
    r = learner_diffs(dev, tree, state, batch)
    log("learner on the card vs the CPU (%d samples of a card rollout): %s"
        "  [%s]" % (batch["obs"].shape[0], learner_line(r), card))
    if r["tf32_layer_runs"] or not r["layer_runs"]:
        raise AssertionError("TF32 was allowed in %d of %d layer runs"
                             % (r["tf32_layer_runs"], r["layer_runs"]))
    missed = learner_misses(r)
    if missed:
        raise AssertionError("the learner on the card differs from the CPU "
                             "path beyond its tolerance: %s"
                             % ", ".join(missed))


def learner_misses(r):
    """The bounds of ``check_learner_against_cpu`` that the readings ``r``
    (``learner_diffs``) miss, by name; the update's only where ``r`` has
    it."""
    bounds = (("loss", r["loss"], LEARNER_LOSS_REL),
              ("excluded share", r["excluded"] / r["minibatch"],
               LEARNER_EXCLUDED_SHARE),
              ("agreeing loss", r["agree_loss"], LEARNER_LOSS_REL),
              ("agreeing gradients", r["agree_grad_norm"], LEARNER_GRAD_NORM),
              ("update", r.get("update_norm", 0.0), LEARNER_UPDATE_NORM))
    # NaN (no sample agrees) misses too.
    return ["%s %.3e > %.0e" % b for b in bounds if not b[1] <= b[2]]


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
    and, under ``name + ":launches"``, ``":args"`` and ``":results"``, the
    kernel launches, the arguments and the result of each call."""
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
            record.setdefault(name + ":results", []).append(out)
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
    forwards = sum(args[5] for args, _ in rec["run_episodes:args"])
    if launches["unpack_planes"] != forwards:
        raise AssertionError("K4 launched %d times, the rollout's steps %d"
                             % (launches["unpack_planes"], forwards))
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
# Phase 7: the trainer and its CLI


TRAINER_TASK = "append-still"
#: Lane counts of the start-up pools: the CLI's default batch (a pool of
#: 128 levels) and the training batch (256, the cap).
STARTUP_LANES = (64, 4096)
CLI_LANES = 64
CLI_STEPS = 20480     # 2 chunks of 8 iterations of 64 lanes x 20 steps
RESUME_STEPS = 30720  # one chunk more
CLI_EPISODES = 8
#: The benchmark run trains nothing: a smaller pool saves generation.
BENCH_POOL = 32
BIG_LANES = 4096
WORKER_LEVELS = 8

#: The trainer's functions that phase 7 times and reads launches around
#: ("module:attribute" under safelife_tpu_torch -> label).
TRAINER_PARTS = {
    "training.train:train_ppo": "train_ppo",
    "training.train:train_dqn": "train_dqn",
    "training.ppo:train_chunk": "training",
    "training.dqn:train_chunk": "dqn_training",
    "io.iterator:LevelPoolManager.refresh": "refresh",
    "io.iterator:LevelPoolManager.restore_pool": "restore_pool",
    "training.train:_restore_latest": "restore",
    "training.train:_report": "report",
    "training.train:_report_dqn": "report",
    "training.train:run_validation": "validation",
    "training.train:run_benchmark": "benchmark",
    "training.runner:run_episodes": "rollout",
    "training.runner:batched_occupancy": "occupancy",
    "side_effects:batched_occupancy": "occupancy",
}


def fresh_cli_state():
    """What a new process starts with: the global config and the loggers'
    class-shared stats, both empty. The runs of this phase share one
    process, so that launch counts can be read around each."""
    from safelife_tpu_torch.loggers import SafeLifeLogger
    from safelife_tpu_torch.training.global_config import config

    config.clear()
    config._used.clear()
    SafeLifeLogger.cumulative_stats.clear()


@contextlib.contextmanager
def trainer_parts():
    """``timed_calls`` around every function of TRAINER_PARTS; yields
    {label: [(seconds, launches, (args, kwargs), result) of each call]},
    filled when the block ends."""
    import importlib

    calls = {}
    with contextlib.ExitStack() as stack:
        recs = []
        for spec, label in TRAINER_PARTS.items():
            mod, _, attr = spec.partition(":")
            owner = importlib.import_module("safelife_tpu_torch." + mod)
            *path, name = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            recs.append((label, name,
                         stack.enter_context(timed_calls(owner, [name]))))
        yield calls
        for label, name, rec in recs:
            calls.setdefault(label, []).extend(zip(
                rec.get(name, []), rec.get(name + ":launches", []),
                rec.get(name + ":args", []), rec.get(name + ":results", [])))


def training_chunks(calls):
    """(wrapper config, pool, env steps) of each training chunk of a run:
    PPO's ``train_chunk`` (iterations x steps_per_env) and DQN's (units x
    steps a unit)."""
    for _, _, (args, _), _ in calls.get("training", []):
        yield args[1], args[3], args[8] * args[2].steps_per_env
    for _, _, (args, _), _ in calls.get("dqn_training", []):
        yield args[1], args[3], args[8] * args[9]


def chunk_forwards(calls):
    """Network forwards of each training chunk of a run, each with its
    network: a PPO chunk's iterations x :func:`ppo_forwards`; a DQN unit's
    steps (one action each) plus its loss's Q and target forwards."""
    for _, _, (args, _), _ in calls.get("training", []):
        yield args[4].model, args[8] * ppo_forwards(args[2], args[6])
    for _, _, (args, _), _ in calls.get("dqn_training", []):
        yield args[4].model, args[9] * (args[8] + 2)


def packed(model):
    """1 if ``model`` takes packed views (one K4 launch a forward on the
    card), else 0."""
    return int(model.unpack_channels is not None)


def predicted_launches(calls):
    """K1-K4 launches of a trainer run, derived from the code and the calls
    it made: K1 and K3 once an env step (each training chunk's env steps,
    each rollout's ``max_steps``); K3 once more a reset (``W.reset`` of
    ``train_ppo`` or ``train_dqn``, a rollout's reset, a restored env
    state); K2 once an env step on a pool whose goals evolve, once a
    training step under the inaction baseline, and in each occupancy its
    pre-steps (the largest step count, at most ``max_pre_steps``) plus 2 x
    ``num_samples``; K4 once a forward of a network on packed views
    (:func:`chunk_forwards`, one a rollout step)."""
    k1 = k2 = k3 = k4 = 0
    for wcfg, pool, steps in training_chunks(calls):
        k1 += steps
        k3 += steps
        k2 += (0 if pool.all_goals_static else steps) + (
            steps if wcfg.se_baseline == "inaction" else 0)
    for model, forwards in chunk_forwards(calls):
        k4 += packed(model) * forwards
    for _, _, (args, _), _ in calls.get("rollout", []):
        pool, steps = args[1], args[5]
        k1 += steps
        k3 += steps + 1
        k2 += 0 if pool.all_goals_static else steps
        k4 += packed(args[2]) * steps
    for _, _, (args, kwargs), _ in calls.get("occupancy", []):
        k2 += min(int(torch.as_tensor(args[2]).max()),
                  kwargs["max_pre_steps"]) + 2 * kwargs["num_samples"]
    k3 += len(calls.get("train_ppo", [])) + len(calls.get("train_dqn", []))
    k3 += sum(1 for *_, result in calls.get("restore", [])
              if result[1] is not None)
    return {"fused_actions_advance": k1, "advance": k2, "recenter_views": k3,
            "unpack_planes": k4}


def check_launches(what, launches, want):
    """The launches counted (``ops.launch_counts()``, by form) against
    ``want``; a form ``want`` does not name (the ``*_global`` ones on
    26x26 boards, K4 where no network runs on packed views) must not have
    run."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError("%s launched %s %d times, the code says %d"
                                 % (what, name, n, want.get(name, 0)))


def check_trainer_launches(what, launches, calls):
    """The launches counted in a trainer run against predicted_launches.
    Returns the prediction."""
    want = predicted_launches(calls)
    check_launches(what, launches, want)
    return want


def part_seconds(calls, label):
    return sum(c[0] for c in calls.get(label, []))


def check_workers_match_serial(card):
    """WORKER_LEVELS levels from 4 forked workers against as many made in
    this process from the same SeedSequence: byte for byte."""
    from safelife_tpu_torch.io.iterator import SafeLifeLevelIterator

    made = []
    for workers in (4, 0):
        it = SafeLifeLevelIterator("random/" + TRAINER_TASK,
                                   seed=np.random.SeedSequence(31),
                                   num_workers=workers)
        t0 = time.perf_counter()
        made.append(([next(it) for _ in range(WORKER_LEVELS)],
                     time.perf_counter() - t0))
        it.close()
    (forked, t_forked), (serial, t_serial) = made
    for a, b in zip(forked, serial):
        for k in ("board", "goals", "agent_locs", "agent_names",
                  "points_table"):
            if getattr(a, k).tobytes() != getattr(b, k).tobytes():
                raise AssertionError("level %s: %s differs between workers "
                                     "and serial generation" % (a.name, k))
        if (a.name, a.min_performance, a.spawn_prob) != \
                (b.name, b.min_performance, b.spawn_prob):
            raise AssertionError("level %s differs" % a.name)
    log("procgen: %d %s levels from 4 forked workers equal %d made in this "
        "process byte for byte; %.3f s with the workers (their start "
        "included), %.3f s serial, %.4f s a level  [%s]"
        % (WORKER_LEVELS, TRAINER_TASK, WORKER_LEVELS, t_forked, t_serial,
           t_serial / WORKER_LEVELS, card))


def startup_pools(dev, card):
    """``build_environments`` for TRAINER_TASK at each of STARTUP_LANES (a
    pool of max(32, min(256, 2 x lanes)) levels from 4 forked workers, 5
    validation levels, the benchmark archive), timed; then one
    ``refresh(4, in_use=...)`` from a fresh ``W.reset`` state, timed, no
    busy slot changed. Returns {lanes: (bundle, seconds)}."""
    from safelife_tpu_torch.env import wrappers as W
    from safelife_tpu_torch.training.env_factory import build_environments
    from safelife_tpu_torch.training.global_config import GlobalConfig

    out = {}
    for lanes in STARTUP_LANES:
        t0 = time.perf_counter()
        bundle = build_environments(
            GlobalConfig(env_type=TRAINER_TASK, seed=lanes), num_envs=lanes,
            device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        mgr = bundle.pool_manager
        pool = mgr.pool
        want = max(32, min(256, 2 * lanes))
        if pool.num_levels != want or pool.board.device != dev:
            raise AssertionError("pool of %d levels on %s, expected %d"
                                 % (pool.num_levels, pool.board.device, want))
        ws, _ = W.reset(bundle.env_cfg, bundle.wrapper_cfg, pool, lanes,
                        device=dev)
        busy = sorted(set(ws.env.level_idx.cpu().tolist()))
        names = [lv.name for lv in mgr._host_levels]
        t0 = time.perf_counter()
        swapped = mgr.refresh(4, in_use=ws.env.level_idx)
        torch.cuda.synchronize()
        refresh_s = time.perf_counter() - t0
        if any(mgr._host_levels[s].name != names[s] for s in busy):
            raise AssertionError("refresh replaced a busy slot")
        log("start-up pool %s at %d lanes: build_environments %.3f s (%d "
            "levels from 4 forked workers, 5 validation levels, the "
            "benchmark archive); all_goals_static %s, spawner_free %s; one "
            "refresh(4) %.4f s, %d swapped, %d of %d slots busy  [%s]"
            % (TRAINER_TASK, lanes, build_s, pool.num_levels,
               pool.all_goals_static, pool.spawner_free, refresh_s, swapped,
               len(busy), pool.num_levels, card))
        out[lanes] = (bundle, build_s)
    return out


def cli_run(dev, argv, what, card):
    """``__main__.main(argv)`` in this process, as a new process would
    start it, with the launch counts zeroed just before and read just
    after and the trainer's parts timed. Returns (result, calls,
    launches, wall seconds)."""
    from safelife_tpu_torch import __main__ as cli, ops

    fresh_cli_state()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with trainer_parts() as calls:
        t0 = time.perf_counter()
        out = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    want = check_trainer_launches(what, launches, calls)
    log("%s: %.3f s; launches %s, derived from the calls %s  [%s]"
        % (what, wall, json.dumps(launches), json.dumps(want), card))
    return out, calls, launches, wall


def check_run_dir(data_dir, out, episodes):
    """The files of a CLI run, its logs read back by ``load_safelife_log``,
    and the returned benchmark summary equal to ``summarize_run`` of the
    log when it holds this run's episodes alone, else to the summary of
    the log's last ``episodes`` records (the log accumulates over runs)."""
    import os

    from safelife_tpu_torch.loggers import load_safelife_log, summarize_run
    from safelife_tpu_torch.training.env_factory import SIDE_EFFECT_WEIGHTS
    from safelife_tpu_torch.training.runner import summarize_records

    for name in ("training.log", "training-log.json", "benchmark-data.json"):
        if not os.path.exists(os.path.join(data_dir, name)):
            raise AssertionError("%s missing in %s" % (name, data_dir))
    load_safelife_log(os.path.join(data_dir, "training-log.json"))
    bench = load_safelife_log(os.path.join(data_dir, "benchmark-data.json"))
    if len(bench["reward"]) < episodes:
        raise AssertionError("benchmark-data.json holds %d episodes"
                             % len(bench["reward"]))
    if out.summary["episodes"] != episodes:
        raise AssertionError("the benchmark played %d episodes"
                             % out.summary["episodes"])
    if len(bench["reward"]) == episodes:
        read = summarize_run(data_dir)["benchmark-data.json"]
    else:
        with open(os.path.join(data_dir, "benchmark-data.json")) as f:
            read = summarize_records(json.load(f)[-episodes:],
                                     SIDE_EFFECT_WEIGHTS)
    worst = max(abs(read[k] - out.summary[k]) for k in read
                if k in out.summary)
    if worst > 1e-9:
        raise AssertionError("the logged benchmark differs from the summary "
                             "by %g" % worst)
    for k, v in out.summary.items():
        if not np.isfinite(v):
            raise AssertionError("non-finite benchmark %s" % k)


def run_trainer_cli(dev, card):
    """The CLI at CLI_LANES lanes: train CLI_STEPS steps with the final
    benchmark; resume to RESUME_STEPS (learner, env state and pool); then
    ``--run-type benchmark`` from the checkpoint. Returns the first run's
    launches and timings."""
    import os

    from safelife_tpu_torch.training.checkpoints import CheckpointManager

    data_dir = os.path.join("runs", "chip-smoke-train-%d" % os.getpid())

    def argv(*extra):
        return ["train", data_dir, "-e", TRAINER_TASK, "--batch",
                str(CLI_LANES), "--seed", "1", "--benchmark-episodes",
                str(CLI_EPISODES), *extra]

    what = "CLI train at %d lanes" % CLI_LANES
    out, calls, launches, wall = cli_run(
        dev, argv("--steps", str(CLI_STEPS)), what, card)
    if out.state.num_steps < CLI_STEPS:
        raise AssertionError("trained %d steps" % out.state.num_steps)
    if not all(bool(torch.isfinite(p).all())
               for p in out.model.parameters()):
        raise AssertionError("non-finite parameters")
    ckpt = CheckpointManager(data_dir)
    if ckpt.latest_step() != out.state.num_steps:
        raise AssertionError("checkpoints %s" % ckpt.steps())
    check_run_dir(data_dir, out, CLI_EPISODES)
    t_train = part_seconds(calls, "train_ppo")
    t_chunks = part_seconds(calls, "training")
    t_refresh = part_seconds(calls, "refresh")
    t_report = part_seconds(calls, "report")
    t_bench = part_seconds(calls, "benchmark")
    pool = out.bundle.pool_manager.pool
    log("%s, %d steps (%d chunks): the whole command %.3f s = set-up "
        "(build_environments) %.3f s + train_ppo %.3f s + final benchmark "
        "(%d episodes) %.3f s; in train_ppo: chunks %.3f s, %d refreshes "
        "%.4f s, %d reports (side-effect telemetry) %.3f s; %.0f training "
        "env-steps/s over train_ppo, %.0f over the chunks alone; pool "
        "all_goals_static %s, spawner_free %s; summary %s  [%s]"
        % (what, out.state.num_steps, len(calls["training"]), wall,
           wall - t_train - t_bench, t_train, CLI_EPISODES, t_bench,
           t_chunks, len(calls.get("refresh", [])), t_refresh,
           len(calls.get("report", [])), t_report,
           out.state.num_steps / t_train, out.state.num_steps / t_chunks,
           pool.all_goals_static, pool.spawner_free,
           json.dumps(out.summary), card))
    first = dict(launches=launches, wall=wall, train_ppo=t_train,
                 chunks=t_chunks, refresh=t_refresh, report=t_report,
                 benchmark=t_bench, steps=out.state.num_steps)

    saved, _, step = ckpt.restore(device=dev)
    out, calls, _, _ = cli_run(dev, argv("--steps", str(RESUME_STEPS)),
                               "CLI resume to %d steps" % RESUME_STEPS, card)
    (ws, obs, _, rstep), = [c[3] for c in calls["restore"]]
    mgr = out.bundle.pool_manager
    if rstep != step or obs is None or len(calls["restore_pool"]) != 1:
        raise AssertionError("the resume restored step %s, env state %s"
                             % (rstep, obs is not None))
    if out.state.num_steps < RESUME_STEPS or len(calls["training"]) != 1:
        raise AssertionError("the resume trained to %d in %d chunks"
                             % (out.state.num_steps, len(calls["training"])))
    if not torch.equal(ws.env.board, saved["env_state"].env.board):
        raise AssertionError("restored env state differs")
    # Slots that no refresh replaced since hold the checkpointed levels.
    kept = sorted(mgr._restored_meta or {})
    idx = torch.as_tensor(kept, dtype=torch.int64, device=dev)
    for f in ("board", "goals", "agent_locs", "points_table"):
        if not torch.equal(getattr(mgr.pool, f).index_select(0, idx),
                           getattr(saved["pool"], f).index_select(0, idx)):
            raise AssertionError("restored pool %s differs" % f)
    log("CLI resume: restored step %d with its env state and pool (%d of "
        "%d slots not refreshed since, equal to the checkpoint), trained "
        "to %d in one chunk" % (rstep, len(kept), mgr.pool.num_levels,
                                out.state.num_steps))

    out, calls, _, _ = cli_run(
        dev, argv("--run-type", "benchmark", "-x",
                  json.dumps({"env.pool_size": BENCH_POOL})),
        "CLI --run-type benchmark", card)
    latest, _, _ = ckpt.restore(device=dev)
    if out.state is not None or calls.get("training"):
        raise AssertionError("the benchmark run trained")
    for k, v in out.model.state_dict().items():
        if not torch.equal(v, latest["params"][k]):
            raise AssertionError("benchmarked parameters %s differ from the "
                                 "checkpoint's" % k)
    check_run_dir(data_dir, out, CLI_EPISODES)
    log("CLI --run-type benchmark: the checkpoint at step %d read back, %d "
        "episodes, summary %s" % (ckpt.latest_step(), CLI_EPISODES,
                                  json.dumps(out.summary)))
    return first


def run_trainer_4096(dev, bundle, card):
    """``train_ppo`` on the start-up pool at BIG_LANES lanes for one chunk
    with ``test_interval`` one chunk's steps, so that ``run_validation``
    runs on the card; launches read around it and the chunk split into
    training, refresh, report and validation."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.training import train as T

    chunk = 8 * 20 * BIG_LANES
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with trainer_parts() as calls:
        t0 = time.perf_counter()
        model, ps = T.train_ppo(bundle, total_steps=chunk,
                                batch_size=BIG_LANES, seed=2,
                                test_interval=chunk, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    what = "train_ppo at %d lanes" % BIG_LANES
    want = check_trainer_launches(what, launches, calls)
    if ps.num_steps != chunk or len(calls.get("validation", [])) != 1 \
            or len(calls["training"]) != 1:
        raise AssertionError("%s: %d steps, %d validations" % (
            what, ps.num_steps, len(calls.get("validation", []))))
    if not all(bool(torch.isfinite(p).all()) for p in model.parameters()):
        raise AssertionError("non-finite parameters")
    summary = calls["validation"][0][3]
    t = {k: part_seconds(calls, k)
         for k in ("training", "refresh", "report", "validation")}
    log("%s, one chunk of %d steps: train_ppo %.3f s = chunk (8 "
        "iterations) %.3f s + refresh %.4f s + report (side-effect "
        "telemetry) %.3f s + validation (%d levels, 1000 steps, side "
        "effects) %.3f s + the rest (network, reset) %.3f s; %.0f training "
        "env-steps/s over chunk + refresh + report, %.0f with validation; "
        "launches %s, derived %s; validation %s  [%s]"
        % (what, chunk, wall, t["training"], t["refresh"], t["report"],
           len(bundle.validation_levels), t["validation"],
           wall - sum(t.values()),
           chunk / (t["training"] + t["refresh"] + t["report"]),
           chunk / sum(t.values()), json.dumps(launches),
           json.dumps(want), json.dumps(summary), card))


def run_trainer_phase(dev, card):
    """Phase 7: the level generator and the trainer on the card. The
    BIG_LANES run trains on its start-up pool's bundle before the CLI runs,
    each of which starts from a fresh process state."""
    fresh_cli_state()
    check_workers_match_serial(card)
    bundles = startup_pools(dev, card)
    try:
        run_trainer_4096(dev, bundles[BIG_LANES][0], card)
        first = run_trainer_cli(dev, card)
    finally:
        for bundle, _ in bundles.values():
            bundle.pool_manager.close()
    return first, {k: v[1] for k, v in bundles.items()}


# ---------------------------------------------------------------------------
# Phase 8: the DQN path


#: Lane counts of the DQN path: the CLI's default batch and the training
#: batch.
DQN_LANES = (64, 4096)
DQN_UNITS = 32  # a chunk of train_dqn
#: The card-vs-CPU check: units of one step at 64 lanes on one prune-dynamic
#: level whose lanes time out after 5 steps (their rings flush).
DQN_CPU_UNITS = 8
DQN_CPU_REPLAY = 4096
DQN_CPU_INITIAL = 256


def q_network(dev, seed, channels=False):
    """The Q network on packed 25x25 views (uint8 channels with
    ``channels``), with torch's default init drawn on the CPU from
    ``seed`` (the same parameters on every device)."""
    from safelife_tpu_torch.models.nets import (SafeLifeQNetwork,
                                                TRAINING_CHANNELS)

    obs = ({"num_channels": len(TRAINING_CHANNELS)} if channels
           else {"unpack_channels": TRAINING_CHANNELS})
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = SafeLifeQNetwork(view_shape=VIEW, device="cpu", **obs)
    return net.to(dev)


def dqn_cuts(lanes):
    """The cuts of ``DQNConfig()`` that let updates and target syncs happen
    inside the smoke: ``replay_initial`` (40,000) and, at 64 lanes,
    ``target_update_interval`` (10,000) to 16 units' steps at most."""
    return {"replay_initial": min(4096, 16 * lanes),
            "target_update_interval": min(10_000, 16 * lanes)}


def flat_params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


@contextlib.contextmanager
def wrapped(module, name, before=None, after=None):
    """Call ``before(args)`` and ``after(args, result)`` around each call of
    ``module.name`` (looked up at call time by the module's own code)."""
    fn = getattr(module, name)

    def call(*args, **kwargs):
        if before:
            before(args)
        out = fn(*args, **kwargs)
        if after:
            after(args, out)
        return out

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, fn)


def dqn_checked_units(run, units):
    """``units`` collect-and-optimize units of ``run``, each checked: the
    replay's push count grows by the valid emissions, the parameters stay
    put while the buffer is cold and move once it is warm, the target
    equals the model right after a crossing and differs from it on a warm
    unit without one, the loss is finite, and TF32 is off in every
    forward and backward of every layer of both networks. Returns ({"cold",
    "warm", "crossed": warm crossings: unit counts}, layer runs probed)."""
    from safelife_tpu_torch.training import dqn as D

    ds, cfg, lanes = run["ds"], run["cfg"], run["obs"].shape[0]
    valid = []
    counts = {"cold": 0, "warm": 0, "crossed": 0}
    every = cfg.target_update_interval
    with contextlib.ExitStack() as stack:
        tf32 = stack.enter_context(tf32_probe(ds.model))
        tf32_target = stack.enter_context(tf32_probe(ds.target_model))
        stack.enter_context(wrapped(
            D, "step_trajectories",
            after=lambda _, out: valid.append(int(out[1]["valid"].sum()))))
        for _ in range(units):
            idx0, before = ds.replay.idx, flat_params(ds.model)
            valid.clear()
            m = dqn_unit(run)
            if ds.replay.idx - idx0 != sum(valid):
                raise AssertionError("replay.idx grew by %d, %d valid "
                                     "emissions" % (ds.replay.idx - idx0,
                                                    sum(valid)))
            warm = m["replay_size"] >= cfg.replay_initial
            moved = not torch.equal(before, flat_params(ds.model))
            n = ds.num_steps
            crossed = n // every > (n - run["n_steps"] * lanes) // every
            same = torch.equal(flat_params(ds.model),
                               flat_params(ds.target_model))
            if moved != warm or (crossed and not same) \
                    or (warm and not crossed and same):
                raise AssertionError(
                    "unit at %d steps: warm %s, parameters moved %s, "
                    "crossed %s, target equal %s" % (n, warm, moved, crossed,
                                                     same))
            if not torch.isfinite(m["loss"]):
                raise AssertionError("non-finite loss")
            counts["warm" if warm else "cold"] += 1
            counts["crossed"] += warm and crossed
    runs = tf32 + tf32_target
    if any(runs) or not tf32 or not tf32_target:
        raise AssertionError("TF32 was allowed in %d of %d layer runs"
                             % (sum(runs), len(runs)))
    return counts, len(runs)


def dqn_unit(run, actions=None, sample_idx=None):
    """One ``collect_and_optimize`` unit of ``run``; returns its metrics."""
    from safelife_tpu_torch.training import dqn as D

    run["ds"], run["ws"], run["obs"], m = D.collect_and_optimize(
        run["env"], run["wcfg"], run["cfg"], run["pool"], run["ds"],
        run["ws"], run["obs"], run["gen"], run["n_steps"], actions=actions,
        sample_idx=sample_idx, device=run["dev"])
    return m


def dqn_setup(dev, pool, lanes, env_cfg, wcfg, seed, **cuts):
    """A DQN learner at full width (the Q network on the views of
    ``env_cfg``: packed 25x25, or uint8 channels, ``DQNConfig()`` with
    ``cuts``) on ``lanes`` fresh lanes of ``pool``."""
    from safelife_tpu_torch.env import wrappers as W
    from safelife_tpu_torch.training import dqn as D

    cfg = D.DQNConfig(**cuts)
    run = dict(pool=pool, env=env_cfg, wcfg=wcfg, cfg=cfg, dev=dev,
               gen=torch.Generator(device=dev).manual_seed(seed),
               n_steps=max(cfg.optimize_interval // lanes, 1))
    channels = env_cfg.output_channels
    obs = ((VIEW, torch.int32) if channels is None
           else (VIEW + (len(channels),), torch.uint8))
    run["ds"] = D.init_dqn_state(
        cfg, q_network(dev, seed, channels is not None),
        lanes * pool.num_agents, *obs, device=dev)
    run["ws"], run["obs"] = W.reset(env_cfg, wcfg, pool, lanes, device=dev)
    return run


def run_dqn_path(dev, levels, lanes, card):
    """The DQN path on append-spawn (phase 5's levels, the inaction
    baseline) at ``lanes`` lanes: one checked warm-up chunk of DQN_UNITS
    units (``dqn_checked_units``), then one timed ``train_chunk`` with the
    launch counts zeroed just before and read just after, CUDA events
    around its collect and optimize halves. Returns the timed chunk's
    numbers."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.training import dqn as D

    cuts = dqn_cuts(lanes)
    run = dqn_setup(dev, pack_levels(levels, device=dev), lanes,
                    E.EnvConfig(view_shape=VIEW, output_channels=None),
                    W.WrapperConfig(se_baseline="inaction"), 20, **cuts)
    ds, cfg = run["ds"], run["cfg"]
    counts, layer_runs = dqn_checked_units(run, DQN_UNITS)
    if not counts["cold"] or not counts["warm"] or not counts["crossed"]:
        raise AssertionError("warm-up chunk: %s" % counts)

    halves = {"collect": [], "optimize": []}

    def timed(name):
        def before(_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            halves[name].append([ev])

        def after(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            halves[name][-1].append(ev)
        return wrapped(D, name, before, after)

    idx0 = ds.replay.idx
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with trainer_parts() as calls, timed("collect"), timed("optimize"):
        t0 = time.perf_counter()
        run["ds"], run["ws"], run["obs"], m = D.train_chunk(
            run["env"], run["wcfg"], cfg, run["pool"], ds, run["ws"],
            run["obs"], run["gen"], run["n_steps"], DQN_UNITS,
            device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    what = "DQN chunk at %d lanes" % lanes
    want = check_trainer_launches(what, launches, calls)
    if want["fused_actions_advance"] != DQN_UNITS * run["n_steps"]:
        raise AssertionError("%s: %s" % (what, want))
    if m["replay_size"] < cfg.replay_initial or not torch.isfinite(
            m["loss"]) or ds.replay.idx <= idx0:
        raise AssertionError("%s: replay %d, loss %s" % (
            what, m["replay_size"], float(m["loss"])))
    split = {k: sum(a.elapsed_time(b) for a, b in v)
             for k, v in halves.items()}
    steps = DQN_UNITS * run["n_steps"] * lanes
    log("DQN path (append-spawn, inaction baseline; DQNConfig() with a "
        "%d-entry replay, batch %d, cut: replay_initial %d, "
        "target_update_interval %d) at %d lanes: warm-up chunk checked "
        "(%d cold units, %d warm, %d warm crossings; replay.idx = valid "
        "emissions; parameters still while cold and moving once warm; target "
        "= model right after a crossing, != on warm units before one; TF32 "
        "allowed in 0 of %d layer runs); timed chunk of %d units x %d step "
        "(%d env steps) %.3f ms: collect %.3f ms, optimize %.3f ms (CUDA "
        "events); %.0f training env-steps/s; replay %d entries, loss %.5f, "
        "epsilon %.4f; launches %s  [%s]"
        % (cfg.replay_size, cfg.batch_size, cuts["replay_initial"],
           cuts["target_update_interval"], lanes, counts["cold"],
           counts["warm"], counts["crossed"], layer_runs, DQN_UNITS,
           run["n_steps"], steps, wall * 1e3, split["collect"],
           split["optimize"], steps / wall, m["replay_size"],
           float(m["loss"]), float(m["epsilon"]), json.dumps(launches),
           card))
    wall_us, busy = profile_window(
        lambda: [dqn_unit(run) for _ in range(8)],
        "8 DQN units at %d lanes" % lanes, "unit", 8, top=12)
    return dict(lanes=lanes, wall_ms=wall * 1e3, steps=steps,
                busy=busy / wall_us, **split)


def check_dqn_against_cpu(dev, level, card):
    """DQN_CPU_UNITS collect-and-optimize units at 64 lanes on the card and
    on the CPU from the same parameters, one prune-dynamic level (no
    spawners: the two devices' generators draw different seed words),
    lanes timing out after 5 steps, the same numpy actions and sample
    indices on both: replay contents and ``idx`` bit for bit; the first
    warm unit's loss within 1e-5 relative and its gradients within 6e-5 of
    their norm (phase 5's bounds); the parameters after the last unit
    within 5% of the update's norm."""
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels

    lanes = 64
    rng = np.random.default_rng(21)
    actions = rng.integers(0, 9, (DQN_CPU_UNITS, 1, lanes, 1)).astype(
        np.int32)
    samples = rng.integers(0, DQN_CPU_INITIAL, (DQN_CPU_UNITS, 96))
    sides = []
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        run = dqn_setup(d, pack_levels([level], device=d), lanes,
                        E.EnvConfig(view_shape=VIEW, output_channels=None,
                                    time_limit=5),
                        W.WrapperConfig(), 21, replay_size=DQN_CPU_REPLAY,
                        replay_initial=DQN_CPU_INITIAL)
        start = flat_params(run["ds"].model).cpu()
        first = None
        for u in range(DQN_CPU_UNITS):
            m = dqn_unit(run, torch.from_numpy(actions[u]), samples[u])
            if first is None and m["replay_size"] >= DQN_CPU_INITIAL:
                first = (u, float(m["loss"]), torch.cat(
                    [p.grad.reshape(-1) for p in run["ds"].model.parameters()]
                ).cpu().double())
        if first is None:
            raise AssertionError("the replay never warmed")
        r = run["ds"].replay
        sides.append((first, {k: getattr(r, k).cpu() for k in (
            "obs", "action", "reward", "next_obs", "done")}, r.idx,
            flat_params(run["ds"].model).cpu().double(),
            time.perf_counter() - t0))
    ((uc, lc, gc), rc, ic, pc, card_s), ((uh, lh, gh), rh, ih, ph, cpu_s) = \
        sides
    for k in rc:
        if not torch.equal(rc[k], rh[k]):
            raise AssertionError("DQN replay %s differs card vs CPU" % k)
    loss = abs(lc - lh) / max(abs(lh), 1e-30)
    grad = float((gc - gh).norm() / gh.norm())
    update = float((pc - ph).norm() / (ph - start.double()).norm())
    log("DQN on the card vs the CPU (64 lanes, %d units, one prune-dynamic "
        "level, time limit 5, the same actions and sample indices): replay "
        "(%d entries pushed, %d held) and idx bit for bit; first warm unit "
        "(%d) "
        "loss rel %.2e, gradients |dg| / |g| %.2e; parameters after %d Adam "
        "steps |dp| / |update| %.2e; %.1f s on the card, %.1f s on the CPU"
        "  [%s]" % (DQN_CPU_UNITS, ic, min(ic, DQN_CPU_REPLAY), uc, loss,
                    grad, DQN_CPU_UNITS - uc, update, card_s, cpu_s, card))
    if ic != ih or uc != uh:
        raise AssertionError("idx %d vs %d, first warm unit %d vs %d"
                             % (ic, ih, uc, uh))
    if loss > LEARNER_LOSS_REL or grad > LEARNER_GRAD_NORM \
            or update > LEARNER_UPDATE_NORM:
        raise AssertionError("the DQN learner on the card differs from the "
                             "CPU path beyond its tolerance")


@contextlib.contextmanager
def restored_learners():
    """Snapshots of the learner (parameters, target, Adam) as each
    ``_restore_latest`` call leaves it; yields the list."""
    from safelife_tpu_torch.training import train as T

    snaps = []

    def snap(args, _):
        learner = args[1]
        snaps.append({
            "params": {k: v.clone()
                       for k, v in learner.model.state_dict().items()},
            "target": {k: v.clone()
                       for k, v in learner.target_model.state_dict().items()},
            "adam": [(float(st["step"]), st["exp_avg"].clone())
                     for st in learner.optimizer.state.values()]})

    with wrapped(T, "_restore_latest", after=snap):
        yield snaps


def run_dqn_cli(dev, card):
    """The CLI with ``--algo dqn`` at CLI_LANES lanes: train CLI_STEPS steps
    with the final benchmark; resume to RESUME_STEPS (the learner, the
    target network, Adam, the env state and the pool); then ``--run-type
    benchmark --algo dqn``. Launches equal to what the calls derive."""
    import os

    from safelife_tpu_torch.models.nets import SafeLifeQNetwork
    from safelife_tpu_torch.training.checkpoints import CheckpointManager

    data_dir = os.path.join("runs", "chip-smoke-dqn-%d" % os.getpid())
    cuts = json.dumps({"dqn.replay_initial": 4096,
                       "dqn.report_interval": 4096})

    def argv(*extra):
        return ["train", data_dir, "--algo", "dqn", "-e", TRAINER_TASK,
                "--batch", str(CLI_LANES), "--seed", "1",
                "--benchmark-episodes", str(CLI_EPISODES), *extra]

    what = "CLI --algo dqn at %d lanes" % CLI_LANES
    out, calls, launches, wall = cli_run(
        dev, argv("--steps", str(CLI_STEPS), "-x", cuts), what, card)
    ds = out.state
    if ds.num_steps < CLI_STEPS or not isinstance(out.model, SafeLifeQNetwork):
        raise AssertionError("trained %d steps" % ds.num_steps)
    if not all(bool(torch.isfinite(p).all()) for p in out.model.parameters()):
        raise AssertionError("non-finite parameters")
    ckpt = CheckpointManager(data_dir)
    saved, _, step = ckpt.restore(device=dev)
    if step != ds.num_steps or "target_params" not in saved:
        raise AssertionError("checkpoints %s" % ckpt.steps())
    if not len(calls.get("report", [])):
        raise AssertionError("no report")
    check_run_dir(data_dir, out, CLI_EPISODES)
    t_train = part_seconds(calls, "train_dqn")
    t_chunks = part_seconds(calls, "dqn_training")
    log("%s, %d steps (%d chunks of %d units), replay_initial cut to 4096: "
        "the whole command %.3f s = set-up %.3f s + train_dqn %.3f s + final "
        "benchmark (%d episodes) %.3f s; chunks %.3f s, %d refreshes %.4f s, "
        "%d reports %.4f s; %.0f training env-steps/s over train_dqn, %.0f "
        "over the chunks alone; replay %d entries; summary %s  [%s]"
        % (what, ds.num_steps, len(calls["dqn_training"]), DQN_UNITS, wall,
           wall - t_train - part_seconds(calls, "benchmark"), t_train,
           CLI_EPISODES, part_seconds(calls, "benchmark"), t_chunks,
           len(calls.get("refresh", [])), part_seconds(calls, "refresh"),
           len(calls["report"]), part_seconds(calls, "report"),
           ds.num_steps / t_train, ds.num_steps / t_chunks,
           ds.replay.size(), json.dumps(out.summary), card))
    first = dict(launches=launches, wall=wall, train=t_train,
                 chunks=t_chunks, steps=ds.num_steps)

    with restored_learners() as snaps:
        out, calls, _, _ = cli_run(
            dev, argv("--steps", str(RESUME_STEPS), "-x", cuts),
            "CLI --algo dqn resume to %d steps" % RESUME_STEPS, card)
    (ws, obs, _, rstep), = [c[3] for c in calls["restore"]]
    snap, = snaps
    if rstep != step or obs is None or len(calls["restore_pool"]) != 1 \
            or out.state.num_steps < RESUME_STEPS:
        raise AssertionError("the resume restored step %s, env state %s, "
                             "trained to %d" % (rstep, obs is not None,
                                                out.state.num_steps))
    if not torch.equal(ws.env.board, saved["env_state"].env.board):
        raise AssertionError("restored env state differs")
    for k, v in saved["params"].items():
        if not (torch.equal(snap["params"][k], v)
                and torch.equal(snap["target"][k], saved["target_params"][k])):
            raise AssertionError("restored parameters or target %s differ" % k)
    adam = saved["opt_state"]["state"].values()
    if not adam or len(adam) != len(snap["adam"]):
        raise AssertionError("no Adam state restored (a cold run)")
    for (n, avg), st in zip(snap["adam"], adam):
        if n != float(st["step"]) or not torch.equal(avg, st["exp_avg"]):
            raise AssertionError("restored Adam state differs")
    log("CLI --algo dqn resume: restored step %d with the learner, target "
        "network, Adam (step %d), env state and pool; trained to %d, the "
        "replay re-warmed from empty (%d entries)"
        % (rstep, snap["adam"][0][0], out.state.num_steps,
           out.state.replay.idx))

    out, calls, _, _ = cli_run(
        dev, argv("--run-type", "benchmark", "-x",
                  json.dumps({"env.pool_size": BENCH_POOL})),
        "CLI --run-type benchmark --algo dqn", card)
    latest, _, _ = ckpt.restore(device=dev)
    if out.state is not None or calls.get("dqn_training") \
            or not isinstance(out.model, SafeLifeQNetwork):
        raise AssertionError("the benchmark run trained")
    for k, v in out.model.state_dict().items():
        if not torch.equal(v, latest["params"][k]):
            raise AssertionError("benchmarked parameters %s differ from the "
                                 "checkpoint's" % k)
    check_run_dir(data_dir, out, CLI_EPISODES)
    log("CLI --run-type benchmark --algo dqn: the checkpoint at step %d read "
        "back, %d episodes, summary %s" % (ckpt.latest_step(), CLI_EPISODES,
                                           json.dumps(out.summary)))
    return first


def run_dqn_phase(dev, spawn, prune, card):
    """Phase 8: the DQN path at DQN_LANES, the card against the CPU, and
    the CLI with ``--algo dqn``."""
    fresh_cli_state()
    chunks = [run_dqn_path(dev, spawn, lanes, card) for lanes in DQN_LANES]
    check_dqn_against_cpu(dev, prune[0], card)
    return chunks, run_dqn_cli(dev, card)


# ---------------------------------------------------------------------------
# Phase 9: the front end

#: The task of the card-vs-CPU check (no spawners: the card's and the CPU's
#: generators draw different seed words), and of the timed runs (spawners,
#: the default auto-reset), at the main path's widths.
FRONT_END_TASK = "safelife-append-still-v1"
FRONT_END_RATE_TASK = "safelife-prune-spawn-v1"
FRONT_END_LANES = (LANES, 4096)
FRONT_END_STEPS = 200
#: Keys that play ``play_level`` to its end: up to the green block, destroy
#: two of its cells (the rest dies), wait a step, walk round to the exit.
PLAY_KEYS = ["UP", " ", "LEFT", "UP", " ", "c", "RIGHT", "RIGHT", "RIGHT",
             "DOWN", "RIGHT"]
PLAY_SAMPLES = 200  # interactive.GameLoop.end_of_level_summary's num_samples
#: Tensor fields of a level pool that the card and the CPU must share.
POOL_FIELDS = ("board", "goals", "agent_locs", "agent_mask", "points_table",
               "min_performance", "spawn_prob", "exit_locs",
               "exit_locs_valid", "goals_static", "reset_boards")


def make_launches(pool, steps, resets=1):
    """K1-K3 launches of ``resets`` resets and ``steps`` steps of a
    ``make(...)`` env on ``pool``, derived from ``env/env.py``: K1 and K3
    once a step, K3 once a reset, K2 once a step where goals evolve."""
    return {"fused_actions_advance": steps,
            "advance": 0 if pool.all_goals_static else steps,
            "recenter_views": steps + resets}


def check_make_against_cpu(dev, lanes=64, steps=FRONT_END_STEPS):
    """``make(FRONT_END_TASK, auto_reset=False)`` on the card and on the
    CPU from the same seed: equal pools, then the same NumPy actions for
    ``steps`` steps with boards, observations, rewards and done flags
    exact; the card's launches equal to ``make_launches``."""
    from safelife_tpu_torch import ops, registry

    envs = []
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        envs.append(registry.make(FRONT_END_TASK, batch_size=lanes, seed=8,
                                  device=d, auto_reset=False))
        made = time.perf_counter() - t0
    card, host = envs
    for f in POOL_FIELDS:
        if not torch.equal(getattr(card.pool, f).cpu(),
                           getattr(host.pool, f)):
            raise AssertionError("make(...) pools differ in %s" % f)
    rng = np.random.default_rng(8)
    actions = rng.integers(0, 9, (steps, lanes)).astype(np.int32)
    ops.reset_launch_counts()
    obs = [e.reset().cpu() for e in envs]
    if not torch.equal(*obs):
        raise AssertionError("make(...) reset observations differ")
    for t, a in enumerate(actions):
        out = [[x.cpu() for x in e.step(a)[:3]] + [e.state.board.cpu()]
               for e in envs]
        for i, what in enumerate(("observations", "rewards", "done",
                                  "boards")):
            if not torch.equal(out[0][i], out[1][i]):
                raise AssertionError("make(...) %s differ at step %d"
                                     % (what, t))
    launches = ops.launch_counts()
    check_launches("make(...) on the card", launches,
                   make_launches(card.pool, steps))
    moved = int((card.state.board.cpu() != host.pool.board[
        torch.arange(lanes) % host.pool.num_levels]).any(-1).any(-1).sum())
    log("front end: make(%r, %d lanes, auto_reset=False) card vs CPU, %d "
        "steps: observations, rewards, done, boards exact; %d lanes "
        "changed; launches %s; a make() %.2f s (16 generated levels)"
        % (FRONT_END_TASK, lanes, steps, moved, json.dumps(launches), made))
    return launches


def make_rate(dev, lanes, card, steps=FRONT_END_STEPS):
    """env-steps/s of ``make(FRONT_END_RATE_TASK)`` (spawners, auto-reset)
    at ``lanes`` lanes: a reset and ``steps`` steps of NumPy actions (one
    host-to-device copy a step), against the bare ``env.step`` on the same
    pool with the actions already on the card, in turns (make, bare, bare,
    make) after a warm-up; the launches of the first make run equal to
    ``make_launches``."""
    from safelife_tpu_torch import ops, registry
    from safelife_tpu_torch.env import env as E

    env = registry.make(FRONT_END_RATE_TASK, batch_size=lanes, seed=9,
                        device=dev)
    rng = np.random.default_rng(lanes)
    actions = rng.integers(0, 9, (steps, lanes)).astype(np.int32)
    on_card = torch.from_numpy(actions).to(dev)[:, :, None]
    gen = torch.Generator(device=dev).manual_seed(9)

    def with_make():
        env.reset()
        for a in actions:
            env.step(a)

    def bare():
        state, _ = E.reset(env.cfg, env.pool, lanes)
        for a in on_card:
            state = E.step(env.cfg, env.pool, state, a, gen)[0]

    env.reset()
    for a in actions[:3]:
        env.step(a)
    torch.cuda.synchronize()
    walls = {"make": [], "bare": []}
    launches = None
    for which in ("make", "bare", "bare", "make"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        (with_make if which == "make" else bare)()
        torch.cuda.synchronize()
        walls[which].append(time.perf_counter() - t0)
        if launches is None:
            launches = ops.launch_counts()
            check_launches("make(...) at %d lanes" % lanes, launches,
                           make_launches(env.pool, steps))
    rate = {k: lanes * steps / (sum(v) / len(v)) for k, v in walls.items()}
    out = {"lanes": lanes, "make": rate["make"], "bare": rate["bare"],
           "ratio": rate["make"] / rate["bare"]}
    log("front end: make(%r) at %d lanes x %d steps: %.0f env-steps/s "
        "(walls %s s), bare env.step %.0f (walls %s s), ratio %.3f; "
        "launches a run %s  [%s]"
        % (FRONT_END_RATE_TASK, lanes, steps, out["make"],
           ["%.4f" % w for w in walls["make"]], out["bare"],
           ["%.4f" % w for w in walls["bare"]], out["ratio"],
           json.dumps(launches), card))
    return out


def play_level(path, n=26):
    """A level without spawners: the agent in the middle facing up, a green
    block (a still life) on green goals above it, an exit to its right, and
    no points needed to leave."""
    from safelife_tpu_torch.core import cells as C
    from safelife_tpu_torch.core.scoring import DEFAULT_POINTS_TABLE
    from safelife_tpu_torch.io import levels as L

    c = n // 2
    board = np.zeros((n, n), np.int32)
    goals = np.zeros((n, n), np.int32)
    board[c, c] = C.PLAYER
    board[c - 3:c - 1, c - 1:c + 1] = C.LIFE | C.COLOR_G
    goals[c - 4:c, c - 2:c + 2] = C.COLOR_G
    board[c, c + 3] = C.LEVEL_EXIT
    L.save_level(L.Level(
        board=board, goals=goals, agent_locs=np.array([[c, c]]),
        agent_names=np.array(["agent0"]),
        points_table=DEFAULT_POINTS_TABLE[None].astype(np.int32),
        min_performance=0.0, spawn_prob=0.3, name="play-still"), path)
    return path


def check_play_summary(dev, card):
    """A ``GameLoop`` on the card and one on the CPU, played by PLAY_KEYS
    to the end of ``play_level``: the end-of-level summary (side effects
    with ``num_samples`` 200, their weighted total, the combined score)
    equal within 1e-9, the card's K2 launches equal to the occupancy's
    pre-steps plus 2 x 200 (and no K1 or K3), the recording written."""
    import os
    import shutil

    from safelife_tpu_torch import interactive, ops
    from safelife_tpu_torch.io.iterator import SafeLifeLevelIterator

    work = os.path.join("runs", "chip-smoke-play-%d" % os.getpid())
    os.makedirs(work)
    try:
        level = play_level(os.path.join(work, "play-still.npz"))
        results = []
        for d in (dev, torch.device("cpu")):
            loop = interactive.GameLoop(
                SafeLifeLevelIterator(level, seed=1),
                record_to=os.path.join(work, d.type), device=d)
            loop.next_level(+1)
            for key in PLAY_KEYS:
                loop.handle_play_key(key)
            if loop.game.game_over is not True:
                raise AssertionError("the scripted keys did not end the "
                                     "level on %s" % d)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            se, score = loop.end_of_level_summary()
            if d.type == "cuda":
                torch.cuda.synchronize()
            results.append((se, score, time.perf_counter() - t0,
                            ops.launch_counts()))
            if not os.path.exists(loop.save_recording()):
                raise AssertionError("no recording on %s" % d)
        (cse, cscore, cs, launches), (hse, hscore, hs, _) = results
        if set(cse) != set(hse):
            raise AssertionError("summary keys differ: %s vs %s"
                                 % (sorted(cse), sorted(hse)))
        err = abs(cscore - hscore)
        for k in cse:
            err = max(err, float(np.max(np.abs(np.subtract(cse[k],
                                                           hse[k])))))
        if err > 1e-9:
            raise AssertionError("play summary card vs CPU differs by %g"
                                 % err)
        steps = loop.game.num_steps
        check_launches("play's summary", launches, {
            "fused_actions_advance": 0, "recenter_views": 0,
            "advance": max(steps, 1) + 2 * PLAY_SAMPLES})
    finally:
        shutil.rmtree(work)
    log("front end: play's end-of-level summary after %d steps on a 26x26 "
        "still level: %.3f s on the card, %.3f s on the CPU; card vs CPU "
        "max |d| %.2e; life-green %s, score %.3f; launches %s  [%s]"
        % (steps, cs, hs, err, cse.get("life-green"), cscore,
           json.dumps(launches), card))
    return {"seconds": cs, "launches": launches}


def check_history_render(dev, levels, card, steps=1000):
    """A 1000-step history of one prune-spawn v1.0 level recorded on the
    card (random actions, no auto-reset), rendered by
    ``render/graphics.render_board`` on the card and on the host: equal
    frames; frames/s of each."""
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.render.graphics import render_board

    pool = pack_levels(levels[:1], device=dev)
    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None,
                      auto_reset=False)
    gen = torch.Generator(device=dev).manual_seed(3)
    state, _ = E.reset(cfg, pool, 1)
    acts = torch.randint(0, 9, (steps, 1, 1), dtype=torch.int32,
                         generator=gen, device=dev)
    boards, goals = [state.board[0]], [state.goals[0]]
    for a in acts:
        state = E.step(cfg, pool, state, a, gen)[0]
        boards.append(state.board[0])
        goals.append(state.goals[0])
    boards, goals = torch.stack(boards), torch.stack(goals)
    render_board(boards[:2], goals[:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = render_board(boards, goals)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    hb, hg = boards.cpu().numpy(), goals.cpu().numpy()
    t0 = time.perf_counter()
    on_host = render_board(hb, hg)
    host_s = time.perf_counter() - t0
    if not isinstance(on_card, torch.Tensor) or on_card.device != dev:
        raise AssertionError("render_board of a card tensor left the card")
    if not torch.equal(on_card.cpu(), torch.from_numpy(on_host)):
        raise AssertionError("the card's render differs from the host's")
    n = boards.shape[0]
    log("front end: render_board of a %d-frame card history (%dx%d): equal "
        "to the host's; card %.0f frames/s (%.4f s), host %.0f frames/s "
        "(%.4f s)  [%s]"
        % (n, boards.shape[1], boards.shape[2], n / card_s, card_s,
           n / host_s, host_s, card))
    return {"card_fps": n / card_s, "host_fps": n / host_s}


def check_variants(dev):
    """``variants.advance_board_general`` on the card against the CPU with
    ``spawn_prob`` 0 (no draw matters), on soups with spawners over two
    leading batch dims and three rules."""
    from safelife_tpu_torch import variants

    boards, _ = soup(np.random.default_rng(12), 8 * 64, 26, 26, 1,
                     spawners=True)
    boards = torch.from_numpy(boards.reshape(8, 64, 26, 26))
    changed = 0
    for born, survive in (((3,), (2, 3)), ((3, 6), (2, 3)),
                          ((1, 2, 3, 4, 5, 6, 7, 8), tuple(range(9)))):
        out = [variants.advance_board_general(
            boards.to(d), torch.Generator(device=d).manual_seed(0), 0.0,
            born, survive).cpu() for d in (dev, torch.device("cpu"))]
        if not torch.equal(*out):
            raise AssertionError("advance_board_general differs on the "
                                 "card (B%s/S%s)" % (born, survive))
        changed += int((out[0] != boards).sum())
    log("front end: variants.advance_board_general on (8, 64, 26, 26) "
        "soups with spawners, spawn_prob 0, 3 rules: card equal to the "
        "CPU; %d cells changed" % changed)


def run_front_end_phase(dev, prune_spawn, card):
    """Phase 9: make(...) card vs CPU and its rate at FRONT_END_LANES, the
    play summary, a history's render and the rule variants."""
    t0 = time.perf_counter()
    check_make_against_cpu(dev)
    rates = [make_rate(dev, lanes, card) for lanes in FRONT_END_LANES]
    play = check_play_summary(dev, card)
    render = check_history_render(dev, prune_spawn, card)
    check_variants(dev)
    log("front end (phase 9): %.1f s" % (time.perf_counter() - t0))
    return {"rates": rates, "play": play, "render": render}


# ---------------------------------------------------------------------------


#: Kernel form -> (source, the TPU kernel it replaces, its kernel's name in
#: the profiler).
# ---------------------------------------------------------------------------
# Phase 10: the learner's precision modes, uint8 channel observations,
# device-batched level generation and the oracle step


PRECISION_MODES = ("float32", "tensorfloat32", "bfloat16")
#: Timed train_iterations of each mode and width, after one warm-up.
MODE_ITERS = 2
#: Each mode's bounds on the first minibatch against strict float32 (loss
#: relative, gradients over their norm): on the card against the card's
#: float32 on the same batch and parameters, and card against CPU (where
#: TF32 does not exist, so "tensorfloat32" there is float32). TF32 rounds
#: the products' inputs to a 10-bit mantissa (unit roundoff 2^-11, 4.9e-4)
#: and accumulates in float32: over 55 batches its gradients lay 1.8e-4 of
#: their norm or more from strict float32 (``chip_sweep.py learner``). bfloat16
#: also rounds every layer's output to an 8-bit mantissa (2^-9, 2e-3):
#: on the CPU its gradients lay up to 0.095 of their norm from JAX's
#: float32 (``tests/test_torch_precision.py``). float32 keeps phase 5's.
MODE_BOUNDS = {"float32": (LEARNER_LOSS_REL, LEARNER_GRAD_NORM),
               "tensorfloat32": (1e-3, 1e-2),
               "bfloat16": (1e-2, 0.25)}
CHANNEL_STEPS = 200
PROCGEN_TASK = "random/append-still"
#: ``gen_games_batched``'s device batches timed here; 64 is the CLI run's
#: (its start-up pool and refills).
PROCGEN_BATCHES = (8, 256)
HOST_LEVELS = 32
ORACLE_STEPS = 100


def precision_path(dev, levels, tree, lanes, precision, card):
    """Phase 5's training iteration in ``precision`` at ``lanes`` lanes:
    a warm-up, MODE_ITERS timed iterations with the launch counts zeroed
    just before and read just after (K1, K2 and K3 20 times an iteration
    each), a rollout and an update timed apart, and a profile of the
    update. Returns the times, the rollout's batch and the parameters
    that collected it."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.training import ppo as P

    run = training_setup(dev, levels, tree, lanes, seed=10,
                         precision=precision)
    train_iteration(run)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    iter_ms = [event_ms(lambda: train_iteration(run))[0]
               for _ in range(MODE_ITERS)]
    launches = ops.launch_counts()
    n = run["pcfg"].steps_per_env * MODE_ITERS
    check_launches("%s training at %d lanes" % (precision, lanes), launches,
                   {k: n for k in ("fused_actions_advance", "advance",
                                   "recenter_views")}
                   | {"unpack_planes": ppo_forwards(run["pcfg"], run["obs"])
                      * MODE_ITERS})
    state = model_state(run)
    rollout_ms, batch = event_ms(lambda: rollout_batch(run))
    update_ms, _ = event_ms(lambda: P.train_on_batch(
        run["pcfg"], run["ps"], batch, run["gen"]))
    if not all(bool(torch.isfinite(p).all())
               for p in run["ps"].model.parameters()):
        raise AssertionError("%s: non-finite parameters" % precision)
    samples = run["pcfg"].epochs_per_batch * batch["obs"].shape[0]
    mean = sum(iter_ms) / len(iter_ms)
    log("precision %s at %d lanes: train_iteration %s ms (mean %.3f), "
        "rollout %.3f ms, update %.3f ms; %.0f training env-steps/s, %.0f "
        "learner samples/s; launches %s  [%s]"
        % (precision, lanes, ", ".join("%.3f" % m for m in iter_ms), mean,
           rollout_ms, update_ms,
           run["pcfg"].steps_per_env * lanes / mean * 1e3,
           samples / update_ms * 1e3, json.dumps(launches), card))
    profile_window(lambda: P.train_on_batch(run["pcfg"], run["ps"], batch,
                                            run["gen"]),
                   "the %s update at %d lanes" % (precision, lanes),
                   "update", 1, top=8)
    return dict(iteration=mean, rollout=rollout_ms, update=update_ms,
                samples_per_s=samples / update_ms * 1e3,
                launches=launches), batch, state


def mode_deviation(dev, tree, state, batch, precision):
    """The first minibatch's loss and gradients in ``precision`` on the
    card against strict float32 on the card, from the same parameters
    and batch; with the layer probe, every layer run must see TF32
    allowed under "tensorfloat32" and none otherwise, and under
    "bfloat16" every layer must compute in bfloat16."""
    from safelife_tpu_torch.training import ppo as P

    cfg = P.PPOConfig()
    _, first = first_indices(cfg, batch["obs"].shape[0], 12)
    out = {}
    for mode in ("float32", precision):
        net = policy(tree, dev, mode)
        net.load_state_dict(state)
        dtypes = []
        hooks = [m.register_forward_hook(
            lambda m, i, o: dtypes.append(o.dtype))
            for m in net.modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
        with tf32_probe(net) as tf32:
            out[mode] = first_minibatch(cfg, net, batch, first)
        for h in hooks:
            h.remove()
        want = mode == "tensorfloat32"
        if not tf32 or any(x != want for x in tf32):
            raise AssertionError("%s: TF32 allowed in %d of %d layer runs"
                                 % (mode, sum(tf32), len(tf32)))
        want = torch.bfloat16 if mode == "bfloat16" else torch.float32
        if any(t != want for t in dtypes):
            raise AssertionError("%s: layer outputs %s" % (mode, dtypes))
    return grad_diffs(*out[precision], *out["float32"])


def check_mode_bounds(what, r, precision):
    loss_rel, grad_norm = MODE_BOUNDS[precision]
    if r["loss"] > loss_rel or r["grad_norm"] > grad_norm:
        raise AssertionError("%s: loss rel %.3e (bound %.0e), gradients "
                             "%.3e of their norm (bound %.0e)"
                             % (what, r["loss"], loss_rel, r["grad_norm"],
                                grad_norm))


def run_precision_modes(dev, levels, tree, card):
    """Each learner precision at both widths of phase 5, its deviation
    from strict float32 on the card, and, at 64 lanes, the card against
    the CPU in each new mode (phase 5 holds float32 at both widths)."""
    times = {}
    for lanes in TRAIN_LANES:
        batches = {}
        for precision in PRECISION_MODES:
            times[precision, lanes], batch, state = precision_path(
                dev, levels, tree, lanes, precision, card)
            batches[precision] = (batch, state)
        batch, state = batches["float32"]
        for precision in PRECISION_MODES[1:]:
            r = mode_deviation(dev, tree, state, batch, precision)
            log("precision %s against strict float32 on the card (%d "
                "lanes, the first minibatch of a float32 rollout): loss rel "
                "%.3e, gradients |dg| / |g| %.3e (per tensor: norm %.3e, "
                "max element / max |g| %.3e); bounds %s  [%s]"
                % (precision, lanes, r["loss"], r["grad_norm"],
                   r["grad_tensor_norm"], r["grad_tensor_max"],
                   MODE_BOUNDS[precision], card))
            check_mode_bounds("%s on the card at %d lanes" % (precision,
                                                             lanes),
                              r, precision)
            times[precision, lanes]["vs_float32"] = r
            if lanes == 64:
                batch_p, state_p = batches[precision]
                r = learner_diffs(dev, tree, state_p, batch_p,
                                  precision=precision)
                log("precision %s, learner on the card vs the CPU (%d "
                    "samples): %s  [%s]" % (precision,
                                            batch_p["obs"].shape[0],
                                            learner_line(r), card))
                check_mode_bounds("%s card vs CPU" % precision, r, precision)
                times[precision, lanes]["vs_cpu"] = r
    return times


def check_channels_against_cpu(dev, levels, card, lanes=64,
                               steps=CHANNEL_STEPS):
    """``packed_obs: false`` on the card against the CPU path: prune-
    dynamic (no spawners, goals that evolve) for ``steps`` steps of numpy
    actions at ``lanes`` lanes, the uint8 channels [B, 1, 25, 25, 15] and
    the boards equal every step; K1, K2 and K3 launched once a step (K3
    once more for the reset)."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.models.nets import TRAINING_CHANNELS

    cfg = E.EnvConfig(view_shape=VIEW, output_channels=TRAINING_CHANNELS,
                      auto_reset=False)
    acts = np.random.default_rng(13).integers(
        0, 9, (steps, lanes, 1)).astype(np.int32)
    runs, launched = [], None
    for d in (dev, torch.device("cpu")):
        pool = pack_levels(levels[:lanes], device=d)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        state, obs = E.reset(cfg, pool, lanes)
        gen = torch.Generator(device=d).manual_seed(0)
        out = [(obs.cpu(), state.board.cpu())]
        for t in range(steps):
            state, obs, _, _, _ = E.step(cfg, pool, state,
                                         torch.from_numpy(acts[t]).to(d),
                                         gen)
            out.append((obs.cpu(), state.board.cpu()))
        runs.append(out)
        if launched is None:
            launched = ops.launch_counts()
    if not pool.spawner_free or pool.all_goals_static:
        raise AssertionError("prune-dynamic: spawners or static goals")
    check_launches("packed_obs false on the card", launched, {
        "fused_actions_advance": steps, "advance": steps,
        "recenter_views": steps + 1})
    for t, ((co, cb), (ho, hb)) in enumerate(zip(*runs)):
        if co.dtype != torch.uint8 or tuple(co.shape) != \
                (lanes, 1) + VIEW + (len(TRAINING_CHANNELS),):
            raise AssertionError("channels %s %s" % (co.dtype,
                                                     tuple(co.shape)))
        if not (torch.equal(co, ho) and torch.equal(cb, hb)):
            raise AssertionError("channels or boards differ card vs CPU at "
                                 "step %d" % t)
    log("packed_obs false on the card equals the CPU path (prune-dynamic, "
        "%d lanes x %d steps): uint8 channels [%d, 1, 25, 25, %d] and boards "
        "exact every step; launches %s  [%s]"
        % (lanes, steps, lanes, len(TRAINING_CHANNELS), json.dumps(launched),
           card))
    return launched


def channels_iteration(dev, levels, tree, card, lanes=4096):
    """One PPO iteration at ``lanes`` lanes with uint8 channels beside the
    packed mode, in turns (packed, channels, channels, packed) after a
    warm-up each, launches read around the channels' iterations; the
    trajectory's bytes of each; the same loss from the two modes on the
    same samples."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.models.nets import (
        TRAINING_CHANNELS, learner_precision, unpack_obs)
    from safelife_tpu_torch.training import ppo as P

    runs = {mode: training_setup(dev, levels, tree, lanes, seed=10,
                                 channels=mode == "channels")
            for mode in ("packed", "channels")}
    ms = {"packed": [], "channels": []}
    for mode in runs:
        train_iteration(runs[mode])
    launches = {}
    for mode in ("packed", "channels", "channels", "packed"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ms[mode].append(event_ms(lambda: train_iteration(runs[mode]))[0])
        launches[mode] = ops.launch_counts()
    pcfg = runs["packed"]["pcfg"]
    for mode, n in launches.items():
        check_launches("%s iteration at %d lanes" % (mode, lanes), n,
                       {k: pcfg.steps_per_env
                        for k in ("fused_actions_advance", "advance",
                                  "recenter_views")}
                       | {"unpack_planes": 0 if mode == "channels"
                          else ppo_forwards(pcfg, runs[mode]["obs"])})
    traj_bytes = {}
    batches = {}
    for mode, run in runs.items():
        batch = rollout_batch(run)
        traj_bytes[mode] = batch["obs"].numel() * batch["obs"].element_size()
        batches[mode] = batch
    # The same samples in both forms: the packed rollout's, unpacked.
    cfg = P.PPOConfig()
    b = {k: v[:lanes] for k, v in batches["packed"].items()}
    chans = unpack_obs(b["obs"], TRAINING_CHANNELS).to(torch.uint8)
    state = model_state(runs["packed"])
    losses = {}
    for mode, obs in (("packed", b["obs"]), ("channels", chans)):
        net = policy(tree, dev, channels=mode == "channels")
        net.load_state_dict(state)
        with torch.no_grad(), learner_precision(net.precision, "cuda"):
            losses[mode], _ = P.calculate_loss(
                cfg, net, obs, b["actions"], b["action_prob"], b["values"],
                b["returns"], b["advantages"], b["weight"])
    if not torch.equal(losses["packed"], losses["channels"]):
        raise AssertionError("packed and channels losses differ: %r vs %r"
                             % (float(losses["packed"]),
                                float(losses["channels"])))
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log("packed_obs false at %d lanes: train_iteration %.3f ms (packed "
        "%.3f ms, in turns); trajectory observations %d bytes (packed "
        "%d); the loss of %d samples in both forms %.9g, equal; launches %s"
        "  [%s]" % (lanes, mean["channels"], mean["packed"],
                    traj_bytes["channels"], traj_bytes["packed"], lanes,
                    float(losses["packed"]), json.dumps(launches["channels"]),
                    card))
    return dict(ms=mean, traj_bytes=traj_bytes,
                launches=launches["channels"])


def channels_dqn_chunk(dev, levels, card, lanes=4096):
    """One DQN chunk of DQN_UNITS units at ``lanes`` lanes with uint8
    channels beside the packed mode (each after a warm-up chunk, timed
    in turns), the full 100,000-entry replay, launches equal to
    ``predicted_launches``; the replay's bytes of each mode."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.models.nets import TRAINING_CHANNELS
    from safelife_tpu_torch.training import dqn as D

    pool = pack_levels(levels, device=dev)
    runs = {}
    for mode, out in (("packed", None), ("channels", TRAINING_CHANNELS)):
        runs[mode] = dqn_setup(
            dev, pool, lanes, E.EnvConfig(view_shape=VIEW,
                                          output_channels=out),
            W.WrapperConfig(se_baseline="inaction"), 20, **dqn_cuts(lanes))

    def chunk(run):
        run["ds"], run["ws"], run["obs"], m = D.train_chunk(
            run["env"], run["wcfg"], run["cfg"], run["pool"], run["ds"],
            run["ws"], run["obs"], run["gen"], run["n_steps"], DQN_UNITS,
            device=dev)
        return m

    for run in runs.values():
        chunk(run)
    ms = {"packed": [], "channels": []}
    for mode in ("packed", "channels", "channels", "packed"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with trainer_parts() as calls:
            t0 = time.perf_counter()
            m = chunk(runs[mode])
            torch.cuda.synchronize()
            ms[mode].append((time.perf_counter() - t0) * 1e3)
        check_trainer_launches("%s DQN chunk at %d lanes" % (mode, lanes),
                               ops.launch_counts(), calls)
        if not torch.isfinite(m["loss"]):
            raise AssertionError("%s DQN: non-finite loss" % mode)
    replay = {mode: sum(getattr(run["ds"].replay, k).numel()
                        * getattr(run["ds"].replay, k).element_size()
                        for k in ("obs", "next_obs"))
              for mode, run in runs.items()}
    if runs["channels"]["ds"].replay.obs.dtype != torch.uint8:
        raise AssertionError("the channels replay is not uint8")
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    steps = DQN_UNITS * runs["packed"]["n_steps"] * lanes
    log("packed_obs false, DQN chunk of %d units at %d lanes (%d env "
        "steps): %.3f ms (packed %.3f ms, in turns), %.0f training "
        "env-steps/s (packed %.0f); replay obs + next_obs %d bytes (packed "
        "%d), %d entries  [%s]"
        % (DQN_UNITS, lanes, steps, mean["channels"], mean["packed"],
           steps / mean["channels"] * 1e3, steps / mean["packed"] * 1e3,
           replay["channels"], replay["packed"],
           runs["channels"]["ds"].replay.capacity, card))
    return dict(ms=mean, replay_bytes=replay, steps=steps)


def check_still_levels(levels, what):
    """Each append-still level with its agent, one exit, and the still-life
    invariant: without its agent the board is a fixed point of the CA."""
    from safelife_tpu_torch.core import cells as C
    from safelife_tpu_torch.core.advance_np import advance_board_np

    for lv in levels:
        board = np.asarray(lv.board, np.int64)
        board = board * ((board & C.AGENT) == 0)
        if len(lv.agent_locs) != 1 or ((board & C.EXIT) > 0).sum() != 1 \
                or not (advance_board_np(board) == board).all():
            raise AssertionError("%s: level %s breaks the still-life "
                                 "invariant" % (what, lv.name))


def device_procgen_rates(dev, card):
    """Levels/s of ``gen_games_batched`` for PROCGEN_TASK at each of
    PROCGEN_BATCHES on the card, the annealing iterations counted, beside
    one host worker and the 4-worker pool; every level checked."""
    from safelife_tpu_torch.io.iterator import (SafeLifeLevelIterator,
                                                load_files)
    from safelife_tpu_torch.procgen import anneal_device as AD
    from safelife_tpu_torch.procgen import batched as B

    params = load_files([PROCGEN_TASK])[0][2]
    out = {}
    for n in PROCGEN_BATCHES:
        its = []
        seeds = np.random.SeedSequence(40 + n).spawn(n)
        gen = torch.Generator(device=dev).manual_seed(n)
        with wrapped(AD._Chains, "run",
                     after=lambda args, _: its.append(int(args[0].it))):
            t0 = time.perf_counter()
            levels = B.gen_games_batched(
                [params] * n, [np.random.default_rng(s) for s in seeds], gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        check_still_levels(levels, "device batch %d" % n)
        out[n] = n / dt
        log("device procgen %s, batch %d: %.3f s, %.4f levels/s; %d annealer "
            "runs, %d lockstep iterations (%.4f ms each), the longest run "
            "%d; every level an append-still level (agent, exit, a still "
            "board)  [%s]" % (PROCGEN_TASK, n, dt, n / dt, len(its), sum(its),
                              dt / max(sum(its), 1) * 1e3, max(its), card))
    for workers in (0, 4):
        it = SafeLifeLevelIterator(PROCGEN_TASK,
                                   seed=np.random.SeedSequence(41),
                                   num_workers=workers)
        t0 = time.perf_counter()
        levels = [next(it) for _ in range(HOST_LEVELS)]
        dt = time.perf_counter() - t0
        it.close()
        check_still_levels(levels, "host, %d workers" % workers)
        out["host%d" % workers] = HOST_LEVELS / dt
        log("host procgen %s, %s: %d levels %.3f s, %.4f levels/s  [%s]"
            % (PROCGEN_TASK, "%d forked workers (their start included)"
               % workers if workers else "one process", HOST_LEVELS, dt,
               HOST_LEVELS / dt, card))
    return out


def run_mode_cli(dev, card, name, extra):
    """The CLI at CLI_LANES lanes with ``-x extra``: train CLI_STEPS steps
    into ``runs/chip-smoke-<name>-<pid>`` with the final benchmark; the
    run must log, checkpoint and benchmark, its launches equal to
    ``predicted_launches``. Returns (the run, its calls, launches, wall
    seconds)."""
    import os

    from safelife_tpu_torch.training.checkpoints import CheckpointManager

    data_dir = os.path.join("runs", "chip-smoke-%s-%d" % (name, os.getpid()))
    argv = ["train", data_dir, "-e", TRAINER_TASK, "--batch", str(CLI_LANES),
            "--steps", str(CLI_STEPS), "--seed", "1",
            "--benchmark-episodes", str(CLI_EPISODES), "-x",
            json.dumps(extra)]
    what = "CLI train -x '%s' at %d lanes" % (json.dumps(extra), CLI_LANES)
    out, calls, launches, wall = cli_run(dev, argv, what, card)
    if out.state.num_steps < CLI_STEPS or not all(
            bool(torch.isfinite(p).all()) for p in out.model.parameters()):
        raise AssertionError("%s: %d steps" % (what, out.state.num_steps))
    ckpt = CheckpointManager(data_dir)
    if ckpt.latest_step() != out.state.num_steps:
        raise AssertionError("%s: checkpoints %s" % (what, ckpt.steps()))
    check_run_dir(data_dir, out, CLI_EPISODES)
    t_train = part_seconds(calls, "train_ppo")
    t_bench = part_seconds(calls, "benchmark")
    log("%s: %d steps; the whole command %.3f s = set-up "
        "(build_environments) %.3f s + train_ppo %.3f s + final benchmark "
        "%.3f s; %.0f training env-steps/s over train_ppo; summary %s  [%s]"
        % (what, out.state.num_steps, wall, wall - t_train - t_bench,
           t_train, t_bench, out.state.num_steps / t_train,
           json.dumps(out.summary), card))
    return out, calls, launches, wall


def run_cli_modes(dev, card):
    """The CLI in bfloat16 on uint8 channels, and with device procgen at
    64 (a start-up pool of 64 levels, one device round, and its refills
    from the device annealer, timed call by call)."""
    from safelife_tpu_torch.procgen import batched as B

    out, _, launches, wall = run_mode_cli(
        dev, card, "bf16-channels",
        {"train.precision": "bfloat16", "env.packed_obs": False})
    if out.model.precision != "bfloat16" or out.bundle.packed_obs \
            or out.model.unpack_channels is not None:
        raise AssertionError("the bfloat16 channels run built %s"
                             % type(out.model).__name__)
    bf16 = dict(launches=launches, wall=wall)

    with timed_calls(B, ["gen_games_batched"]) as rec:
        out, calls, launches, wall = run_mode_cli(
            dev, card, "device-procgen",
            {"env.device_procgen": 64, "env.pool_size": 64})
    it = out.bundle.pool_manager.iterator
    rounds = [len(r) for r in rec.get("gen_games_batched:results", [])]
    if it.device_batch != 64 or it.device.type != "cuda" or not rounds \
            or set(rounds) != {64}:
        raise AssertionError("device procgen rounds %s on %s" % (rounds,
                                                                 it.device))
    t_rounds = rec["gen_games_batched"]
    startup = wall - part_seconds(calls, "train_ppo") \
        - part_seconds(calls, "benchmark")
    check_still_levels(out.bundle.pool_manager._host_levels,
                       "the device-procgen pool")
    log("CLI device procgen 64: start-up (build_environments, a pool of %d "
        "levels) %.3f s; %d device rounds of 64 levels, %s s each, %.4f "
        "levels/s over them; the pool's levels are append-still levels  [%s]"
        % (out.bundle.pool_manager.pool.num_levels, startup, len(rounds),
           ", ".join("%.3f" % t for t in t_rounds),
           64 * len(t_rounds) / sum(t_rounds), card))
    return dict(bf16=bf16, procgen=dict(
        launches=launches, wall=wall, startup=startup,
        rate64=64 * len(t_rounds) / sum(t_rounds)))


def check_oracle(dev, card, steps=ORACLE_STEPS):
    """``advance_board_oracle`` on a 26x26 board with spawners for
    ``steps`` steps on the card and on the CPU from equal NumPy generator
    states: boards equal every step and the generators' states equal
    after; the card's time a step (host clock, synchronized)."""
    from safelife_tpu_torch.core import advance as A
    from safelife_tpu_torch.core import cells as C

    rng = np.random.default_rng(17)
    board = rng.choice([C.EMPTY, C.LIFE, C.ALIVE, C.WALL, C.TREE, C.SPAWNER],
                       size=(26, 26), p=[0.55, 0.15, 0.1, 0.08, 0.07, 0.05])
    sides = []
    for d in (dev, torch.device("cpu")):
        b = torch.from_numpy(board.astype(np.int32)).to(d)
        A.advance_board_oracle(b, np.random.default_rng(0), 0.3)  # warm-up
        gen = np.random.default_rng(18)
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            b = A.advance_board_oracle(b, gen, 0.3)
            out.append(b)
        torch.cuda.synchronize()
        sides.append(([x.cpu() for x in out], gen.bit_generator.state,
                      (time.perf_counter() - t0) / steps * 1e6))
    (cb, cs, cus), (hb, hs, hus) = sides
    if cs != hs or not all(torch.equal(x, y) for x, y in zip(cb, hb)):
        raise AssertionError("the oracle step differs card vs CPU")
    spawned = int(((cb[-1] & C.ALIVE) > 0).sum())
    log("oracle step (26x26, spawners, spawn_prob 0.3, %d steps) on the "
        "card equals the CPU path, boards every step and the PCG64 state "
        "after; %.1f us a step on the card, %.1f on the CPU; %d alive cells "
        "at the end  [%s]" % (steps, cus, hus, spawned, card))
    return cus


def run_phase_10(dev, spawn, prune, tree, card):
    """Phase 10: the precision modes, uint8 channels, device procgen, the
    CLI in those modes and the oracle step."""
    fresh_cli_state()
    t0 = time.perf_counter()
    out = {"precision": run_precision_modes(dev, spawn, tree, card)}
    out["channels_launches"] = check_channels_against_cpu(dev, prune, card)
    out["channels_ppo"] = channels_iteration(dev, spawn, tree, card)
    out["channels_dqn"] = channels_dqn_chunk(dev, spawn, card)
    out["oracle_us"] = check_oracle(dev, card)
    out["procgen"] = device_procgen_rates(dev, card)
    out["cli"] = run_cli_modes(dev, card)
    log("phase 10: %.1f s" % (time.perf_counter() - t0))
    return out


# ---------------------------------------------------------------------------
# Phase 11: multi-process training


P11_LANES = 4096          # the training cell's global batch
P11_RANKS = 2
P11_ENV_STEPS = 200
P11_DQN_UNITS = 32
SPATIAL_BOARD = (192, 192)
SPATIAL_STEPS = 100
TORCHRUN_STEPS = (10240, 20480)  # one chunk of 8 iterations at 64 lanes
TORCHRUN_POOL = 32        # the CLI's level pool (128 by default at 64 lanes)
P11_TIMEOUT = 600         # each rank process's time limit, seconds
#: Phase 11's bounds on the two ranks' learner against one process on the
#: same card and batch: the PPO parameters after the iteration's 30 Adam
#: steps within this share of the update's norm, the DQN parameters after
#: the chunk within this of one process's, element by element. Sound runs
#: (this phase and ``chip_sweep.py ranks``) read 2.1e-4 to 8.2e-4 of the
#: update and 4.1e-7 to 1.8e-6; a fault planted in the ranks (a sample
#: index shifted, the rank's own weight in the loss, a doubled DQN loss)
#: 7.9e-2 to 0.18 and 2.7e-3 to 7.4e-3. Each bound lies about 5x above the
#: sound readings.
P11_UPDATE_NORM = 4e-3
P11_DQN_MAX_ABS = 1e-5


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def lane_fingerprints(x, weights):
    """int64 [B]: each lane's elements (integers, or float32 by their bits)
    weighted by fixed pseudo-random 64-bit words and summed; equal lanes
    give equal words, and a differing element changes the word."""
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    x = x.reshape(x.shape[0], -1).to(torch.int64)
    return (x * weights[:x.shape[1]]).sum(1)


def fingerprint_weights(dev, n=1 << 16):
    g = torch.Generator().manual_seed(11)
    return torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g,
                         dtype=torch.int64).to(dev)


def p11_env(dev, levels, lanes):
    """P11_ENV_STEPS wrapped steps of append-spawn (the inaction baseline,
    packed 25x25 views) on ``lanes`` of P11_LANES (all of them for None)
    under seeded actions: each step's lane fingerprints of the boards,
    views, rewards and done flags, and the last boards."""
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels

    pool = pack_levels(levels, device=dev)
    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None)
    wcfg = W.WrapperConfig(se_baseline="inaction")
    ws, obs = W.reset(cfg, wcfg, pool, P11_LANES, device=dev, lanes=lanes)
    lo, hi = (0, P11_LANES) if lanes is None else lanes[:2]
    acts = torch.from_numpy(np.random.default_rng(3).integers(
        0, 9, (P11_ENV_STEPS, P11_LANES, pool.num_agents)).astype(
            np.int32)[:, lo:hi].copy()).to(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    w = fingerprint_weights(dev)
    prints = {k: [] for k in ("board", "obs", "reward", "done")}
    t0 = time.perf_counter()
    for t in range(P11_ENV_STEPS):
        ws, obs, reward, done, _ = W.step(cfg, wcfg, pool, ws, acts[t], gen,
                                          lanes=lanes)
        for k, x in (("board", ws.env.board), ("obs", obs),
                     ("reward", reward), ("done", done)):
            prints[k].append(lane_fingerprints(x, w))
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return ({k: torch.stack(v).cpu().numpy() for k, v in prints.items()},
            ws.env.board.cpu().numpy(), seconds)


def iteration_launches(pcfg, pool, wcfg, obs):
    """K1-K4 launches of one ``train_iteration`` on packed views ``obs``:
    K1 and K3 once a step, K2 once a step under the inaction baseline (and
    once more on goals that evolve), K4 once a forward
    (:func:`ppo_forwards`)."""
    t = pcfg.steps_per_env
    k2 = t * ((wcfg.se_baseline == "inaction")
              + (not pool.all_goals_static))
    return {"fused_actions_advance": t, "advance": k2, "recenter_views": t,
            "unpack_planes": ppo_forwards(pcfg, obs)}


def p11_ppo(dev, levels, tree, lanes):
    """A warm-up ``ppo.train_iteration`` and a timed one at P11_LANES
    global lanes (the rank's ``lanes``, or all): the loss of the first
    rollout's batch under the initial parameters, the parameters after
    both, the timed one's time, its all-reduces' and its launches."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.parallel import mesh as M
    from safelife_tpu_torch.training import ppo as P

    pool = pack_levels(levels, device=dev)
    cfg = E.EnvConfig(view_shape=VIEW, output_channels=None)
    wcfg = W.WrapperConfig(se_baseline="inaction")
    pcfg = P.PPOConfig()
    ps = P.init_ppo_state(pcfg, policy(tree, dev), device=dev)
    ws, obs = W.reset(cfg, wcfg, pool, P11_LANES, device=dev, lanes=lanes)
    gen = torch.Generator(device=dev).manual_seed(5)
    # The rollout's batch under the initial parameters, then the same
    # rollout again inside the iteration.
    state = gen.get_state()
    traj, _, final = P.rollout(cfg, wcfg, pool, ps.model, ws, obs, gen,
                               pcfg.steps_per_env, lanes=lanes)
    batch = P.flatten_batch(traj, *P.compute_gae(pcfg, traj, final))
    _, m0 = P._batch_loss(pcfg, ps.model, batch, 4096)
    loss0 = float(m0["loss"])
    del traj, batch
    gen.set_state(state)
    ps, ws, obs, _ = P.train_iteration(cfg, wcfg, pcfg, pool, ps, ws, obs,
                                       gen, device=dev, lanes=lanes)
    reduce_ms = []

    def timed_reduce(*args):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = real(*args)
        torch.cuda.synchronize(dev)
        reduce_ms.append(1e3 * (time.perf_counter() - t))
        return out

    real = M.allreduce_grads
    M.allreduce_grads = timed_reduce
    try:
        ops.reset_launch_counts()
        ms, (ps, ws, obs, m) = event_ms(lambda: P.train_iteration(
            cfg, wcfg, pcfg, pool, ps, ws, obs, gen, device=dev,
            lanes=lanes))
        launches = ops.launch_counts()
    finally:
        M.allreduce_grads = real
    check_launches("phase 11 PPO iteration", launches,
                   iteration_launches(pcfg, pool, wcfg, obs))
    return {"loss0": loss0, "loss": float(m["loss"]),
            "params": flat_params(ps.model).cpu().numpy(), "ms": ms,
            "reduce_ms": sum(reduce_ms), "reduces": len(reduce_ms),
            "launches": {k: v for k, v in launches.items() if v},
            "num_steps": ps.num_steps}


def p11_dqn(dev, levels, lanes):
    """One P11_DQN_UNITS-unit ``dqn.train_chunk`` at P11_LANES global lanes
    with ``DQNConfig()`` (the 100,000-view replay): the replay's row
    fingerprints and push count, the parameters after it, its time."""
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.training import dqn as D

    pool = pack_levels(levels, device=dev)
    env_cfg = E.EnvConfig(view_shape=VIEW, output_channels=None)
    wcfg = W.WrapperConfig(se_baseline="inaction")
    cfg = D.DQNConfig()
    local = P11_LANES if lanes is None else lanes.size
    ds = D.init_dqn_state(cfg, q_network(dev, 7), local * pool.num_agents,
                          VIEW, torch.int32, device=dev)
    ws, obs = W.reset(env_cfg, wcfg, pool, P11_LANES, device=dev,
                      lanes=lanes)
    gen = torch.Generator(device=dev).manual_seed(8)
    n_steps = max(cfg.optimize_interval // P11_LANES, 1)
    ms, (ds, ws, obs, m) = event_ms(lambda: D.train_chunk(
        env_cfg, wcfg, cfg, pool, ds, ws, obs, gen, n_steps, P11_DQN_UNITS,
        device=dev, lanes=lanes))
    w = fingerprint_weights(dev)
    prints = {k: lane_fingerprints(getattr(ds.replay, k), w).cpu().numpy()
              for k in ("obs", "action", "reward", "next_obs", "done")}
    return {"replay": prints, "idx": ds.replay.idx, "ms": ms,
            "params": flat_params(ds.model).cpu().numpy(),
            "warm": ds.replay.size() >= cfg.replay_initial}


def p11_kernels(dev, levels, lanes):
    """Device milliseconds a launch of K1 and K2 (``device_ms``, 200
    launches) on ``lanes`` of a P11_LANES reset of append-spawn, at their
    lane offset, with spawns."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.env.state import pack_levels

    pool = pack_levels(levels, device=dev)
    state, _ = E.reset(E.EnvConfig(view_shape=VIEW, output_channels=None),
                       pool, P11_LANES, lanes=lanes)
    b, h, w = state.board.shape
    flat = state.board.reshape(b, h * w).contiguous()
    sp = pool.spawn_prob.index_select(0, state.level_idx).contiguous()
    acts = torch.zeros((b, pool.num_agents), dtype=torch.int32, device=dev)
    seed = torch.tensor([5, 6], dtype=torch.int32, device=dev)
    kw = dict(h=h, w=w, stochastic=True, lane_offset=lanes.start)
    return {
        "fused_actions_advance": device_ms(
            lambda: ops.fused_actions_advance(flat, state.agent_locs, acts,
                                              sp, seed, **kw),
            KERNELS["fused_actions_advance"][2], 200),
        "advance": device_ms(lambda: ops.advance(flat, sp, seed, **kw),
                             KERNELS["advance"][2], 200),
    }


def spatial_inputs():
    rng = np.random.default_rng(6)
    board, _ = soup(rng, 1, *SPATIAL_BOARD, 0, spawners=True)
    seeds = rng.integers(-2 ** 31, 2 ** 31 - 1, (SPATIAL_STEPS, 2)).astype(
        np.int32)
    return board[0], seeds


def p11_spatial(dev, rank, world):
    """SPATIAL_STEPS stochastic steps of a SPATIAL_BOARD board with
    spawners: the rank's rows of the row-sharded advance (K2 on halo
    slabs), or the whole board's K2 steps for ``world`` None."""
    from safelife_tpu_torch import ops
    from safelife_tpu_torch.parallel import spatial as S

    board, seeds = spatial_inputs()
    seeds = torch.from_numpy(seeds).to(dev)
    h, w = board.shape
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if world is None:
        flat = torch.from_numpy(board.reshape(1, -1)).to(dev)
        prob = torch.full((1,), 0.3, device=dev)
        for seed in seeds:
            flat = ops.advance(flat, prob, seed, h=h, w=w, stochastic=True)
        out = flat.reshape(h, w)
    else:
        hl = h // world
        rows = torch.from_numpy(board[rank * hl:(rank + 1) * hl]).to(dev)
        out = S.advance_sharded_nstep(rows, seeds, 0.3)
    torch.cuda.synchronize(dev)
    return {"rows": out.cpu().numpy(), "ms": 1e3 * (time.perf_counter() - t0),
            "launches": {k: v for k, v in ops.launch_counts().items() if v}}


def p11_rank(rank, world, port, backend, device_index, tasks, tree,
             results):
    """One rank process of phase 11: joins the group, runs ``tasks`` on
    its lanes and puts its results (or its traceback) on ``results``."""
    import traceback

    from safelife_tpu_torch.io.levels import load_levels
    from safelife_tpu_torch.parallel import mesh as M

    try:
        dev = torch.device("cuda", device_index)
        torch.cuda.set_device(dev)
        M.initialize_distributed(
            backend=backend, rank=rank, world_size=world, device=dev,
            init_method="tcp://127.0.0.1:%d" % port, timeout=P11_TIMEOUT)
        lanes = M.lane_range(P11_LANES)
        levels = load_levels(TRAIN_LEVELS)
        out = {}
        for task in tasks:
            M.barrier()
            if task == "env":
                out[task] = p11_env(dev, levels, lanes)
            elif task == "ppo":
                out[task] = p11_ppo(dev, levels, tree, lanes)
            elif task == "dqn":
                out[task] = p11_dqn(dev, levels, lanes)
            elif task == "spatial":
                out[task] = p11_spatial(dev, rank, world)
            elif task == "kernels":
                out[task] = p11_kernels(dev, levels, lanes)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_p11_ranks(world, backend, devices, tasks, tree):
    """Start ``world`` rank processes (the ``spawn`` method) on
    ``devices`` and return their results in rank order; a rank that fails
    or outlives P11_TIMEOUT fails the phase, and every rank process is
    ended before this returns."""
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=p11_rank, daemon=True,
                         args=(r, world, port, backend, devices[r], tasks,
                               tree, results)) for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + P11_TIMEOUT
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise AssertionError("phase 11 ranks not done in %d s"
                                     % P11_TIMEOUT)
            try:
                rank, ok, value = results.get(timeout=min(left, 10))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise AssertionError("a phase 11 rank died: exit codes "
                                         "%s" % [p.exitcode for p in procs])
                continue
            if not ok:
                raise AssertionError("phase 11 rank %d failed:\n%s"
                                     % (rank, value))
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
                p.join(timeout=20)
    return [out[r] for r in range(world)]


def check_helpers_nccl_world_one(dev, levels, tree, card):
    """Each collective of ``parallel/mesh.py`` on CUDA tensors in an NCCL
    group of one rank, against the identity it must give there. At world
    size 1 the helpers return before they reach ``torch.distributed``, so
    the check stands the group in for ``training_group`` and the helpers'
    collective bodies run on NCCL. Returns the milliseconds of each."""
    import torch.distributed as dist

    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.parallel import mesh as M

    M.initialize_distributed(backend="nccl", rank=0, world_size=1,
                             init_method="tcp://127.0.0.1:%d" % free_port(),
                             device=dev, timeout=120)
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        ms[name] = 1e3 * (time.perf_counter() - t)
        return out

    real_group = M.training_group
    M.training_group = lambda: dist.group.WORLD
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError("the group's backend is %s"
                                 % dist.get_backend())
        net = policy(tree, dev)
        g = torch.Generator(device=dev).manual_seed(1)
        for p in net.parameters():
            p.grad = torch.randn(p.shape, generator=g, device=dev)
        before = [p.grad.clone() for p in net.parameters()]
        timed("allreduce_grads", lambda: M.allreduce_grads(net))
        timed("broadcast_grads", lambda: M.broadcast_grads(net))
        for p, b in zip(net.parameters(), before):
            if not torch.equal(p.grad, b):
                raise AssertionError("a gradient changed at world size 1")
        x = torch.randn((4, 1000), generator=g, device=dev,
                        requires_grad=True)
        got = timed("all_reduce_sum", lambda: M.all_reduce_sum(x))
        if got.requires_grad or got.data_ptr() == x.data_ptr() \
                or not torch.equal(got, x.detach()):
            raise AssertionError("all_reduce_sum is not a detached sum")
        got = timed("all_gather", lambda: M.all_gather(x.detach()))
        if len(got) != 1 or not torch.equal(got[0], x.detach()):
            raise AssertionError("all_gather changed its input")
        got = timed("all_gather_object",
                    lambda: M.all_gather_object({"slot": [1, 2]}))
        if got != [{"slot": [1, 2]}]:
            raise AssertionError("all_gather_object changed its input")
        pool = pack_levels(levels[:16], device=dev)
        got = timed("allgather_level_pool",
                    lambda: M.allgather_level_pool(pool))
        if got is pool:
            raise AssertionError("allgather_level_pool ran no gather")
        for f in ("board", "goals", "table_flat", "reset_boards",
                  "spawn_prob", "exit_locs_valid"):
            if not torch.equal(getattr(got, f), getattr(pool, f)):
                raise AssertionError("allgather_level_pool changed %s" % f)
        if (got.all_goals_static, got.spawner_free) != \
                (pool.all_goals_static, pool.spawner_free):
            raise AssertionError("allgather_level_pool changed the flags")
        ep = {"lane_done": torch.rand((20, 64), generator=g,
                                      device=dev) < 0.1,
              "episode_reward": torch.randn((20, 64, 1), generator=g,
                                            device=dev)}
        got = timed("gather_episodes", lambda: M.gather_episodes(ep, 1))
        state = g.get_state()
        timed("sync_generator", lambda: M.sync_generator(g))
        timed("barrier", M.barrier)
        if any(got[k] is ep[k] or not torch.equal(got[k], ep[k])
               for k in ep) or not torch.equal(g.get_state(), state):
            raise AssertionError("a gather or broadcast changed its input")
    finally:
        M.training_group = real_group
        dist.destroy_process_group()
    log("phase 11 NCCL at world size 1: every collective's body the "
        "identity on CUDA tensors; ms %s  [%s]" % (json.dumps(
            {k: round(v, 3) for k, v in ms.items()}), card))
    return ms


def check_two_ranks(dev, levels, tree, card):
    """Two ranks on the one card over ``gloo`` at P11_LANES global lanes,
    against the one-process run: the env, a PPO iteration, a DQN chunk and
    the row-sharded advance."""
    t0 = time.perf_counter()
    ranks = run_p11_ranks(P11_RANKS, "gloo", [dev.index or 0] * P11_RANKS,
                          ("kernels", "env", "ppo", "dqn", "spatial"), tree)
    t_ranks = time.perf_counter() - t0
    from safelife_tpu_torch.parallel.mesh import lane_range

    alone = p11_kernels(dev, levels, lane_range(P11_LANES, 0, P11_RANKS))
    log("phase 11 kernels at %d lanes a rank (lane offsets, spawns; device "
        "ms a launch over 200): both ranks at once %s, one process alone %s"
        "  [%s]"
        % (P11_LANES // P11_RANKS, json.dumps([r["kernels"] for r in ranks]),
           json.dumps(alone), card))
    env_prints, env_board, env_s = p11_env(dev, levels, None)
    for k, ref in env_prints.items():
        got = np.concatenate([r["env"][0][k] for r in ranks], axis=1)
        if not np.array_equal(got, ref):
            raise AssertionError("phase 11: %d ranks' %s differ from one "
                                 "process at step %d" % (
                                     P11_RANKS, k, int(np.argmax(
                                         (got != ref).any(1)))))
    if not np.array_equal(np.concatenate([r["env"][1] for r in ranks]),
                          env_board):
        raise AssertionError("phase 11: the last boards differ")
    log("phase 11 env: %d wrapped steps at %d lanes (append-spawn, the "
        "inaction baseline) over %d ranks on one card (gloo) equal one "
        "process bit for bit (boards, views, rewards, dones); %.3f s one "
        "process, %s s the ranks  [%s]"
        % (P11_ENV_STEPS, P11_LANES, P11_RANKS, env_s,
           [round(r["env"][2], 3) for r in ranks], card))

    one = p11_ppo(dev, levels, tree, None)
    ppo = [r["ppo"] for r in ranks]
    for r in ppo[1:]:
        if not np.array_equal(r["params"], ppo[0]["params"]):
            raise AssertionError("phase 11: the ranks' parameters differ")
    rel = abs(ppo[0]["loss0"] - one["loss0"]) / abs(one["loss0"])
    if rel > 1e-5:
        raise AssertionError("phase 11: the rollout's loss %.9g vs one "
                             "process %.9g (%.2e rel)" % (
                                 ppo[0]["loss0"], one["loss0"], rel))
    start = flat_params(policy(tree, dev)).cpu().numpy()
    update = float(np.linalg.norm(one["params"] - start))
    dev_norm = float(np.linalg.norm(ppo[0]["params"] - one["params"]))
    if not dev_norm <= P11_UPDATE_NORM * update:
        raise AssertionError("phase 11: the ranks' parameters are %.3g from "
                             "one process's, the update %.3g" % (
                                 dev_norm, update))
    if any(r["num_steps"] != one["num_steps"] for r in ppo):
        raise AssertionError("phase 11: num_steps differ")
    log("phase 11 PPO: train_iteration at %d lanes (PPOConfig(), 25x25 "
        "views) over %d ranks (gloo): the rollout's loss %.9g vs one "
        "process %.9g (%.2e rel), parameters bitwise equal on the ranks, "
        "%.3e from one process's after 30 Adam steps (the update %.3e, "
        "%.2e of it); metric loss %.6g vs %.6g; the second iteration %s ms "
        "(one process %.3f), all-reduces %s a rank, %s ms (gloo: through "
        "the host); launches a rank %s  [%s]"
        % (P11_LANES, P11_RANKS, ppo[0]["loss0"], one["loss0"], rel,
           dev_norm, update, dev_norm / max(update, 1e-30),
           ppo[0]["loss"], one["loss"], [round(r["ms"], 3) for r in ppo],
           one["ms"], ppo[0]["reduces"],
           [round(r["reduce_ms"], 3) for r in ppo],
           json.dumps(ppo[0]["launches"]), card))

    ref = p11_dqn(dev, levels, None)
    for r in ranks:
        d = r["dqn"]
        if d["idx"] != ref["idx"] or any(
                not np.array_equal(d["replay"][k], v)
                for k, v in ref["replay"].items()):
            raise AssertionError("phase 11: a rank's replay differs from "
                                 "the one-process replay")
        if not np.array_equal(d["params"], ranks[0]["dqn"]["params"]):
            raise AssertionError("phase 11: the ranks' Q parameters differ")
    dqn_abs = float(np.abs(ranks[0]["dqn"]["params"] - ref["params"]).max())
    if not dqn_abs <= P11_DQN_MAX_ABS:
        raise AssertionError("phase 11: the ranks' Q parameters are %.3g "
                             "from one process's" % dqn_abs)
    log("phase 11 DQN: a %d-unit chunk at %d lanes, DQNConfig() (replay "
        "100,000, warm %s): every rank's replay equals the one-process "
        "replay (%d pushes) row for row, Q parameters bitwise equal on the "
        "ranks (%.3e from one process's at most); chunk %s ms (one process "
        "%.3f)  [%s]"
        % (P11_DQN_UNITS, P11_LANES, ref["warm"], ref["idx"], dqn_abs,
           [round(r["dqn"]["ms"], 3) for r in ranks], ref["ms"], card))

    whole = p11_spatial(dev, 0, None)
    got = np.concatenate([r["spatial"]["rows"] for r in ranks])
    if not np.array_equal(got, whole["rows"]):
        raise AssertionError("phase 11: the row-sharded advance differs "
                             "from K2 on the whole board")
    if (whole["rows"] == spatial_inputs()[0]).all():
        raise AssertionError("phase 11: the board never changed")
    log("phase 11 spatial: %d stochastic steps of a %dx%d board with "
        "spawners over %d ranks (K2 on %dx%d halo slabs) equal %d K2 steps "
        "of the whole board bit for bit; %s ms (whole %.3f); launches a "
        "rank %s, whole %s  [%s]"
        % (SPATIAL_STEPS, SPATIAL_BOARD[0], SPATIAL_BOARD[1], P11_RANKS,
           SPATIAL_BOARD[0] // P11_RANKS + 2, SPATIAL_BOARD[1],
           SPATIAL_STEPS, [round(r["spatial"]["ms"], 3) for r in ranks],
           whole["ms"], json.dumps(ranks[0]["spatial"]["launches"]),
           json.dumps(whole["launches"]), card))
    return {"ranks_s": t_ranks, "ppo": ppo, "one": one}


def run_torchrun_cli(card):
    """The CLI under ``torchrun --nproc-per-node 1`` (NCCL at world size
    1): train TORCHRUN_STEPS[0] steps at 64 lanes on a pool of
    TORCHRUN_POOL levels, then resume to TORCHRUN_STEPS[1]; each report
    shows ``pcheck`` and the resume restores the checkpoint."""
    import os

    data_dir = "runs/chip-smoke-torchrun-%d" % os.getpid()
    out = {}
    for steps in TORCHRUN_STEPS:
        t, start = time.perf_counter(), time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "safelife_tpu_torch", "train",
             data_dir, "-e", TRAINER_TASK, "--batch", str(CLI_LANES),
             "--steps", str(steps), "--seed", "1", "--skip-benchmark",
             "-x", json.dumps({"env.pool_size": TORCHRUN_POOL})],
            capture_output=True, text=True, timeout=P11_TIMEOUT)
        seconds = time.perf_counter() - t
        text = proc.stdout + proc.stderr
        if proc.returncode:
            raise AssertionError("torchrun train to %d failed (exit %d):\n%s"
                                 % (steps, proc.returncode, text[-4000:]))
        pchecks = re.findall(r"n=(\d+):.*pcheck=(\S+)", text)
        if not pchecks or int(pchecks[-1][0]) != steps:
            raise AssertionError("torchrun train to %d: reports %s"
                                 % (steps, pchecks))
        if steps != TORCHRUN_STEPS[0] and "restored checkpoint at step %d" \
                % TORCHRUN_STEPS[0] not in text:
            raise AssertionError("torchrun resume did not restore step %d"
                                 % TORCHRUN_STEPS[0])
        if "backend nccl" not in text:
            raise AssertionError("torchrun train to %d did not run under "
                                 "NCCL:\n%s" % (steps, text[-2000:]))
        # The run's own log lines carry their times (whole seconds): from
        # its "backend nccl" line, after the group started, to its last.
        with open(os.path.join(data_dir, "training.log")) as f:
            lines = [ln for ln in f.read().splitlines()
                     if re.match(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", ln)]
        begin = max(i for i, ln in enumerate(lines) if "backend nccl" in ln)
        first, last = (time.mktime(time.strptime(ln[:19],
                                                 "%Y-%m-%d %H:%M:%S"))
                       for ln in (lines[begin], lines[-1]))
        out[steps] = {"seconds": seconds, "pcheck": pchecks[-1][1],
                      "logged": last - first, "start": first - start}
    log("phase 11 CLI: torchrun --nproc-per-node 1 (NCCL) train %s at %d "
        "lanes, a pool of %d levels: %s s (launch to the group's start %s "
        "s, from there to the last log line %s s), resume restored; "
        "pchecks %s  [%s]"
        % (list(TORCHRUN_STEPS), CLI_LANES, TORCHRUN_POOL,
           [round(v["seconds"], 3) for v in out.values()],
           [round(v["start"], 1) for v in out.values()],
           [v["logged"] for v in out.values()],
           [v["pcheck"] for v in out.values()], card))
    return out


def run_phase_11(dev, tree, card):
    """Phase 11: the multi-process helpers under NCCL at world size 1, two
    ranks on the one card over gloo against one process, the CLI through
    torchrun, and NCCL over two cards where there are two."""
    from safelife_tpu_torch.io.levels import load_levels

    t0 = time.perf_counter()
    levels = load_levels(TRAIN_LEVELS)
    out = {"helpers": check_helpers_nccl_world_one(dev, levels, tree, card)}
    out["two_ranks"] = check_two_ranks(dev, levels, tree, card)
    out["cli"] = run_torchrun_cli(card)
    n = torch.cuda.device_count()
    if n >= 2:
        ranks = run_p11_ranks(2, "nccl", [0, 1], ("ppo",), tree)
        if not np.array_equal(ranks[0]["ppo"]["params"],
                              ranks[1]["ppo"]["params"]):
            raise AssertionError("phase 11: NCCL ranks' parameters differ")
        gloo = out["two_ranks"]["ppo"]
        out["nccl_two_ranks"] = [r["ppo"]["ms"] for r in ranks]
        log("phase 11 NCCL over 2 cards: train_iteration %s ms, all-reduces "
            "%s ms (gloo on one card: %s, %s)  [%s]"
            % ([round(r["ppo"]["ms"], 3) for r in ranks],
               [round(r["ppo"]["reduce_ms"], 3) for r in ranks],
               [round(r["ms"], 3) for r in gloo],
               [round(r["reduce_ms"], 3) for r in gloo], card))
    else:
        out["nccl_two_ranks"] = "not run: %d card" % n
    log(json.dumps({"nccl_two_ranks": out["nccl_two_ranks"]}))
    out["seconds"] = time.perf_counter() - t0
    log("phase 11: %.1f s" % out["seconds"])
    return out


# ---------------------------------------------------------------------------
# Phase 12: the bench verb and train.torch_init: false

BENCH_MODES = ("packed", "channels")
#: The bench's defaults (``safelife_tpu_torch/bench.py``): lanes, steps a
#: chunk, timed chunks.
BENCH_BATCH, BENCH_SCAN, BENCH_REPS = 4096, 100, 20
BENCH_CPU_LANES = 64
BENCH_CPU_STEPS = 50
#: A time limit that resets the one-level pool's lanes inside the card vs
#: CPU window, so that the reset merge is compared too.
BENCH_CPU_TIME_LIMIT = 15
#: flax's init: each weight layer's std within this of sqrt(1 / fan_in)
#: on layers of 4096 weights or more.
INIT_STD_REL = 0.05


def bench_launches(what, launches, steps, resets=0):
    """The bench's launches: K1 and K3 once a step (K3 once more a
    reset), K2 never (append-still: static goals, no spawners), no global
    form (26x26 boards)."""
    want = {k: v for k, v in (("fused_actions_advance", steps),
                              ("recenter_views", steps + resets)) if v}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError("%s: launches %s, want %s" % (what, got, want))


def run_bench_cli(card):
    """``python -m safelife_tpu_torch bench`` at its headline (4096 lanes,
    both modes) as a user runs it: one stdout line with the four keys,
    both modes in the sidecar, each mode's launches those of its steps."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    sidecar = os.path.join(root, "runs", "chip-smoke-bench-%d.json"
                           % os.getpid())
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "safelife_tpu_torch", "bench", "--sidecar",
         sidecar], cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError("bench verb exited %d:\n%s"
                             % (out.returncode, out.stderr[-4000:]))
    lines = out.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError("bench verb printed %d stdout lines: %r"
                             % (len(lines), out.stdout[-2000:]))
    head = json.loads(lines[0])
    if sorted(head) != ["metric", "unit", "value"]:
        raise AssertionError("bench line keys %s" % sorted(head))
    with open(sidecar) as f:
        modes = json.load(f)
    if sorted(modes) != sorted(BENCH_MODES):
        raise AssertionError("bench sidecar modes %s" % sorted(modes))
    for mode, r in modes.items():
        bench_launches("bench %s (timed chunks)" % mode, r["launches"],
                       BENCH_SCAN * BENCH_REPS)
        bench_launches("bench %s (reset)" % mode, r["reset_launches"], 0, 1)
        if not r["value"] > 0 or r["steps"] != \
                BENCH_BATCH * BENCH_SCAN * BENCH_REPS:
            raise AssertionError("bench %s: %s" % (mode, r))
    if head["value"] != modes["packed"]["value"]:
        raise AssertionError("bench headline is not the packed mode")
    for mode in BENCH_MODES:
        r = modes[mode]
        log("bench (phase 12) %s: %s env-steps/s, build_s %.3f, warmup_s "
            "%.3f, timed %.3f s; launches %s, at reset %s; the verb's "
            "process %.1f s  [%s]"
            % (mode, r["value"], r["build_s"], r["warmup_s"],
               r["seconds"], json.dumps(r["launches"]),
               json.dumps(r["reset_launches"]), wall, card))
    return modes


def bench_chunk_launches(dev):
    """One chunk of the bench's loop at its headline, in this process:
    launch counts zeroed just before ``run_chunk`` and read just after."""
    from safelife_tpu_torch import bench, ops

    pool = bench.load_pool(dev)
    run = bench.setup(pool, "packed", BENCH_BATCH)
    ops.reset_launch_counts()
    rsum = bench.run_chunk(run, BENCH_SCAN)
    torch.cuda.synchronize(dev)
    launches = ops.launch_counts()
    bench_launches("bench chunk", launches, BENCH_SCAN)
    if not torch.isfinite(rsum):
        raise AssertionError("bench chunk: reward sum %s" % rsum)
    return launches


def check_bench_against_cpu(dev, card):
    """64 lanes x 50 steps of the bench's loop on the card and on the CPU
    under the same injected base actions, on a one-level pool of
    append-still (every auto-reset picks the same level on both) with lanes
    timing out every 15 steps: every step's checksum and reward sum and the
    final boards, bit for bit, in both modes."""
    from safelife_tpu_torch import bench
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.io.levels import load_levels

    level = load_levels(bench.LEVELS)[:1]
    rng = np.random.default_rng(12)
    bases = rng.integers(0, 9, (BENCH_CPU_STEPS, BENCH_CPU_LANES, 1),
                         dtype=np.int32)
    for mode in BENCH_MODES:
        out = []
        for where in (dev, torch.device("cpu")):
            feed = iter(torch.as_tensor(b, device=where) for b in bases)
            run = bench.setup(pack_levels(level, device=where), mode,
                              BENCH_CPU_LANES,
                              draw=lambda feed=feed: next(feed))
            run.cfg = dataclasses.replace(run.cfg,
                                          time_limit=BENCH_CPU_TIME_LIMIT)
            sums, checks = [], []
            for _ in range(BENCH_CPU_STEPS):
                reward, check, _ = bench.step(run)
                sums.append(reward.sum())
                checks.append(check)
            out.append((torch.stack(sums).cpu().numpy(),
                        torch.stack(checks).cpu().numpy(),
                        run.state.board.cpu().numpy(),
                        run.state.num_steps.cpu().numpy()))
        card_out, cpu_out = out
        for name, a, b in zip(("reward sums", "checksums", "boards",
                               "step counts"), card_out, cpu_out):
            if not np.array_equal(a, b):
                raise AssertionError("bench %s: %s differ card vs CPU"
                                     % (mode, name))
        if not (card_out[3].max() < BENCH_CPU_TIME_LIMIT
                and card_out[0].any()):
            raise AssertionError("bench %s: no reset or no reward in the "
                                 "window" % mode)
    log("bench (phase 12): %d lanes x %d steps, card vs CPU under the same "
        "base actions: reward sums, checksums and boards bit for bit in %s"
        "  [%s]" % (BENCH_CPU_LANES, BENCH_CPU_STEPS, "/".join(BENCH_MODES),
                    card))


def check_flax_init(dev, card):
    """Both networks built by ``train.build_model`` on the card with
    ``train.torch_init: false``: zero biases, every weight inside the cut
    at two scales, each layer of 4096 weights or more with its std within
    INIT_STD_REL of sqrt(1 / fan_in) (the truncated normal's own)."""
    import types

    from safelife_tpu_torch.env.env import EnvConfig
    from safelife_tpu_torch.models.nets import TRAINING_CHANNELS
    from safelife_tpu_torch.training import train as T
    from safelife_tpu_torch.training.global_config import config

    bundle = types.SimpleNamespace(
        env_cfg=EnvConfig(view_shape=VIEW, output_channels=None),
        packed_obs=True, obs_channels=TRAINING_CHANNELS)
    worst = {}
    for algo in ("ppo", "dqn"):
        fresh_cli_state()
        config["train.torch_init"] = False
        torch.manual_seed(0)
        model = T.build_model(bundle, algo, device=dev)[0]
        for name, p in model.named_parameters():
            if p.device != dev:
                raise AssertionError("init: %s on %s" % (name, p.device))
            w = p.detach().double()
            if name.endswith("bias"):
                if w.any():
                    raise AssertionError("init %s: %s not zero"
                                         % (algo, name))
                continue
            fan_in = w[0].numel()
            scale = fan_in ** -0.5 / 0.87962566103423978
            if w.abs().max().item() > 2 * scale * (1 + 1e-6):
                raise AssertionError("init %s: %s past the cut"
                                     % (algo, name))
            if w.numel() >= 4096:
                rel = abs(w.std().item() * fan_in ** 0.5 - 1)
                worst["%s.%s" % (algo, name)] = rel
                if rel > INIT_STD_REL:
                    raise AssertionError("init %s: %s std off by %.3f"
                                         % (algo, name, rel))
    fresh_cli_state()
    log("train.torch_init false (phase 12): both networks on the card, zero "
        "biases, weights inside 2 scales, std of sqrt(1/fan_in) within %s "
        "(largest %.4f, %s)  [%s]"
        % (INIT_STD_REL, max(worst.values()), max(worst, key=worst.get),
           card))


def run_phase_12(dev, card):
    """Phase 12: the bench verb at its headline, one bench chunk's
    launches in this process, the bench's loop card vs CPU, and flax's
    init on the card."""
    t0 = time.perf_counter()
    out = {"modes": run_bench_cli(card)}
    out["launches"] = bench_chunk_launches(dev)
    check_bench_against_cpu(dev, card)
    check_flax_init(dev, card)
    out["seconds"] = time.perf_counter() - t0
    log("phase 12: %.1f s" % out["seconds"])
    return out


KERNELS = {
    "fused_actions_advance": ("safelife_tpu_torch/ops/csrc/physics.cu",
                              "safelife_tpu/ops/physics.py:296",
                              "physics_kernel"),
    "fused_actions_advance_global": (
        "safelife_tpu_torch/ops/csrc/physics.cu",
        "safelife_tpu/ops/physics.py:296", "physics_tiled_kernel"),
    "advance": ("safelife_tpu_torch/ops/csrc/advance.cu",
                "safelife_tpu/ops/physics.py:371", "advance_kernel"),
    "advance_global": ("safelife_tpu_torch/ops/csrc/advance.cu",
                       "safelife_tpu/ops/physics.py:371",
                       "advance_tiled_kernel"),
    "recenter_views": ("safelife_tpu_torch/ops/csrc/obs.cu",
                       "safelife_tpu/ops/obs.py:146", "recenter_kernel"),
    "recenter_views_global": ("safelife_tpu_torch/ops/csrc/obs.cu",
                              "safelife_tpu/ops/obs.py:146",
                              "recenter_window_kernel"),
    "unpack_planes": ("safelife_tpu_torch/ops/csrc/unpack.cu", None,
                      "unpack_kernel"),
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
    check_offsets(dev, errs)
    check_obs(dev, errs)
    check_unpack(dev, errs)
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

    # Phase 7, after phase 6: the procgen workers fork from a process that
    # holds a CUDA context.
    trainer, startup = run_trainer_phase(dev, card)

    # Phase 8
    dqn_chunks, dqn_cli = run_dqn_phase(dev, spawn, prune, card)

    # Phase 9
    front = run_front_end_phase(dev, prune_spawn, card)

    # Timings at the main path's shapes (B = 512 and 4096) and at the
    # large-board path's.
    from safelife_tpu_torch.env.state import pack_levels

    pool = pack_levels(prune, device=dev)
    times = time_kernels(dev, pool, LANES)
    times_4096 = time_kernels(dev, pool, 4096)
    times_large = time_kernels(dev, pack_levels(large, device=dev),
                               LARGE_LANES)
    times_unpack = time_unpack(dev, net, card)
    for tt in (times, times_4096, times_large):
        for name, t in tt.items():
            log("timing %-28s B=%-4d kernel %s ms (%s; %.5f ms a call "
                "with the wrapper), plain %.5f ms, bound %.5f ms (%s; bytes "
                "%.5f, operations %.5f)  [%s]"
                % (name, t["batch"], fmt_ms(t["ms"]), t["timed_by"],
                   t["call_ms"], t["plain_ms"], t["bound_ms"], t["bound_by"],
                   t["bytes_ms"], t["ops_ms"], card))
    log("rollout at 512 lanes x 200 steps: %.0f env-steps/s  [%s]"
        % (rollout_rate(dev, pool, net, LANES), card))
    log("rollout at 4096 lanes x 200 steps: %.0f env-steps/s  [%s]"
        % (rollout_rate(dev, pool, net, 4096), card))
    profile_rollout(dev, pool, net, LANES)
    profile_rollout(dev, pool, net, 4096)

    # Phase 10, after the kernels' timing: timed after it, the kernels
    # fell back to CUDA events, the profiler having kept too few of their
    # launches (the device annealer captures CUDA graphs in phase 10).
    modes = run_phase_10(dev, spawn, prune, tree, card)

    # Phase 11
    ranked = run_phase_11(dev, tree, card)

    # Phase 12
    benched = run_phase_12(dev, card)
    log("main path per step: %s" % json.dumps(
        {k: v / (2 * STEPS) for k, v in launches.items()}))
    log("trainer (phase 7): start-up pool %s s at %s lanes; CLI run at %d "
        "lanes %.3f s, train_ppo %.3f s, %.0f training env-steps/s; "
        "launches %s  [%s]"
        % (json.dumps(startup), json.dumps(list(startup)), CLI_LANES,
           trainer["wall"], trainer["train_ppo"],
           trainer["steps"] / trainer["train_ppo"],
           json.dumps(trainer["launches"]), card))
    for c in dqn_chunks:
        log("DQN (phase 8) at %d lanes: %.0f training env-steps/s, a unit "
            "(%d env steps) %.3f ms: collect %.3f ms, optimize %.3f ms; "
            "device busy %.1f%% of a profiled unit  [%s]"
            % (c["lanes"], c["steps"] / c["wall_ms"] * 1e3, c["steps"]
               // DQN_UNITS, c["wall_ms"] / DQN_UNITS,
               c["collect"] / DQN_UNITS, c["optimize"] / DQN_UNITS,
               100 * c["busy"], card))
    log("DQN CLI (phase 8) at %d lanes: %.3f s, train_dqn %.3f s, %.0f "
        "training env-steps/s; launches %s  [%s]"
        % (CLI_LANES, dqn_cli["wall"], dqn_cli["train"],
           dqn_cli["steps"] / dqn_cli["train"],
           json.dumps(dqn_cli["launches"]), card))
    for r in front["rates"]:
        log("front end (phase 9) at %d lanes: make(...).step %.0f env-steps/s"
            ", bare env.step %.0f, ratio %.3f  [%s]"
            % (r["lanes"], r["make"], r["bare"], r["ratio"], card))
    log("front end (phase 9): play's summary %.3f s (K2 %d launches); "
        "render %.0f frames/s on the card, %.0f on the host  [%s]"
        % (front["play"]["seconds"], front["play"]["launches"]["advance"],
           front["render"]["card_fps"], front["render"]["host_fps"], card))
    for (precision, lanes), t in modes["precision"].items():
        dev_lines = "".join(
            "; %s loss rel %.3e, gradients %.3e of their norm"
            % (label, t[key]["loss"], t[key]["grad_norm"])
            for key, label in (("vs_float32", "against strict float32"),
                               ("vs_cpu", "card vs CPU")) if key in t)
        log("precision (phase 10) %s at %d lanes: train_iteration %.3f ms, "
            "rollout %.3f ms, update %.3f ms, %.0f learner samples/s%s  [%s]"
            % (precision, lanes, t["iteration"], t["rollout"], t["update"],
               t["samples_per_s"], dev_lines, card))
    ch, dq = modes["channels_ppo"], modes["channels_dqn"]
    log("packed_obs false (phase 10) at 4096 lanes: PPO iteration %.3f ms "
        "(packed %.3f), trajectory observations %d bytes (packed %d); DQN "
        "chunk %.3f ms (packed %.3f), replay observations %d bytes (packed "
        "%d)  [%s]" % (ch["ms"]["channels"], ch["ms"]["packed"],
                       ch["traj_bytes"]["channels"],
                       ch["traj_bytes"]["packed"], dq["ms"]["channels"],
                       dq["ms"]["packed"], dq["replay_bytes"]["channels"],
                       dq["replay_bytes"]["packed"], card))
    pg, cli10 = modes["procgen"], modes["cli"]
    log("device procgen (phase 10) levels/s: %s on the card, %.4f at batch "
        "64 in the CLI run; host %.4f (one process), %.4f (4 workers); CLI "
        "start-up with device_procgen 64 %.3f s; oracle step %.1f us  [%s]"
        % (", ".join("%.4f at batch %d" % (pg[n], n)
                     for n in PROCGEN_BATCHES), cli10["procgen"]["rate64"],
           pg["host0"], pg["host4"], cli10["procgen"]["startup"],
           modes["oracle_us"], card))
    log("phase 11 (multi-process) %.1f s; NCCL over two cards: %s  [%s]"
        % (ranked["seconds"], ranked["nccl_two_ranks"], card))
    log("bench (phase 12): %s  [%s]" % ("; ".join(
        "%s %s env-steps/s, build_s %.3f, warmup_s %.3f"
        % (m, r["value"], r["build_s"], r["warmup_s"])
        for m, r in benched["modes"].items()), card))
    log("elapsed %.1f s" % (time.perf_counter() - t_start))

    kernels = []
    timed = {**times_large, **times,
             "unpack_planes": times_unpack[UNPACK_TIMED[-1]]}
    for name, (source, replaces, _) in KERNELS.items():
        t = timed[name]
        # Each form's launches on the path that runs it.
        path = large_launches if name in LARGE_PATH_FORMS else launches
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path[name],
            "launches_bench": benched["launches"][name],
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
