"""The kernels over their block layouts, and the host cost of a kernel
call, on one CUDA card.

    python3 chip_sweep.py [physics] [views] [host] [large] [learner]
                          [learner-4096] [procgen] [ranks] [ranks-time]
                          [convs] [bench] [parent=DIR]

from the root of a checkout, on a host with a CUDA card and ``nvcc`` (no
part named runs all eleven; ``parent=DIR``, a checkout of another commit,
e.g. the one before, ``git archive``'d under ``runs/``, adds its K3 to
``large``). It imports torch and the port only, prints
the compiler's registers and spills of each kernel, and then, for 26x26
prune-dynamic boards:

* At B = 512 and 4096, the profiler's device time per launch of both
  kernels for every boards-per-block count in {1, 2, 4, 6, 8} and
  rows-per-thread count in {26, 13, 9, 7, 5, 4} that fits in 1024 threads,
  beside the layout ``ops.physics.launch_shape`` picks. Each layout runs
  through the wrappers (``ops.physics.launch_shape`` is swapped for the
  layout, threads from ``ops.physics.block_threads``) and is checked
  against the plain version bit for bit.
* ``views``: at B = 512 and 4096, the profiler's device time per launch of
  K3 (one agent, one exit, 25x25 views) for every lanes-per-block count of
  ``ops.obs.LANES_PER_BLOCK`` and 4, 8 or 16 elements a thread, through the
  wrapper (``ops.obs.view_launch_shape`` swapped for the layout), each
  checked against the plain version bit for bit, beside the layout the
  wrapper picks; and the time of a device-to-device ``Tensor.copy_`` that
  moves as many bytes as K3 must (half read, half written), the
  achievable-bandwidth yardstick (not a port of the function). Then K3's
  windowed form (boards above ``MAX_CELLS``, lanes too large to stage) at
  64 and 4096 lanes of
  192x192 for every views-a-block count of ``ops.obs.VIEWS_PER_BLOCK`` and
  128 to 1024 threads (``ops.obs.window_launch_shape`` swapped), each
  checked bit for bit, beside the pick; and the windowed form against the
  staged one (one lane a block) on the stageable boards of
  ``chip_smoke.LARGE_SHAPES`` and 96x128 at B in {1, 7, 64, 512}.
* At B = 512, the host time of one wrapper call and of the parts of the
  launch path, in microseconds a call over 2000 calls.
* ``large``: the tiled K1 and K2 (boards above ``MAX_CELLS``) over tile
  layouts (columns a tile x rows a thread x walkers a column, within 1024
  threads and the card's shared memory) at 192x192 with B in {1, 7, 64},
  on the row-sharded advance's 98x192 slab and on 6x2100 at B = 1, each
  through the wrappers (``ops.physics.tile_shape`` swapped for the
  layout) and checked bit for bit, beside the layout ``tile_shape``
  picks; the pick on every ``chip_smoke.LARGE_SHAPES`` board and the
  98x192 slab at B = 1 and 7; then the card's launch floor on the
  profiler's clock (the fill kernel of a one-element ``torch.zeros``);
  K3's windowed form at 64 and 4096 lanes of 192x192 beside its bound and,
  with ``parent=DIR``, that checkout's K3 on the same inputs (each bit for
  bit against the plain version); then every kernel
  (``time_kernels``) on prune-dynamic at 16, 64, 512 and 2048 lanes and
  on 192x192 at 64, each beside its bound and the launch floor.
* ``learner``: the spread of ``chip_smoke.py``'s learner check (the PPO
  update on the card against the CPU path) over 48 batches of a 64-lane
  append-spawn training run, once in strict float32 and once with TF32
  allowed for cuBLAS and cuDNN: the loss and gradient differences of the
  first minibatch, whole and over the samples whose ReLUs and clips take
  the same branch on both devices, the samples excluded, the parameters
  after the update, and the bounds each reading misses.
  ``learner-4096``: the first minibatch's readings over 20 batches of a
  4096-lane run (minibatches of 16,384 samples, where cuDNN takes other
  convolution engines), the CPU side computed once a batch.
* ``procgen``: the device annealer's lockstep iteration
  (``procgen/anneal_device.py``) at 8, 64 and 256 chains on 26x26 boards
  whose chains never converge: milliseconds an iteration run eagerly and
  replayed as the CUDA graph ``_Chains.run`` captures, and the capture's
  seconds.
* ``ranks``: what ``chip_smoke.py``'s phase 11 bounds (``P11_UPDATE_NORM``,
  ``P11_DQN_MAX_ABS``): two ``gloo`` ranks on the card against one
  process, the PPO iteration's parameters (a share of the update's norm)
  and the DQN chunk's (max abs), twice as they are and once each with a
  fault planted in the rank processes at run time: PPO's sample index
  shifted one lane, the rank's own weight in the sharded loss in place of
  the global one, DQN's sample index off by one, DQN's loss doubled.
* ``ranks-time``: two ``gloo`` ranks on the card, each running
  ``RANK_ITERATIONS`` PPO iterations of ``cs.P11_LANES`` global lanes after
  a warm-up one: each iteration's ms and ``models/nets.py::conv_searches``
  after it (None where the checkout has no such counter); then
  ``cs.P11_DQN_UNITS`` DQN units, each replay push's ms.
* ``convs``: each convolution of the policy trunk (25x25 views, 15
  channels) at each of ``CONV_SAMPLES``, in strict float32: its forward,
  input gradient and weight gradient (``aten.convolution_backward`` with
  the one output asked), under cuDNN's heuristic pick and under its
  measured search, each pick in a process of its own (``convs=heuristic``,
  ``convs=measured``, the latter twice, as the search's picks at small
  widths change from one process to the next): cuDNN keeps the first plan
  a process runs at a shape, whichever way it was chosen. A line each:
  the device kernels of a call on the profiler's clock, their ms, the
  share of 67 TFLOP/s float32 and the first call's host seconds (the
  search, where it ran).
* ``bench``: ``python -m safelife_tpu_torch bench`` three times at its
  headline (4096 lanes, packed and channels views), each run its own
  process with its launches checked as ``chip_smoke.py``'s phase 12 does,
  then one 100-step chunk of each mode under the profiler: wall and device
  busy time a step, and the top device operations.
"""

import contextlib
import json
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from safelife_tpu_torch.env.state import pack_levels
from safelife_tpu_torch.io.levels import load_levels
from safelife_tpu_torch.env import env as E
from safelife_tpu_torch.ops import _build, obs as O, physics as P

BOARDS_PER_BLOCK = (1, 2, 4, 6, 8)
ROWS_PER_THREAD = (26, 13, 9, 7, 5, 4)
ELEMENTS_PER_THREAD = (4, 8, 16)


@contextlib.contextmanager
def layout(bpb, rows):
    """Launch K1 and K2 with ``bpb`` boards a block and ``rows`` rows a
    thread while the context is open."""
    picked = P.launch_shape

    def forced(h, w, batch):
        return (bpb, rows, P.block_threads(h, w, bpb, rows),
                bpb * h * w * P.SMEM_BYTES_PER_CELL)

    P.launch_shape = forced
    try:
        yield
    finally:
        P.launch_shape = picked


def inputs(dev, pool, b):
    h, w = pool.board_shape
    idx = torch.arange(b, device=dev) % pool.num_levels
    flat = pool.board.index_select(0, idx).reshape(b, h * w).contiguous()
    locs = pool.agent_locs.index_select(0, idx).contiguous()
    acts = torch.randint(0, 9, (b, pool.num_agents), device=dev,
                         dtype=torch.int32)
    sp = torch.zeros(b, device=dev)
    seed = torch.zeros(2, dtype=torch.int32, device=dev)
    return flat, locs, acts, sp, seed


def sweep(dev, pool, card):
    h, w = pool.board_shape
    k = dict(h=h, w=w, stochastic=False)
    for b in (cs.LANES, 4096):
        flat, locs, acts, sp, seed = inputs(dev, pool, b)
        ref1 = P.fused_actions_advance_plain(flat, locs, acts, sp, seed, **k)
        ref2 = P.advance_plain(flat, sp, seed, **k)
        print("B=%d: launch_shape picks %d boards a block, %d rows a "
              "thread, %d threads  [%s]"
              % ((b,) + P.launch_shape(h, w, b)[:3] + (card,)), flush=True)
        for bpb in BOARDS_PER_BLOCK:
            for rows in ROWS_PER_THREAD:
                if bpb * w * -(-h // rows) > 1024:
                    continue
                with layout(bpb, rows):
                    t2 = cs.device_ms(
                        lambda: P.advance(flat, sp, seed, **k),
                        "advance_kernel")[0]
                    t1 = cs.device_ms(
                        lambda: P.fused_actions_advance(flat, locs, acts, sp,
                                                        seed, **k),
                        "physics_kernel")[0]
                    got1 = P.fused_actions_advance(flat, locs, acts, sp,
                                                   seed, **k)
                    got2 = P.advance(flat, sp, seed, **k)
                cs.max_err(list(zip(got1, ref1)) + [(got2, ref2)])
                print("B=%d boards/block=%d rows/thread=%d threads=%d: "
                      "K2 %.5f ms, K1 %.5f ms, exact"
                      % (b, bpb, rows, P.block_threads(h, w, bpb, rows), t2,
                         t1), flush=True)


@contextlib.contextmanager
def view_layout(lanes, per_thread):
    """Launch K3 with ``lanes`` lanes a block and a thread for each
    ``per_thread`` elements while the context is open."""
    picked = O.view_launch_shape

    def forced(batch, a, h, w, vh, vw):
        return (lanes, O.view_block_threads(lanes, a, h, w, vh, vw,
                                            per_thread),
                O.view_smem_bytes(lanes, a, h, w, vh, vw))

    O.view_launch_shape = forced
    try:
        yield
    finally:
        O.view_launch_shape = picked


def sweep_views(dev, pool, card):
    h, w = pool.board_shape
    cfg = E.EnvConfig(view_shape=cs.VIEW, output_channels=None)
    vh, vw = cs.VIEW
    for b in (cs.LANES, 4096):
        idx = torch.arange(b, device=dev) % pool.num_levels
        state = E.reset_batch(cfg, pool, idx)
        locs = state.agent_locs
        args = (state.board, state.goals, locs[..., 0].contiguous(),
                locs[..., 1].contiguous(),
                pool.exit_locs.index_select(0, idx),
                pool.exit_locs_valid.index_select(0, idx))
        a = locs.shape[1]
        ref = O.recenter_views_plain(*args, view_shape=cs.VIEW)
        print("B=%d: view_launch_shape picks %d lanes a block, %d threads, "
              "%d B shared  [%s]" % ((b,) + O.view_launch_shape(
                  b, a, h, w, vh, vw) + (card,)), flush=True)
        for lanes in O.LANES_PER_BLOCK:
            for per in ELEMENTS_PER_THREAD:
                with view_layout(lanes, per):
                    t = cs.device_ms(
                        lambda: O.recenter_views(*args, view_shape=cs.VIEW),
                        "recenter_kernel")[0]
                    got = O.recenter_views(*args, view_shape=cs.VIEW)
                cs.max_err([(got, ref)])
                print("B=%d lanes/block=%d elements/thread=%d threads=%d: "
                      "K3 %.5f ms, exact" % (
                          b, lanes, per, O.view_block_threads(
                              lanes, a, h, w, vh, vw, per), t), flush=True)
        nbytes = cs.view_work(h, w, *args[2:], cs.VIEW)[0]
        src = torch.zeros(nbytes // 8, dtype=torch.int32, device=dev)
        dst = torch.empty_like(src)
        t, how = cs.device_ms(lambda: dst.copy_(src), "Memcpy")
        print("B=%d: yardstick, device-to-device copy_ of %d bytes (moves "
              "%d, K3's count): %.5f ms (%s), %.1f GB/s  [%s]"
              % (b, 4 * src.numel(), 8 * src.numel(), t, how,
                 8 * src.numel() / t / 1e6, card), flush=True)


#: Threads a block of the windowed K3 the sweep tries.
WINDOW_THREADS = (128, 256, 512, 1024)


@contextlib.contextmanager
def window_layout(views=None, threads=None):
    """Launch K3's windowed form with ``views`` views a block and
    ``threads`` threads (None: ``window_launch_shape``'s) while the context
    is open, on every shape: lanes that could be staged too."""
    staged, picked = O.view_launch_shape, O.window_launch_shape

    def forced(batch, a, e, vh, vw):
        v, t, _ = picked(batch, a, e, vh, vw)
        v, t = views or v, threads or t
        return v, t, O.window_smem_bytes(v, e, vh, vw)

    O.view_launch_shape = lambda *args: (0, O.WINDOW_THREADS, 0)
    O.window_launch_shape = forced
    try:
        yield
    finally:
        O.view_launch_shape, O.window_launch_shape = staged, picked


def view_inputs(dev, pool, b):
    """K3's arguments at ``b`` lanes of ``pool``'s reset (one agent, the
    levels' exits)."""
    cfg = E.EnvConfig(view_shape=cs.VIEW, output_channels=None)
    idx = torch.arange(b, device=dev) % pool.num_levels
    state = E.reset_batch(cfg, pool, idx)
    locs = state.agent_locs
    return (state.board, state.goals, locs[..., 0].contiguous(),
            locs[..., 1].contiguous(), pool.exit_locs.index_select(0, idx),
            pool.exit_locs_valid.index_select(0, idx))


def sweep_window(dev, card):
    """K3's windowed form over views a block x threads at 64 and 4096 lanes
    of 192x192 (``cs.large_levels``), each layout checked bit for bit,
    beside ``window_launch_shape``'s pick; then the windowed form against
    the staged one (one lane a block) on the stageable boards of
    ``cs.LARGE_SHAPES`` and 96x128, at B in {1, 7, 64, 512}."""
    import numpy as np

    vh, vw = cs.VIEW
    pool = pack_levels(cs.large_levels(), device=dev)
    for b in (cs.LARGE_LANES, 4096):
        args = view_inputs(dev, pool, b)
        a, e = args[2].shape[1], args[4].shape[1]
        ref = O.recenter_views_plain(*args, view_shape=cs.VIEW)
        bound_ms = cs.bound(*cs.view_work(*pool.board_shape, *args[2:],
                                          cs.VIEW))[0]
        print("192x192 B=%d: window_launch_shape picks %s; bound %.5f ms  "
              "[%s]" % (b, O.window_launch_shape(b, a, e, vh, vw), bound_ms,
                        card), flush=True)
        for views in O.VIEWS_PER_BLOCK:
            for threads in WINDOW_THREADS:
                with window_layout(views, threads):
                    ms, how = cs.device_ms(
                        lambda: O.recenter_views(*args, view_shape=cs.VIEW),
                        "recenter_window_kernel")
                    got = O.recenter_views(*args, view_shape=cs.VIEW)
                cs.max_err([(got, ref)])
                print("192x192 B=%d views/block=%d threads=%d: K3 %s ms "
                      "(%s), exact" % (b, views, threads, cs.fmt_ms(ms), how),
                      flush=True)
    rng = np.random.default_rng(9)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    for (h, w), b in [(shape, b) for shape in cs.LARGE_SHAPES + ((96, 128),)
                      for b in (1, 7, 64, cs.LANES)]:
        words = rng.integers(0, 2 ** 16, (2, b, h, w)).astype(np.int32)
        args = (t(words[0]), t(words[1]), t(cs.edge_centres(rng, b, 1, h)),
                t(cs.edge_centres(rng, b, 1, w)),
                t(np.stack([rng.integers(0, h, (b, 1)),
                            rng.integers(0, w, (b, 1))], -1).astype(np.int32)),
                t(np.ones((b, 1), bool)))
        ref = O.recenter_views_plain(*args, view_shape=cs.VIEW)
        with view_layout(1, O.ELEMENTS_PER_THREAD):
            got = O.recenter_views(*args, view_shape=cs.VIEW)
            staged = cs.device_ms(
                lambda: O.recenter_views(*args, view_shape=cs.VIEW),
                "recenter_kernel")[0]
        with window_layout():
            windowed = cs.device_ms(
                lambda: O.recenter_views(*args, view_shape=cs.VIEW),
                "recenter_window_kernel")[0]
            cs.max_err([(got, ref), (O.recenter_views(
                *args, view_shape=cs.VIEW), ref)])
        print("%dx%d B=%d: staged, one lane a block, %s ms; windowed %s "
              "ms; view_launch_shape picks %s; exact  [%s]"
              % (h, w, b, cs.fmt_ms(staged), cs.fmt_ms(windowed),
                 O.view_launch_shape(b, 1, h, w, vh, vw), card), flush=True)


def host_cost(dev, pool, n=2000):
    """Host time of one kernel call through its wrapper at B = 512, and of
    the parts of the launch path, in microseconds a call over n calls on
    the host clock (the launches queue on the card, which keeps up)."""
    b = cs.LANES
    h, w = pool.board_shape
    flat, locs, acts, sp, seed = inputs(dev, pool, b)
    acts.zero_()
    k = dict(h=h, w=w, stochastic=False)

    def context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "fused_actions_advance call": lambda: P.fused_actions_advance(
            flat, locs, acts, sp, seed, **k),
        "advance call": lambda: P.advance(flat, sp, seed, **k),
        "torch.cuda.device(dev) enter+exit": context,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "one _require": lambda: P._require("board", flat, torch.int32,
                                           (b, h * w), dev),
        "one torch.empty_like": lambda: torch.empty_like(flat),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return out


def learner_spread(dev, card, lanes, n_batches, update):
    """``chip_smoke.py``'s learner check on successive batches of one
    training run of ``lanes`` lanes, from the parameters that collected
    each batch, in strict float32 and in TF32 on the card against the
    CPU: each reading whole and over the samples whose branches agree
    (``cs.card_diffs``), with the bounds it misses; with ``update`` also
    the 15 Adam steps (``cs.learner_diffs``), else the CPU side computed
    once for both modes. Ends with each mode's spread."""
    import numpy as np

    from safelife_tpu_torch.models.nets import TRAINING_CHANNELS
    from safelife_tpu_torch.training import ppo

    tree = cs.random_policy_tree(np.random.default_rng(0),
                                 len(TRAINING_CHANNELS), cs.VIEW)
    run = cs.training_setup(dev, load_levels(cs.TRAIN_LEVELS), tree, lanes,
                            seed=10)
    cfg = ppo.PPOConfig()
    cpu = torch.device("cpu")
    modes = (("strict float32", "float32"), ("TF32", "tensorfloat32"))
    spread = {mode: [] for mode, _ in modes}
    for i in range(n_batches):
        state = cs.model_state(run)
        batch = cs.rollout_batch(run)
        _, first = cs.first_indices(cfg, batch["obs"].shape[0], 12 + i)
        ref = None
        for mode, precision in modes:
            if update:
                r = cs.learner_diffs(dev, tree, state, batch, seed=12 + i,
                                     precision=precision)
                line = cs.learner_line(r)
            else:
                if ref is None:  # the CPU side, equal in both modes
                    ref = cs.learner_side(
                        cfg, cs.trained_policy(tree, state, cpu), batch,
                        first)
                r, _ = cs.card_diffs(
                    cfg, cs.trained_policy(tree, state, dev, precision),
                    batch, first, ref)
                line = "%s; TF32 allowed in %d of %d layer runs" % (
                    cs.exclusion_line(r), r["tf32_layer_runs"],
                    r["layer_runs"])
            missed = cs.learner_misses(r)
            spread[mode].append((r, missed))
            print("learner at %d lanes, batch %d, %s: %s; %s  [%s]"
                  % (lanes, i, mode, line,
                     "misses " + ", ".join(missed) if missed else "passes",
                     card), flush=True)
        ppo.train_on_batch(run["pcfg"], run["ps"], batch, run["gen"])
    for mode, rs in spread.items():
        shares = [r["excluded"] / r["minibatch"] for r, _ in rs]
        agree = [r["agree_grad_norm"] for r, _ in rs]
        whole = [r["grad_norm"] for r, _ in rs]
        print("learner at %d lanes, %s, %d batches: %d pass the check; "
              "excluded share %.3e-%.3e, gradients over agreeing samples "
              "%.3e-%.3e, over the whole minibatch %.3e-%.3e  [%s]"
              % (lanes, mode, len(rs), sum(not m for _, m in rs),
                 min(shares), max(shares), np.nanmin(agree),
                 np.nanmax(agree), min(whole), max(whole), card), flush=True)


#: Batches of the 4096-lane learner spread.
LEARNER_4096_BATCHES = 20

#: The tiled K1/K2 sweep: columns a tile, rows a thread, walkers a column.
TILE_COLS = (32, 64, 96, 128, 192)
TILE_ROWS_PER_THREAD = (4, 8, 12, 16)
TILE_WALKERS = (1, 2, 3, 4, 8)
#: (board, batch) cells of the sweep: the large-board path's, the
#: row-sharded advance's slab, and a board cut into columns of tiles.
TILE_CASES = (((192, 192), 1), ((192, 192), 7), ((192, 192), 64),
              ((98, 192), 1), ((6, 2100), 1))


@contextlib.contextmanager
def tile_layout(cols, rows, walkers):
    """Launch the tiled K1 and K2 with tiles of ``cols`` columns and
    ``rows`` x ``walkers`` rows (each cut to the board), ``rows`` rows a
    thread, while the context is open."""
    picked = P.tile_shape

    def forced(h, w, batch):
        tr, tc = min(h, rows * walkers), min(w, cols)
        return (tr, tc, rows, -(-tc // 32) * 32 * -(-tr // rows),
                P.tile_smem_bytes(tr, tc))

    P.tile_shape = forced
    try:
        yield forced
    finally:
        P.tile_shape = picked


def large_tiles(dev, card, parent=None):
    """The tiled K1 and K2 over tile layouts (``TILE_*``) on ``TILE_CASES``
    soups (one agent a board), each layout through the wrappers and
    checked against the plain versions bit for bit, the profiler's device
    time a launch beside ``ops.physics.tile_shape``'s pick; then the
    card's launch floor on the same clock (a one-element ``torch.zeros``,
    one fill kernel), K3 at 192x192 (``windowed_views``, with another
    commit's K3 where ``parent`` names its checkout) and every kernel at
    ``TRAINING_WIDTHS`` (``cs.time_kernels``)."""
    import numpy as np

    rng = np.random.default_rng(4)
    seed = torch.tensor([11, -12], dtype=torch.int32, device=dev)
    for (h, w), b in TILE_CASES:
        board, locs = cs.soup(rng, b, h, w, 1, spawners=True)
        flat = torch.from_numpy(board.reshape(b, h * w)).to(dev)
        locs = torch.from_numpy(locs).to(dev)
        acts = torch.randint(0, 9, (b, 1), dtype=torch.int32, device=dev)
        sp = torch.zeros(b, device=dev)
        k = dict(h=h, w=w, stochastic=False)
        ref1 = P.fused_actions_advance_plain(flat, locs, acts, sp, seed, **k)
        ref2 = P.advance_plain(flat, sp, seed, **k)
        print("%dx%d B=%d: tile_shape picks %s  [%s]"
              % (h, w, b, P.tile_shape(h, w, b), card), flush=True)
        seen = {}
        for cols in TILE_COLS:
            for rows in TILE_ROWS_PER_THREAD:
                for walkers in TILE_WALKERS:
                    with tile_layout(cols, rows, walkers) as shape:
                        layout = shape(h, w, b)
                        if layout in seen or layout[3] > 1024 \
                                or layout[4] > P.MAX_SMEM_BYTES - 1024:
                            continue
                        t1 = cs.device_ms(
                            lambda: P.fused_actions_advance(
                                flat, locs, acts, sp, seed, **k),
                            "physics_tiled_kernel")[0]
                        t2 = cs.device_ms(
                            lambda: P.advance(flat, sp, seed, **k),
                            "advance_tiled_kernel")[0]
                        got1 = P.fused_actions_advance(flat, locs, acts, sp,
                                                       seed, **k)
                        got2 = P.advance(flat, sp, seed, **k)
                    cs.max_err(list(zip(got1, ref1)) + [(got2, ref2)])
                    seen[layout] = (t1, t2)
                    print("%dx%d B=%d tile %dx%d, %d rows a thread, %d "
                          "threads, %d B shared: K1 %.5f ms, K2 %.5f ms, "
                          "exact" % ((h, w, b) + layout[:2] + layout[2:]
                                     + (t1, t2)), flush=True)
        for i, name in ((0, "K1"), (1, "K2")):
            best = min(seen, key=lambda lay: seen[lay][i])
            print("%dx%d B=%d: fastest %s layout %s, %.5f ms  [%s]"
                  % (h, w, b, name, best, seen[best][i], card), flush=True)
        print("%dx%d B=%d: the pick %s: K1 %.5f ms, K2 %.5f ms  [%s]"
              % (h, w, b, P.tile_shape(h, w, b), cs.device_ms(
                  lambda: P.fused_actions_advance(flat, locs, acts, sp, seed,
                                                  **k),
                  "physics_tiled_kernel")[0], cs.device_ms(
                  lambda: P.advance(flat, sp, seed, **k),
                  "advance_tiled_kernel")[0], card), flush=True)
    for (h, w), b in [(shape, b) for shape in cs.LARGE_SHAPES + ((98, 192),)
                      for b in (1, 7)]:
        board, locs = cs.soup(rng, b, h, w, 1, spawners=True)
        flat = torch.from_numpy(board.reshape(b, h * w)).to(dev)
        locs = torch.from_numpy(locs).to(dev)
        acts = torch.randint(0, 9, (b, 1), dtype=torch.int32, device=dev)
        sp = torch.zeros(b, device=dev)
        k = dict(h=h, w=w, stochastic=False)
        t1 = cs.device_ms(lambda: P.fused_actions_advance(
            flat, locs, acts, sp, seed, **k), "physics_tiled_kernel")[0]
        t2 = cs.device_ms(lambda: P.advance(flat, sp, seed, **k),
                          "advance_tiled_kernel")[0]
        cs.max_err(list(zip(
            P.fused_actions_advance(flat, locs, acts, sp, seed, **k),
            P.fused_actions_advance_plain(flat, locs, acts, sp, seed, **k)))
            + [(P.advance(flat, sp, seed, **k),
                P.advance_plain(flat, sp, seed, **k))])
        print("%dx%d B=%d, tile_shape's pick %s: K1 %.5f ms, K2 %.5f ms, "
              "exact  [%s]" % (h, w, b, P.tile_shape(h, w, b), t1, t2, card),
              flush=True)
    floor, how = cs.device_ms(lambda: torch.zeros(1, device=dev),
                              "FillFunctor")
    print("launch floor: one-element torch.zeros, %s ms a fill kernel "
          "(%s)  [%s]" % (cs.fmt_ms(floor), how, card), flush=True)
    windowed_views(dev, card, floor, parent)
    prune = pack_levels(load_levels("benchmarks/v1.0/prune-dynamic.npz"),
                        device=dev)
    for pool, b in [(prune, b) for b in TRAINING_WIDTHS] + [
            (pack_levels(cs.large_levels(), device=dev), cs.LARGE_LANES)]:
        for name, t in cs.time_kernels(dev, pool, b).items():
            print("%-28s B=%-4d %s ms (%s), bound %.5f ms (%s), %s of the "
                  "launch floor  [%s]"
                  % (name, b, cs.fmt_ms(t["ms"]), t["timed_by"],
                     t["bound_ms"], t["bound_by"], ratio(t["ms"], floor),
                     card), flush=True)


#: Lanes of prune-dynamic at which ``large`` times every kernel: the
#: parity trainer's 16, the CLI's default 64, the main path's 512 and a
#: rank's half of 4096.
TRAINING_WIDTHS = (16, 64, cs.LANES, 2048)


def ratio(ms, floor):
    return "not timed" if ms is None or floor is None else "%.2f" % (
        ms / floor)


def parent_views(parent):
    """The K3 wrapper of the port in the checkout ``parent`` (another
    commit, e.g. the one before this), imported as a package of its own;
    it builds its kernels in its own tree. None without a checkout."""
    import importlib
    import importlib.util
    import os

    if parent is None:
        return None
    root = os.path.join(parent, "safelife_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_port", os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    sys.modules["parent_port"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["parent_port"])
    return importlib.import_module("parent_port.ops.obs").recenter_views


def windowed_views(dev, card, floor, parent=None):
    """K3's windowed form at 64 and 4096 lanes of 192x192
    (``cs.large_levels``: one agent, one exit, 25x25 views) beside its
    bound and, with ``parent`` (a checkout of another commit), that
    commit's K3 on the same inputs (its kernels named ``recenter*`` on the
    profiler's clock), each held against the plain version bit for
    bit."""
    old = parent_views(parent)
    pool = pack_levels(cs.large_levels(), device=dev)
    h, w = pool.board_shape
    for b in (cs.LARGE_LANES, 4096):
        args = view_inputs(dev, pool, b)
        ref = O.recenter_views_plain(*args, view_shape=cs.VIEW)
        bound_ms, by, _, ops_ms = cs.bound(*cs.view_work(h, w, *args[2:],
                                                         cs.VIEW))
        forms = {"windowed (recenter_window_kernel)": (
            lambda: O.recenter_views(*args, view_shape=cs.VIEW),
            "recenter_window_kernel")}
        if old is not None:
            forms["of %s" % parent] = (
                lambda: old(*args, view_shape=cs.VIEW), "recenter")
        for name, (fn, kernel) in forms.items():
            cs.max_err([(fn(), ref)])
            ms, how = cs.device_ms(fn, kernel)
            print("K3 %s 192x192 B=%d: %s ms (%s), bound %.5f ms (%s; "
                  "operations %.5f), %s of bound, %s of the launch floor, "
                  "exact  [%s]"
                  % (name, b, cs.fmt_ms(ms), how, bound_ms, by, ops_ms,
                     "not timed" if ms is None else "%.1f%%" % (
                         100 * bound_ms / ms), ratio(ms, floor), card),
                  flush=True)


def plant_fault(fault):
    """Patch ``fault`` into this process's training modules (a rank
    process's, never the one-process reference's)."""
    from safelife_tpu_torch.parallel import mesh as M
    from safelife_tpu_torch.training import dqn as D, ppo as PPO

    if fault == "ppo_index":
        real_shard = PPO.sample_shard

        def shifted(steps, agents, lanes, device):
            s = real_shard(steps, agents, lanes, device)
            return PPO.SampleShard((s.index + agents) % s.total, s.total)
        PPO.sample_shard = shifted
    elif fault == "ppo_local_wsum":
        def local_wsum(cfg, model, obs, actions, old_policy, old_values,
                       returns, advantages, w):
            terms = PPO._loss_terms(cfg, model, obs, actions, old_policy,
                                    old_values, returns, advantages)
            sums = torch.stack([torch.sum(x * w) for x in terms])
            tot = M.all_reduce_sum(torch.cat([sums.detach(),
                                              w.sum().reshape(1)]))
            return PPO._combine(cfg, *(
                tot[:3] / torch.clamp(tot[3], min=1.0)
                + (sums - sums.detach()) / torch.clamp(w.sum(), min=1.0)))
        PPO.calculate_loss = local_wsum
    elif fault == "dqn_index":
        real_opt = D.optimize

        def off_by_one(cfg, dstate, generator, n_env_steps, sample_idx=None):
            size = max(dstate.replay.size(), 1)
            idx = torch.randint(0, size, (cfg.batch_size,),
                                generator=generator,
                                device=dstate.replay.obs.device)
            return real_opt(cfg, dstate, generator, n_env_steps,
                            (idx + 1) % size)
        D.optimize = off_by_one
    elif fault == "dqn_scale":
        real_loss = D.td_loss

        def doubled(*args):
            loss, metrics = real_loss(*args)
            return 2 * loss, metrics
        D.td_loss = doubled


def fault_rank(fault, *args):
    plant_fault(fault)
    return cs.p11_rank(*args)


def rank_readings(dev, card):
    """Two ``gloo`` ranks' learner against one process (``cs.p11_ppo``,
    ``cs.p11_dqn`` at ``cs.P11_LANES``), sound and with planted faults."""
    import functools

    import numpy as np

    from safelife_tpu_torch.models.nets import TRAINING_CHANNELS

    tree = cs.random_policy_tree(np.random.default_rng(0),
                                 len(TRAINING_CHANNELS), cs.VIEW)
    levels = load_levels(cs.TRAIN_LEVELS)
    one = cs.p11_ppo(dev, levels, tree, None)
    ref = cs.p11_dqn(dev, levels, None)
    start = cs.flat_params(cs.policy(tree, dev)).cpu().numpy()
    update = float(np.linalg.norm(one["params"] - start))
    real_rank = cs.p11_rank
    for fault, tasks in ((None, ("ppo", "dqn")), (None, ("ppo", "dqn")),
                         ("ppo_index", ("ppo",)),
                         ("ppo_local_wsum", ("ppo",)),
                         ("dqn_index", ("dqn",)), ("dqn_scale", ("dqn",))):
        # The spawned ranks run the patched target, this process the real.
        cs.p11_rank = functools.partial(fault_rank, fault)
        try:
            ranks = cs.run_p11_ranks(cs.P11_RANKS, "gloo",
                                     [dev.index or 0] * cs.P11_RANKS, tasks,
                                     tree)
        finally:
            cs.p11_rank = real_rank
        r = {"fault": fault}
        if "ppo" in tasks:
            p = [x["ppo"]["params"] for x in ranks]
            r["ppo_ranks_equal"] = all(np.array_equal(p[0], q) for q in p)
            r["ppo_update_share"] = float(
                np.linalg.norm(p[0] - one["params"]) / update)
        if "dqn" in tasks:
            q = [x["dqn"]["params"] for x in ranks]
            r["dqn_ranks_equal"] = all(np.array_equal(q[0], x) for x in q)
            r["dqn_max_abs"] = float(np.abs(q[0] - ref["params"]).max())
            r["dqn_replay_equal"] = all(
                np.array_equal(ranks[0]["dqn"]["replay"][k], v)
                for k, v in ref["replay"].items())
        print("ranks against one process: %s (bounds %g of the update's "
              "norm %.6g, %g max abs)  [%s]"
              % (json.dumps(r), cs.P11_UPDATE_NORM, update,
                 cs.P11_DQN_MAX_ABS, card), flush=True)


RANK_ITERATIONS = 10


def timed_iterations(dev, levels, tree, lanes):
    """One rank's part of ``ranks-time`` (module docstring), in place of
    ``cs.p11_ppo``."""
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.models import nets as N
    from safelife_tpu_torch.training import ppo as P

    searches = getattr(N, "conv_searches", lambda: None)
    pool = pack_levels(levels, device=dev)
    cfg = E.EnvConfig(view_shape=cs.VIEW, output_channels=None)
    wcfg = W.WrapperConfig(se_baseline="inaction")
    pcfg = P.PPOConfig()
    ps = P.init_ppo_state(pcfg, cs.policy(tree, dev), device=dev)
    ws, obs = W.reset(cfg, wcfg, pool, cs.P11_LANES, device=dev, lanes=lanes)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"ms": [], "searches": [searches()]}
    for _ in range(RANK_ITERATIONS + 1):
        ms, (ps, ws, obs, _) = cs.event_ms(lambda: P.train_iteration(
            cfg, wcfg, pcfg, pool, ps, ws, obs, gen, device=dev,
            lanes=lanes))
        out["ms"].append(round(ms, 1))
        out["searches"].append(searches())
    return out


def timed_pushes(dev, levels, lanes):
    """One rank's DQN part of ``ranks-time``, in place of ``cs.p11_dqn``:
    ``cs.P11_DQN_UNITS`` units of ``dqn.train_chunk``, each replay push's
    ms (the card synchronised before and after; the first pushes are
    empty until the ``multi_step`` rings fill)."""
    from safelife_tpu_torch.env import env as E, wrappers as W
    from safelife_tpu_torch.env.state import pack_levels
    from safelife_tpu_torch.training import dqn as D

    # A checkout that still has a push of its own for ranks times that one.
    name = next(n for n in ("push_emissions_sharded", "push_emissions")
                if hasattr(D, n))
    push, ms = getattr(D, name), []

    def timed(*args):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = push(*args)
        torch.cuda.synchronize(dev)
        ms.append(round(1e3 * (time.perf_counter() - t), 3))
        return out

    setattr(D, name, timed)
    pool = pack_levels(levels, device=dev)
    env_cfg = E.EnvConfig(view_shape=cs.VIEW, output_channels=None)
    wcfg = W.WrapperConfig(se_baseline="inaction")
    cfg = D.DQNConfig()
    ds = D.init_dqn_state(cfg, cs.q_network(dev, 7),
                          lanes.size * pool.num_agents, cs.VIEW, torch.int32,
                          device=dev)
    ws, obs = W.reset(env_cfg, wcfg, pool, cs.P11_LANES, device=dev,
                      lanes=lanes)
    gen = torch.Generator(device=dev).manual_seed(8)
    n_steps = max(cfg.optimize_interval // cs.P11_LANES, 1)
    for _ in range(cs.P11_DQN_UNITS):
        ds, ws, obs, _ = D.train_chunk(env_cfg, wcfg, cfg, pool, ds, ws, obs,
                                       gen, n_steps, 1, device=dev,
                                       lanes=lanes)
    return {"push": name, "push_ms": ms, "pushed": ds.replay.idx}


def timed_rank(*args):
    cs.p11_ppo = timed_iterations
    cs.p11_dqn = timed_pushes
    return cs.p11_rank(*args)


def rank_timings(dev, card):
    """``ranks-time`` (module docstring)."""
    import numpy as np

    from safelife_tpu_torch.models.nets import TRAINING_CHANNELS

    tree = cs.random_policy_tree(np.random.default_rng(0),
                                 len(TRAINING_CHANNELS), cs.VIEW)
    real_rank = cs.p11_rank
    cs.p11_rank = timed_rank
    try:
        ranks = cs.run_p11_ranks(cs.P11_RANKS, "gloo",
                                 [dev.index or 0] * cs.P11_RANKS,
                                 ("ppo", "dqn"), tree)
    finally:
        cs.p11_rank = real_rank
    for r, x in enumerate(ranks):
        print("ranks-time rank %d: %s  [%s]" % (r, json.dumps(x), card),
              flush=True)


def anneal_iteration_cost(dev, card, blocks=10):
    """The device annealer's iteration at 8, 64 and 256 chains: a 16x16
    writable square in a 26x26 board and a fill floor of 2, so that no
    chain converges; one block of iterations eagerly as a warm-up, 3
    more timed, then the block captured as a CUDA graph and ``blocks``
    replays timed, each block's uniforms drawn first, as
    ``_Chains.run`` does."""
    import numpy as np

    from safelife_tpu_torch.procgen import anneal_device as AD

    mask = np.zeros((26, 26), np.int32)
    mask[3:19, 3:19] = AD.NEW_CELL_MASK | AD.INCLUDE_VIOLATIONS_MASK
    mask[2:20, 2:20] |= AD.INCLUDE_VIOLATIONS_MASK
    for n in (8, 64, 256):
        m = torch.from_numpy(np.tile(mask, (n, 1, 1))).to(dev)
        full = lambda v: torch.full((n,), v, device=dev)  # noqa: E731
        pens = torch.tensor([0, 0, 100, 100, 0, 0, 100, 100.],
                            device=dev).repeat(n, 1)
        c = AD._Chains(torch.zeros((n, 26, 26), dtype=torch.int32,
                                   device=dev), m, (m & 1) > 0, full(0.5),
                       full(0.0), pens, 1)
        c.start(full(2.0), full(1000.0))
        gen = torch.Generator(device=dev).manual_seed(0)

        def draw():
            c.site_u.uniform_(generator=gen)
            c.move_u.uniform_(generator=gen)

        draw()
        AD._anneal_block(c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            draw()
            AD._anneal_block(c)
        torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) / (3 * AD.CHECK_EVERY) * 1e3
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            AD._anneal_block(c)
        torch.cuda.synchronize()
        capture = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(blocks):
            draw()
            graph.replay()
        torch.cuda.synchronize()
        replayed = (time.perf_counter() - t0) / (blocks * AD.CHECK_EVERY)
        if not bool(c.active().all()):
            raise AssertionError("a chain stopped")
        print("annealer iteration, %d chains on 26x26: eager %.4f ms, "
              "graph %.4f ms (capture %.3f s), %d iterations run  [%s]"
              % (n, eager, replayed * 1e3, capture, int(c.it), card),
              flush=True)


BENCH_RUNS = 3


def bench_rates(dev, card, runs=BENCH_RUNS):
    """The bench verb ``runs`` times at its headline, each run its own
    process (both modes, ``chip_smoke.run_bench_cli``: launches checked);
    then one 100-step chunk of each mode in this process under the
    profiler: wall and device-busy time a step, the device's share."""
    from safelife_tpu_torch import bench

    for _ in range(runs):
        cs.run_bench_cli(card)
    pool = bench.load_pool(dev)
    for mode in cs.BENCH_MODES:
        run = bench.setup(pool, mode, cs.BENCH_BATCH)
        bench.run_chunk(run, cs.BENCH_SCAN).item()  # warm-up
        cs.profile_window(lambda: bench.run_chunk(run, cs.BENCH_SCAN),
                          "the bench's %s chunk at %d lanes" % (
                              mode, cs.BENCH_BATCH), "step", cs.BENCH_SCAN)


CONV_SAMPLES = (16384, 4096, 1024, 512, 256, 128, 96, 64, 25)
CONV_CALLS = 20
CONV_PICKS = ("heuristic", "measured", "measured")
FLOAT32_PEAK = 67e12


def device_kernels(prof):
    """{kernel: device us} of the profiler's device activities."""
    out = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            out[e.key] = out.get(e.key, 0.0) + e.device_time_total
    return out


def conv_table(dev, card, pick):
    """``convs=<pick>``: each trunk convolution's three passes under one of
    ``CONV_PICKS`` (module docstring)."""
    from torch.profiler import ProfilerActivity, profile
    from safelife_tpu_torch.models import nets as N

    torch.backends.cuda.matmul.allow_tf32 = False

    def flags():
        return torch.backends.cudnn.flags(
            enabled=True, benchmark=pick == "measured", allow_tf32=False)

    torch.manual_seed(0)
    net = N.SafeLifePolicyNetwork(unpack_channels=N.TRAINING_CHANNELS,
                                  device=dev)
    cs.log("convs=%s  [%s]" % (pick, card))
    for n in CONV_SAMPLES:
        x = (torch.rand((n, len(N.TRAINING_CHANNELS)) + cs.VIEW, device=dev)
             < 0.5).float()
        for name in ("conv0", "conv1", "conv2"):
            conv = getattr(net.cnn, name)
            w, stride = conv.weight.detach(), list(conv.stride)

            def backward(mask):
                return torch.ops.aten.convolution_backward(
                    gy, x, w, None, stride, [0, 0], [1, 1], False, [0, 0],
                    1, mask)

            passes = {
                "fprop": lambda: torch.nn.functional.conv2d(
                    x, w, None, stride),
                "dgrad": lambda: backward([True, False, False])[0],
                "wgrad": lambda: backward([False, True, False])[1]}
            for op, fn in passes.items():
                with torch.no_grad(), flags():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn()
                    torch.cuda.synchronize()
                    first_s = time.perf_counter() - t0
                    if op == "fprop":
                        y, gy = out, torch.randn_like(out)
                        flops = 2 * y[0].numel() * w[0].numel() * n
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as p:
                        for _ in range(CONV_CALLS):
                            fn()
                        torch.cuda.synchronize()
                kernels = device_kernels(p)
                ms = sum(kernels.values()) / CONV_CALLS / 1e3
                cs.log("conv %s" % json.dumps({
                    "samples": n, "conv": name, "pass": op, "pick": pick,
                    "ms": round(ms, 4),
                    "peak_pct": round(100 * flops / (ms / 1e3)
                                      / FLOAT32_PEAK, 2),
                    "first_s": round(first_s, 4),
                    "kernels": {k[:72]: round(v / CONV_CALLS / 1e3, 4)
                                for k, v in sorted(kernels.items(),
                                                   key=lambda kv: -kv[1])}}))
            x = torch.relu(y)


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_sweep: no CUDA device\n")
        return 1
    args = sys.argv[1:]
    parent = next((x.split("=", 1)[1] for x in args
                   if x.startswith("parent=")), None)
    pick = next((x.split("=", 1)[1] for x in args
                 if x.startswith("convs=")), None)
    parts = [x for x in args if "=" not in x] or ([] if pick else [
        "physics", "views", "host", "large", "learner", "learner-4096",
        "procgen", "ranks", "ranks-time", "convs", "bench"])
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi_line()
    _build.kernels()
    for source, text in _build.build_logs().items():
        for line in text.splitlines():
            if "Compiling" in line or "registers" in line or "spill" in line:
                print("%s: %s" % (source, line.strip()), flush=True)
    pool = pack_levels(load_levels("benchmarks/v1.0/prune-dynamic.npz"),
                       device=dev)
    if "physics" in parts:
        sweep(dev, pool, card)
    if "views" in parts:
        sweep_views(dev, pool, card)
        sweep_window(dev, card)
    if "host" in parts:
        host = host_cost(dev, pool)
        print("host time a call at B=%d (us): %s  [%s]"
              % (cs.LANES, json.dumps({k: round(v, 3)
                                       for k, v in host.items()}), card),
              flush=True)
    if "large" in parts:
        large_tiles(dev, card, parent)
    if "learner" in parts:
        learner_spread(dev, card, 64, 48, update=True)
    if "learner-4096" in parts:
        learner_spread(dev, card, 4096, LEARNER_4096_BATCHES, update=False)
    if "procgen" in parts:
        anneal_iteration_cost(dev, card)
    if "ranks" in parts:
        rank_readings(dev, card)
    if "ranks-time" in parts:
        rank_timings(dev, card)
    if pick is not None:
        conv_table(dev, card, pick)
    if "convs" in parts:
        for p in CONV_PICKS:
            subprocess.run([sys.executable, __file__, "convs=" + p],
                           check=True)
    if "bench" in parts:
        bench_rates(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
