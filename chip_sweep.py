"""The kernels over their block layouts, and the host cost of a kernel
call, on one CUDA card.

    python3 chip_sweep.py [physics] [views] [host] [learner] [learner-4096]
                          [procgen] [ranks] [bench]

from the root of a checkout, on a host with a CUDA card and ``nvcc`` (no
argument runs all eight parts). It imports torch and the port only, prints
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
  achievable-bandwidth yardstick (not a port of the function).
* At B = 512, the host time of one wrapper call and of the parts of the
  launch path, in microseconds a call over 2000 calls.
* ``learner``: the spread of ``chip_smoke.py``'s learner check (the PPO
  update on the card against the CPU path) over 48 batches of a 64-lane
  append-spawn training run, once in strict float32 and once with TF32
  allowed for cuBLAS and cuDNN: the loss, gradient and parameter
  differences that the check bounds. ``learner-4096``: the same over 6
  batches of a 4096-lane run (minibatches of 16,384 samples, where cuDNN
  takes other convolution engines).
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
* ``bench``: ``python -m safelife_tpu_torch bench`` three times at its
  headline (4096 lanes, packed and channels views), each run its own
  process with its launches checked as ``chip_smoke.py``'s phase 12 does,
  then one 100-step chunk of each mode under the profiler: wall and device
  busy time a step, and the top device operations.
"""

import contextlib
import json
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
        a, e = locs.shape[1], args[4].shape[1]
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
        nbytes = (2 * cs.covered_cells(h, w, *args[2:], cs.VIEW) * 4
                  + 2 * b * a * 4 + b * e * 9 + b * a * vh * vw * 4)
        src = torch.zeros(nbytes // 8, dtype=torch.int32, device=dev)
        dst = torch.empty_like(src)
        t, how = cs.device_ms(lambda: dst.copy_(src), "Memcpy")
        print("B=%d: yardstick, device-to-device copy_ of %d bytes (moves "
              "%d, K3's count): %.5f ms (%s), %.1f GB/s  [%s]"
              % (b, 4 * src.numel(), 8 * src.numel(), t, how,
                 8 * src.numel() / t / 1e6, card), flush=True)


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


def learner_spread(dev, card, lanes, n_batches):
    """``cs.learner_diffs`` on successive batches of one training run of
    ``lanes`` lanes, from the parameters that collected each batch, strict
    and TF32."""
    import numpy as np

    from safelife_tpu_torch.models.nets import TRAINING_CHANNELS
    from safelife_tpu_torch.training import ppo

    tree = cs.random_policy_tree(np.random.default_rng(0),
                                 len(TRAINING_CHANNELS), cs.VIEW)
    run = cs.training_setup(dev, load_levels(cs.TRAIN_LEVELS), tree, lanes,
                            seed=10)
    for i in range(n_batches):
        state = cs.model_state(run)
        batch = cs.rollout_batch(run)
        for mode, precision in (("strict float32", "float32"),
                                ("TF32", "tensorfloat32")):
            r = cs.learner_diffs(dev, tree, state, batch, seed=12 + i,
                                 precision=precision)
            print("learner at %d lanes, batch %d, %s: %s  [%s]"
                  % (lanes, i, mode, cs.learner_line(r), card), flush=True)
        ppo.train_on_batch(run["pcfg"], run["ps"], batch, run["gen"])


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
        def local_wsum(cfg, model, mb):
            w = mb["weight"]
            terms = PPO._loss_terms(cfg, model, mb["obs"], mb["actions"],
                                    mb["action_prob"], mb["values"],
                                    mb["returns"], mb["advantages"])
            sums = torch.stack([torch.sum(x * w) for x in terms])
            tot = M.all_reduce_sum(torch.cat([sums.detach(),
                                              w.sum().reshape(1)]))
            return PPO._combine(cfg, *(
                tot[:3] / torch.clamp(tot[3], min=1.0)
                + (sums - sums.detach()) / torch.clamp(w.sum(), min=1.0)))
        PPO._sharded_loss = local_wsum
    elif fault == "dqn_index":
        real_opt = D.optimize

        def off_by_one(cfg, dstate, generator, n_env_steps, sample_idx=None,
                       lanes=None):
            size = max(dstate.replay.size(), 1)
            idx = torch.randint(0, size, (cfg.batch_size,),
                                generator=generator,
                                device=dstate.replay.obs.device)
            return real_opt(cfg, dstate, generator, n_env_steps,
                            (idx + 1) % size, lanes)
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


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_sweep: no CUDA device\n")
        return 1
    parts = sys.argv[1:] or ["physics", "views", "host", "learner",
                             "learner-4096", "procgen", "ranks", "bench"]
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
    if "host" in parts:
        host = host_cost(dev, pool)
        print("host time a call at B=%d (us): %s  [%s]"
              % (cs.LANES, json.dumps({k: round(v, 3)
                                       for k, v in host.items()}), card),
              flush=True)
    if "learner" in parts:
        learner_spread(dev, card, 64, 48)
    if "learner-4096" in parts:
        learner_spread(dev, card, 4096, 6)
    if "procgen" in parts:
        anneal_iteration_cost(dev, card)
    if "ranks" in parts:
        rank_readings(dev, card)
    if "bench" in parts:
        bench_rates(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
