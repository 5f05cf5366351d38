"""The kernels over their block layouts, and the host cost of a kernel
call, on one CUDA card.

    python3 chip_sweep.py [physics] [views] [host] [learner] [learner-4096]

from the root of a checkout, on a host with a CUDA card and ``nvcc`` (no
argument runs all five parts). It imports torch and the port only, prints
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


@contextlib.contextmanager
def tf32_learner():
    """The learner with TF32 allowed everywhere: ``strict_float32`` (of
    the network and of ``training/ppo.py``) swapped for a context that
    turns TF32 on."""
    from safelife_tpu_torch.models import nets
    from safelife_tpu_torch.training import ppo

    @contextlib.contextmanager
    def allow_tf32():
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    strict = nets.strict_float32
    nets.strict_float32 = ppo.strict_float32 = allow_tf32
    try:
        yield
    finally:
        nets.strict_float32 = ppo.strict_float32 = strict


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
        for mode, ctx in (("strict float32", contextlib.nullcontext),
                          ("TF32", tf32_learner)):
            with ctx():
                r = cs.learner_diffs(dev, tree, state, batch, seed=12 + i)
            print("learner at %d lanes, batch %d, %s: %s  [%s]"
                  % (lanes, i, mode, cs.learner_line(r), card), flush=True)
        ppo.train_on_batch(run["pcfg"], run["ps"], batch, run["gen"])


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_sweep: no CUDA device\n")
        return 1
    parts = sys.argv[1:] or ["physics", "views", "host", "learner",
                             "learner-4096"]
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
