"""The headline benchmark: env-steps/s on append-still at 4096 lanes.

    python -m safelife_tpu_torch bench [--batch 4096] [--scan 100]
        [--reps 20] [--obs packed|channels|flat] [--device cuda|cpu]
        [--one-mode] [--sidecar runs/BENCH_MODES_torch.json]

Port of the root ``bench.py`` (``:82-166``, printed at ``:199-202``): 4096
lockstep boards of the frozen v1.0 append-still suite step with random
actions, and every step pays for the whole env step, K1 (the actions and
the CA advance), the exit logic and scoring, the auto-reset merge and a
live 25x25 observation from K3. The observation is folded into the next
actions through a checksum, so it is a live dependency of the action
stream, as a policy's would be. The loop dispatches step by step, as
``training/runner.py::run_episodes`` does.

One chunk is ``--scan`` steps. One warm-up chunk runs, then ``--reps``
timed chunks; the clock stops after ``.item()`` of the last chunk's
reward sum and ``torch.cuda.synchronize()``. Stdout gets one JSON line
with the JAX bench's keys ``metric``, ``value``, ``unit`` and
``vs_baseline`` for the headline mode (``--obs``); the card's name and
the progress go to stderr. By default the other of ``packed`` and
``channels`` runs too, and both land in the ``--sidecar`` file with
``build_s`` (the kernels' build at first use, about 0 when cached),
``warmup_s`` (the first chunk) and the kernel launches of the reset and
of the timed chunks. A failure in either mode raises.

The flags stand for the JAX bench's environment variables: ``--batch``
for ``SAFELIFE_TPU_BENCH_BATCH``, ``--scan`` for
``SAFELIFE_TPU_BENCH_SCAN``, ``--reps`` for ``SAFELIFE_TPU_BENCH_REPS``,
``--obs`` for ``SAFELIFE_TPU_BENCH_OBS`` and ``--one-mode`` for
``SAFELIFE_TPU_BENCH_BOTH=0``. ``--device`` is the port's own: the card
unless ``cpu`` is asked for.

Observation modes: ``packed`` (the training default) emits the packed
int32 views; ``channels`` the 15 uint8 training channels; ``flat`` the
channels reshaped to [B, A, 25·25·15] (the port's ``EnvConfig`` has no
``flat_obs``).
"""

import argparse
import json
import os
import sys
import time
import types

import torch

from . import ops
from .env import env as E
from .env.state import pack_levels
from .io.levels import LEVEL_DIRECTORY, load_levels
from .models.nets import TRAINING_CHANNELS
from .ops import _build
from .utils.device import resolve_device

#: The reference's serial engine, about 1e4 env-steps/s a process (the
#: JAX bench's denominator for ``vs_baseline``).
REFERENCE_BASELINE_STEPS_PER_S = 1.0e4

LEVELS = os.path.join(LEVEL_DIRECTORY, "benchmarks", "v1.0",
                      "append-still.npz")
SIDECAR = os.path.join("runs", "BENCH_MODES_torch.json")
NUM_ACTIONS = 9

OBS_DESC = {
    "channels": "full 15-channel 25x25 obs",
    "packed": "packed int32 25x25 obs (training default)",
    "flat": "flat 15-channel 25x25 obs",
}


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def load_pool(device, path=LEVELS):
    """The append-still v1.0 pool on ``device``; raises if the file is
    missing."""
    if not os.path.exists(path):
        raise FileNotFoundError("benchmark levels not found: %s" % path)
    return pack_levels(load_levels(path), device=device)


def env_config(obs_mode):
    """The bench's ``EnvConfig``: 25x25 views, 1000-step episodes,
    auto-reset; packed views for ``packed``, the training channels
    otherwise."""
    if obs_mode not in OBS_DESC:
        raise ValueError("unknown obs mode %r (one of %s)"
                         % (obs_mode, ", ".join(OBS_DESC)))
    return E.EnvConfig(
        view_shape=(25, 25),
        output_channels=None if obs_mode == "packed" else TRAINING_CHANNELS,
        time_limit=1000, auto_reset=True)


def _wrap_int32(x):
    """int64 values wrapped to int32 as two's-complement arithmetic
    wraps them."""
    return ((x + 2 ** 31) & (2 ** 32 - 1)) - 2 ** 31


def checksum(obs):
    """int32 [B, A]: each agent's observation summed with int32
    wrap-around, as JAX's ``sum(dtype=int32)`` (packed views carry bits up
    to 27, so a sum does overflow)."""
    b, a = obs.shape[:2]
    total = obs.reshape(b, a, -1).sum(-1, dtype=torch.int64)
    return _wrap_int32(total).to(torch.int32)


def fold_actions(base, check):
    """``(base + check) % 9`` in int32: the sum wraps, the mod is a floor
    mod (``bench.py:115-117``)."""
    total = _wrap_int32(base.to(torch.int64) + check.to(torch.int64))
    return torch.remainder(total, NUM_ACTIONS).to(torch.int32)


def setup(pool, obs_mode, batch, draw=None):
    """A run of the bench loop on the pool's device: the config, the reset
    batch and its views, the generator (seeded 0) the env's reset picks
    and the default actions draw from, and ``draw``, the callable that
    gives each step's base actions int32 [B, A] in [0, 9) (a random draw
    unless given)."""
    dev = pool.device
    cfg = env_config(obs_mode)
    generator = torch.Generator(device=dev).manual_seed(0)
    state, obs = E.reset(cfg, pool, batch)
    shape = (batch, pool.num_agents)
    if draw is None:
        def draw():
            return torch.randint(0, NUM_ACTIONS, shape, dtype=torch.int32,
                                 generator=generator, device=dev)
    return types.SimpleNamespace(cfg=cfg, pool=pool, state=state,
                                 obs=_as_mode(obs, obs_mode),
                                 obs_mode=obs_mode, generator=generator,
                                 draw=draw)


def _as_mode(obs, obs_mode):
    return obs.reshape(obs.shape[:2] + (-1,)) if obs_mode == "flat" else obs


def step(run):
    """One step of the loop: base actions from ``run.draw``, the checksum
    of the current views folded in, then ``env.step``. Updates ``run``'s
    state and views; returns (reward float32 [B, A], checksum, actions)."""
    check = checksum(run.obs)
    actions = fold_actions(run.draw(), check)
    run.state, obs, reward, _, _ = E.step(run.cfg, run.pool, run.state,
                                          actions, run.generator)
    run.obs = _as_mode(obs, run.obs_mode)
    return reward, check, actions


def run_chunk(run, steps):
    """``steps`` steps; returns the chunk's reward sum (a float32 tensor
    on the run's device)."""
    total = torch.zeros((), dtype=torch.float32, device=run.obs.device)
    for _ in range(steps):
        reward, _, _ = step(run)
        total = total + reward.sum()
    return total


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_mode(pool, obs_mode, batch=4096, scan=100, reps=20):
    """Measure one observation mode on the pool's device: a warm-up chunk,
    then ``reps`` timed chunks of ``scan`` steps. Returns the result dict
    (the headline keys, ``warmup_s`` and the launches of the reset and of
    the timed chunks)."""
    dev = pool.device
    ops.reset_launch_counts()
    run = setup(pool, obs_mode, batch)
    reset_launches = _nonzero(ops.launch_counts())

    t0 = time.perf_counter()
    run_chunk(run, scan).item()
    _sync(dev)
    warmup_s = time.perf_counter() - t0

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(reps):
        rsum = run_chunk(run, scan)
    log("reward checksum:", rsum.item())
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = _nonzero(ops.launch_counts())

    steps = batch * scan * reps
    rate = steps / dt
    log("%s: warmup %.3f s; %.0f env-steps/s over %d steps in %.3f s on %s"
        % (obs_mode, warmup_s, rate, steps, dt, device_name(dev)))
    return {
        "metric": "env-steps/s/chip (append-still, batch %d, %s)"
                  % (batch, OBS_DESC[obs_mode]),
        "value": round(rate),
        "unit": "env-steps/s",
        "vs_baseline": round(rate / REFERENCE_BASELINE_STEPS_PER_S, 2),
        "warmup_s": warmup_s,
        "seconds": dt,
        "steps": steps,
        "reset_launches": reset_launches,
        "launches": launches,
    }


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def device_name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def add_arguments(parser):
    parser.add_argument("--batch", type=int, default=4096,
                        help="lanes (SAFELIFE_TPU_BENCH_BATCH)")
    parser.add_argument("--scan", type=int, default=100,
                        help="steps a chunk (SAFELIFE_TPU_BENCH_SCAN)")
    parser.add_argument("--reps", type=int, default=20,
                        help="timed chunks (SAFELIFE_TPU_BENCH_REPS)")
    parser.add_argument("--obs", default="packed", choices=sorted(OBS_DESC),
                        help="headline observation mode "
                             "(SAFELIFE_TPU_BENCH_OBS)")
    parser.add_argument("--one-mode", action="store_true",
                        help="the headline mode only "
                             "(SAFELIFE_TPU_BENCH_BOTH=0)")
    parser.add_argument("--sidecar", default=SIDECAR,
                        help="where both modes' results go")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return parser


def run(args):
    """Run the bench for parsed ``args``; prints the headline line and
    returns the results by mode."""
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _build.kernels()
    build_s = time.perf_counter() - t0
    log("device: %s; kernels built in %.3f s" % (device_name(dev), build_s))
    log("levels:", LEVELS)
    pool = load_pool(dev)

    modes = [args.obs]
    if not args.one_mode:
        modes.append("channels" if args.obs == "packed" else "packed")
    results = {}
    for mode in modes:
        results[mode] = run_mode(pool, mode, args.batch, args.scan,
                                 args.reps)
        results[mode]["build_s"] = build_s
        results[mode]["device"] = device_name(dev)
    if not args.one_mode:
        folder = os.path.dirname(args.sidecar)
        if folder:
            os.makedirs(folder, exist_ok=True)
        with open(args.sidecar, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
            f.write("\n")
        log("both-mode sidecar:", args.sidecar)

    print(json.dumps({k: results[args.obs][k]
                      for k in ("metric", "value", "unit", "vs_baseline")}))
    return results


def main(argv=None):
    parser = add_arguments(argparse.ArgumentParser(
        prog="safelife_tpu_torch bench", description=__doc__.split("\n")[0]))
    return run(parser.parse_args(argv))


if __name__ == "__main__":
    main()
