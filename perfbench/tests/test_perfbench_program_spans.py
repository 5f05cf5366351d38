"""The readers of the port's layer spans (``perfbench.program_spans`` and
the metrics that use it) on synthetic profiles with known idle intervals,
nested spans and runtime calls, and on the spans of a real CPU profile.

    python -m pytest perfbench/tests/test_perfbench_program_spans.py -q
"""

import random
import types

import pytest
import torch

from perfbench import harness, program_spans as S
from perfbench.tests.sizes import card

TRAIN = ("rollout_wait_ms.train", "update_wait_ms.train",
         "rollout_launches_per_step.train",
         "update_launches_per_minibatch.train",
         "host_syncs_per_iteration.train")
EVAL = ("rollout_wait_ms.eval",)


def read(metric, profile):
    return harness.metric_reader(metric).read(
        types.SimpleNamespace(profile=profile))


def profile(window, device, ranges):
    """What the readers use of a ``profiling.Profile``: the window (us),
    the device activities (name, start, end) and the host ranges."""
    return types.SimpleNamespace(window=window, device=device,
                                 ranges=ranges)


def train_profile():
    """Two iterations in a 1000 us window. Device busy [0, 100], [150, 300],
    [400, 800] (two activities overlapping) and from 950 past the window's
    end: idle [100, 150], [300, 400], [800, 950], 300 us."""
    return profile((0, 1000), [
        ("k", 0, 100), ("k", 150, 300), ("k", 400, 700), ("k", 690, 800),
        ("k", 950, 1200)], {
        "ppo/iteration": [(500, 1000), (0, 500)],
        "ppo/rollout": [(0, 200), (500, 600)],
        "env/step": [(10, 50), (60, 90), (510, 550)],
        "ppo/update": [(200, 450), (600, 900)],
        "ppo/minibatch": [(210, 300), (310, 440), (610, 890)],
        # (199, 201) crosses the rollout's end: counted nowhere.
        "cudaLaunchKernel": [(20, 21), (70, 71), (199, 201), (520, 521),
                             (220, 221), (700, 701)],
        "cudaMemcpyAsync": [(30, 31)],
        "cudaGraphLaunch": [(230, 231)],
        "aten::add": [(25, 26)],
        # (999, 1001) crosses the window's, and the iteration's, end.
        "cudaStreamSynchronize": [(440, 449), (950, 990)],
        "cudaDeviceSynchronize": [(999, 1001)],
    })


def eval_profile():
    """One call [100, 900]; device busy [0, 200] and [300, 850]: idle
    [200, 300], [850, 1000]. A second ``rollout/episodes`` range lies
    outside the call."""
    return profile((0, 1000), [("k", 0, 200), ("k", 300, 850)], {
        "eval/benchmark": [(100, 900)],
        "rollout/episodes": [(100, 250), (280, 320), (950, 990)],
    })


def test_idle_and_overlap():
    p = train_profile()
    assert S.idle(p) == [[100, 150], [300, 400], [800, 950]]
    assert S.overlap([[0, 10], [20, 30]], [[5, 25]]) == 10
    assert S.overlap([], [[0, 1]]) == 0
    assert S.idle(profile((0, 10), [], {})) == [[0, 10]]


def test_train_readers_exact():
    p = train_profile()
    # Rollout: idle [100, 150] in [0, 200]; none in [500, 600]. 50 us over
    # two iterations.
    assert read("rollout_wait_ms.train", p) == pytest.approx(0.025)
    # Update: [300, 400] and [800, 900]: 200 us over two iterations.
    assert read("update_wait_ms.train", p) == pytest.approx(0.1)
    # Launches in the rollout: 3 kernels and a copy over 3 steps.
    assert read("rollout_launches_per_step.train", p) == pytest.approx(4 / 3)
    # In the update: 2 kernels and a graph over 3 minibatches.
    assert read("update_launches_per_minibatch.train", p) == 1.0
    # Syncs: one in each iteration; the device sync crosses the end.
    assert read("host_syncs_per_iteration.train", p) == 1.0


def test_eval_reader_exact():
    # Idle inside the call's rollouts: [200, 250] and [280, 300]; the
    # range outside the call is left out.
    assert read("rollout_wait_ms.eval", eval_profile()) == pytest.approx(
        0.07)


@pytest.mark.parametrize("metric", TRAIN + EVAL)
def test_no_profile_reads_nothing(metric):
    assert read(metric, None) is None


@pytest.mark.parametrize("metric", TRAIN + EVAL)
def test_profile_without_spans_reads_nothing(metric):
    """A parent's profile: the harness's ranges and the runtime calls, no
    span of the port."""
    p = train_profile()
    bare = {k: v for k, v in p.ranges.items() if "/" not in k}
    bare["ppo.rollout"] = [(0, 200)]
    bare["runner.run_episodes"] = [(0, 200)]
    assert read(metric, profile(p.window, p.device, bare)) is None


def test_spans_named_by_the_port():
    trace = pytest.importorskip("safelife_tpu_torch.utils.trace")
    used = {"ppo/iteration", "ppo/rollout", "ppo/update", "ppo/minibatch",
            "env/step", "rollout/episodes", "eval/benchmark"}
    assert used <= set(trace.SPANS)


def test_disjoint_spans_wait_at_most_the_idle_time():
    """Over random device activities and random disjoint top-level spans
    (each holding nested ones), the spans' waits add up to at most the
    window's idle time, and each equals the brute-force count on a grid."""
    rng = random.Random(5)
    for _ in range(200):
        device = []
        for _ in range(rng.randint(0, 12)):
            lo = rng.randint(-20, 110)
            device.append(("k", lo, lo + rng.randint(1, 30)))
        cuts = sorted(rng.sample(range(0, 101), 6))
        tops = [(cuts[i], cuts[i + 1]) for i in range(0, 6, 2)]
        inner = [(lo + 1, hi - 1) for lo, hi in tops if hi - lo > 2]
        p = profile((0, 100), device, {"a": tops[:2], "b": tops[2:],
                                       "a/inner": inner})
        busy = [False] * 100
        for _, lo, hi in device:
            for x in range(max(lo, 0), min(hi, 100)):
                busy[x] = True
        idle_us = busy.count(False)
        assert sum(hi - lo for lo, hi in S.idle(p)) == idle_us
        waits = [S.wait_us(p, "a"), S.wait_us(p, "b")]
        assert sum(waits) <= idle_us
        for name, w in zip("ab", waits):
            grid = sum(1 for lo, hi in p.ranges[name]
                       for x in range(lo, hi) if not busy[x])
            assert w == grid
        assert S.wait_us(p, "a/inner") <= waits[0] + waits[1]


def test_readers_on_a_cpu_profile_of_the_port():
    """The port's spans in a real profile of one training iteration on the
    CPU: no device activity, so each wait is its span's whole length and
    no runtime call is counted."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from safelife_tpu_torch.env import env as E, state as ST
    from safelife_tpu_torch.env import wrappers as W
    from safelife_tpu_torch.io import levels as L
    from safelife_tpu_torch.models import nets as N
    from safelife_tpu_torch.training import ppo as P

    pool = ST.pack_levels(L.load_levels(
        "benchmarks/v1.0/append-spawn.npz")[:2], device="cpu")
    cfg = E.EnvConfig(view_shape=(17, 17), output_channels=None)
    wcfg = W.WrapperConfig()
    pcfg = P.PPOConfig(steps_per_env=2, num_minibatches=1,
                       epochs_per_batch=1)
    torch.manual_seed(0)
    net = N.SafeLifePolicyNetwork(view_shape=(17, 17), device="cpu",
                                  unpack_channels=N.TRAINING_CHANNELS)
    state = P.init_ppo_state(pcfg, net, device="cpu")
    ws, obs = W.reset(cfg, wcfg, pool, 2, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        P.train_iteration(cfg, wcfg, pcfg, pool, state, ws, obs, gen,
                          device="cpu")
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end))
    (lo, hi), = ranges["ppo/iteration"]
    p = profile((lo, hi), [], ranges)
    (r0, r1), = ranges["ppo/rollout"]
    assert read("rollout_wait_ms.train", p) == pytest.approx(
        1e-3 * (r1 - r0))
    assert 0 < read("update_wait_ms.train", p) < 1e-3 * (hi - lo)
    assert read("rollout_launches_per_step.train", p) == 0
    assert read("update_launches_per_minibatch.train", p) == 0
    assert read("host_syncs_per_iteration.train", p) == 0


@pytest.mark.card
def test_traced_runs_read_every_span_metric():
    """On the card: small traced runs of a training and the evaluation
    cell print each new metric, and the training waits add up to at most
    the profiled window's idle time an iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed = 2 ** 31 + 7919
    cell = "ppo-append-spawn.train-4096"
    result, checks = harness.run(cell, seed, 0.5, trace=True,
                                 sizes=card(cell))
    assert result["correct"], checks
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(TRAIN) <= set(m), sorted(m)
    idle_ms = 1e3 * (result["device"]["window_s"]
                     - result["device"]["busy_s"])
    assert m["rollout_wait_ms.train"] + m["update_wait_ms.train"] <= idle_ms
    cell = "ppo-prune-spawn.eval-25"
    result, checks = harness.run(cell, seed, 0.5, trace=True,
                                 sizes=card(cell))
    assert result["correct"], checks
    assert result["metrics"]["rollout_wait_ms.eval"]["value"] > 0
