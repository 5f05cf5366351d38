"""The DQN cell's yardstick: the Q network's MACs and a unit's FLOPs against
hand counts, and its per-layer readers on synthetic profiles (a parent
without the port's DQN spans reads nothing); on the card, a small traced
run reads every one of them.

    python -m pytest perfbench/tests/test_perfbench_dqn.py -q
"""

import types

import pytest
import torch

from perfbench import harness, qnetwork
from perfbench.tests.sizes import card

CELL = "dqn-append-spawn.train-4096"
CFG = harness.cell(CELL)[3]
METRICS = ("optimize_ms.dqn", "collect_ms.dqn", "push_ms.dqn",
           "launches_per_unit.dqn", "host_syncs_per_unit.dqn",
           "collect_wait_ms.dqn", "optimize_wait_ms.dqn",
           "device_idle_pct.train", "mfu_pct.train")


def read(metric, **t):
    t = dict(dict(profile=None, ranged=None, work={}, peaks=None), **t)
    return harness.metric_reader(metric).read(types.SimpleNamespace(**t))


def test_q_macs_by_hand():
    # 25x25x15 in; 5x5/2 -> 11x11x32, 3x3/2 -> 5x5x64, 3x3/1 -> 3x3x64;
    # two heads 576 -> 256, then 256 -> 9 and 256 -> 1.
    conv0 = 11 * 11 * 32 * 5 * 5 * 15
    conv1 = 5 * 5 * 64 * 3 * 3 * 32
    conv2 = 3 * 3 * 64 * 3 * 3 * 64
    heads = 2 * 576 * 256 + 256 * 9 + 256
    net = CFG["q_network"]
    assert qnetwork.macs(net, (25, 25)) == (conv0 + conv1 + conv2 + heads,
                                             conv0)
    assert conv0 + conv1 + conv2 + heads == 2542048


def test_unit_flops_by_hand():
    fwd = 2 * 2542048
    conv0 = 2 * 1452000
    want = 4096 * fwd + 12288 * (3 * fwd - conv0) + 12288 * fwd
    got = qnetwork.unit_flops(CFG["q_network"], (25, 25), 4096, 12288)
    assert got == want
    assert abs(got / 235.04e9 - 1) < 1e-3


def test_shapes_are_the_ports():
    nets = pytest.importorskip("safelife_tpu_torch.models.nets")
    view = tuple(CFG["view_shape"])
    m = nets.SafeLifeQNetwork(view_shape=view, device="cpu",
                              unpack_channels=CFG["q_network"]["channels"])
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == \
        qnetwork.shapes(CFG["q_network"], view)


def profile(window, device, ranges):
    return types.SimpleNamespace(window=window, device=device, ranges=ranges,
                                 window_s=(window[1] - window[0]) * 1e-6,
                                 busy_s=sum(hi - lo for _, lo, hi in device)
                                 * 1e-6)


def units_profile():
    """Two units in a 1000 us window; device busy 600 us."""
    return profile((0, 1000), [("k", 0, 300), ("k", 500, 800)], {
        "dqn/unit": [(0, 500), (500, 1000)],
        "dqn/collect": [(0, 200), (500, 700)],
        "dqn/optimize": [(200, 500), (700, 1000)],
        "cudaLaunchKernel": [(10, 11), (20, 21), (510, 511), (999, 1001)],
        "cudaMemcpyAsync": [(30, 31)],
        "cudaStreamSynchronize": [(40, 41), (520, 521), (600, 601)],
    })


def test_unit_readers_exact():
    p = units_profile()
    # Launches: 3 kernels and a copy inside the units (one crosses the end).
    assert read("launches_per_unit.dqn", profile=p) == 2.0
    assert read("host_syncs_per_unit.dqn", profile=p) == 1.5
    # Idle: 300-500 and 800-1000. The collects hold none of it, the
    # optimizes 200 us each.
    assert read("collect_wait_ms.dqn", profile=p) == pytest.approx(0.0)
    assert read("optimize_wait_ms.dqn", profile=p) == pytest.approx(0.2)
    assert read("device_idle_pct.train", profile=p) == pytest.approx(40.0)


def test_range_readers_exact():
    ranged = profile((0, 100), [], {"dqn.optimize": [(0, 3000), (4000, 9000)],
                                    "dqn.collect": [(0, 1000)],
                                    "dqn.push": [(100, 300), (400, 500)]})
    assert read("optimize_ms.dqn", ranged=ranged) == pytest.approx(4.0)
    assert read("collect_ms.dqn", ranged=ranged) == pytest.approx(1.0)
    assert read("push_ms.dqn", ranged=ranged) == pytest.approx(0.15)


def test_mfu_exact():
    """The driver's work in the form ``mfu_pct.train`` reads: a unit is an
    iteration."""
    peaks = types.SimpleNamespace(FP32_FLOPS_PER_S=1e12)
    work = {"iterations": 10, "seconds": 2.0, "flops_per_iteration": 1e11}
    assert read("mfu_pct.train", work=work, peaks=peaks) == \
        pytest.approx(50.0)


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_to_read_reads_nothing(metric):
    """No profile, no work, and a parent's profile: the harness's ranges
    and the runtime calls, no span of the port."""
    assert read(metric) is None
    bare = {k: v for k, v in units_profile().ranges.items() if "/" not in k}
    p = profile((0, 1000), [], bare)
    if metric != "device_idle_pct.train":
        assert read(metric, profile=p, ranged=p) is None


def test_spans_named_by_the_port():
    trace = pytest.importorskip("safelife_tpu_torch.utils.trace")
    assert {"dqn/unit", "dqn/collect", "dqn/push", "dqn/optimize"} <= set(
        trace.SPANS)


@pytest.mark.card
def test_traced_run_reads_every_metric():
    """On the card: a small traced run prints each of the cell's metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result, checks = harness.run(CELL, 2 ** 31 + 7919, 0.5, trace=True,
                                 sizes=card(CELL))
    assert result["correct"], checks
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(METRICS) <= set(m), sorted(m)
    assert m["host_syncs_per_unit.dqn"] >= 1
    assert 0 < m["mfu_pct.train"] < 100
