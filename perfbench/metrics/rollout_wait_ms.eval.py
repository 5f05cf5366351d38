"""Milliseconds a ``runner.benchmark`` call in which the device idles
inside the port's ``rollout/episodes`` spans (``training/runner.py::
run_episodes``: the policy rollout of every lane for the step limit) that
lie inside its ``eval/benchmark`` span, over the profiled call's
``eval/benchmark`` spans. Idle: the profiled window less the union of its
device activities, on the profiler's clock (``perfbench.program_spans``).
"""

from perfbench import program_spans as S


def read(t):
    return S.wait_ms_per(t.profile, "rollout/episodes", "eval/benchmark",
                         within="eval/benchmark")
