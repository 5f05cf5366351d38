"""Milliseconds a unit in which the device idles inside the port's
``dqn/optimize`` span (``training/dqn.py::optimize``: the replay gather,
the TD loss with the target's forward, the backward, the Adam step and the
target sync), over the profiled call's ``dqn/unit`` spans. Idle: the
profiled window less the union of its device activities, on the
profiler's clock (``perfbench.program_spans``)."""

from perfbench import program_spans as S


def read(t):
    return S.wait_ms_per(t.profile, "dqn/optimize", "dqn/unit")
