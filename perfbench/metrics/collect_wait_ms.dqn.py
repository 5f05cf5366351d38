"""Milliseconds a unit in which the device idles inside the port's
``dqn/collect`` span (``training/dqn.py::collect``: the ε-greedy forwards,
the wrapped steps, the n-step rings and the push), over the profiled
call's ``dqn/unit`` spans. Idle: the profiled window less the union of its
device activities, on the profiler's clock (``perfbench.program_spans``).
Unlike ``collect_ms.dqn`` it waits for nothing: it reads the device's idle
time while the host dispatches the collect."""

from perfbench import program_spans as S


def read(t):
    return S.wait_ms_per(t.profile, "dqn/collect", "dqn/unit")
