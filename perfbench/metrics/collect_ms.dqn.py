"""Milliseconds a call of ``training/dqn.py::collect`` (the ε-greedy
forwards, the wrapped steps, the n-step rings and the push) in a profiled
call whose ranges wait for the device at both ends (the DQN driver's
``ranged``: range ``dqn.collect``, the push's wait inside it)."""

from perfbench import program_spans as S


def read(t):
    if t.ranged is None:
        return None
    spans = S.ranges(t.ranged, "dqn.collect")
    return 1e-3 * sum(hi - lo for lo, hi in spans) / len(spans) \
        if spans else None
