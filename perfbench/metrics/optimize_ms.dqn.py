"""Milliseconds a call of ``training/dqn.py::optimize`` (the replay gather,
the TD loss with the target network's forward, the backward, the Adam step
and the target sync) in a profiled call whose ranges wait for the device
at both ends (the DQN driver's ``ranged``: range ``dqn.optimize``)."""

from perfbench import program_spans as S


def read(t):
    if t.ranged is None:
        return None
    spans = S.ranges(t.ranged, "dqn.optimize")
    return 1e-3 * sum(hi - lo for lo, hi in spans) / len(spans) \
        if spans else None
