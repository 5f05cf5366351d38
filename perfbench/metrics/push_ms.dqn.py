"""Milliseconds a call of ``training/dqn.py::push_emissions`` (the valid
candidates' positions, the one host sync that counts them, the rows'
gather and their writes to the replay) in a profiled call whose ranges
wait for the device at both ends (the DQN driver's ``ranged``: range
``dqn.push``)."""

from perfbench import program_spans as S


def read(t):
    if t.ranged is None:
        return None
    spans = S.ranges(t.ranged, "dqn.push")
    return 1e-3 * sum(hi - lo for lo, hi in spans) / len(spans) \
        if spans else None
