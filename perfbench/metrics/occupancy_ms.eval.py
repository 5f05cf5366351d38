"""Milliseconds of one batch's occupancy counts
(``side_effects.py::batched_occupancy``: the pre-steps and both futures,
one K2 launch a step), waiting for the device at both ends."""


def read(t):
    s = t.spans.get("runner.batched_occupancy")
    return 1e3 * sum(s) / len(s) if s else None
