"""Evaluation throughput: scored episodes of every whole
``runner.benchmark`` call of the window (the call in flight when the
window's time ran out finished and counted) over the window's wall
time."""


def read(t):
    w = t.work
    return w["episodes"] / w["seconds"] if "episodes" in w else None
