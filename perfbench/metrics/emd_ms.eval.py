"""Milliseconds the host takes to score one episode's side effects
(``side_effects.py::episode_side_effects``: the float64 EMD of every cell
type), over the traced window's calls."""


def read(t):
    s = t.spans.get("runner.episode_side_effects")
    return 1e3 * sum(s) / len(s) if s else None
