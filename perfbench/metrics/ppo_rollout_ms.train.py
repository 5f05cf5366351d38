"""Milliseconds a call of ``training/ppo.py::rollout`` in the traced
window (env steps, wrappers, policy forwards, sampling), waiting for the
device at both ends."""


def read(t):
    s = t.spans.get("ppo.rollout")
    return 1e3 * sum(s) / len(s) if s else None
