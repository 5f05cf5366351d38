"""Host microseconds a call of ``env/env.py::step_core`` in the traced
window, without waiting for the device: what the host pays to dispatch one
env step (actions, the CA step, scoring, exits)."""


def read(t):
    s = t.spans.get("env.step_core")
    return 1e6 * sum(s) / len(s) if s else None
