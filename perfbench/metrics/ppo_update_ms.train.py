"""Milliseconds a call of ``training/ppo.py::train_on_batch`` in the
traced window (forward, backward and Adam over every minibatch of every
epoch), waiting for the device at both ends."""


def read(t):
    s = t.spans.get("ppo.train_on_batch")
    return 1e3 * sum(s) / len(s) if s else None
