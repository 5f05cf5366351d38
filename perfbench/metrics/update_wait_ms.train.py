"""Milliseconds an iteration in which the device idles inside the port's
``ppo/update`` span (``training/ppo.py::train_on_batch``: every
minibatch's gather, loss, backward and Adam step), over the profiled
call's ``ppo/iteration`` spans. Idle: the profiled window less the union
of its device activities, on the profiler's clock
(``perfbench.program_spans``)."""

from perfbench import program_spans as S


def read(t):
    return S.wait_ms_per(t.profile, "ppo/update", "ppo/iteration")
