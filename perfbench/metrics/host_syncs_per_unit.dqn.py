"""Blocking runtime calls a DQN unit: the calls whose host interval lies
inside the port's ``dqn/unit`` span, over its count. Blocking:
``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, ``cudaMemcpy``
(``perfbench.program_spans.BLOCKING``): each is a point where the host
waits for the device (the push's ``nonzero``, the auto-reset's
fraction)."""

from perfbench import program_spans as S


def read(t):
    return S.calls_per(t.profile, S.BLOCKING, "dqn/unit", "dqn/unit")
