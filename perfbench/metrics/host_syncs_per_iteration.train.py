"""Blocking runtime calls an iteration: the calls whose host interval lies
inside the port's ``ppo/iteration`` span, over its count. Blocking:
``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, ``cudaMemcpy``
(``perfbench.program_spans.BLOCKING``): each is a point where the host
waits for the device (an ``.item()``, a ``nonzero``, a copy to the host),
which a CUDA graph of the iteration could not hold."""

from perfbench import program_spans as S


def read(t):
    return S.calls_per(t.profile, S.BLOCKING, "ppo/iteration",
                       "ppo/iteration")
