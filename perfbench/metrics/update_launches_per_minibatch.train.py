"""Launch-type runtime calls a minibatch of the update: the calls whose
host interval lies inside the port's ``ppo/update`` span, from any thread
(the backward's too), over its ``ppo/minibatch`` spans. Launch-type:
``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``,
``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ``cudaMemsetAsync``,
``cudaGraphLaunch`` (``perfbench.program_spans.LAUNCHES``); the epochs'
permutations are counted with the minibatches."""

from perfbench import program_spans as S


def read(t):
    return S.calls_per(t.profile, S.LAUNCHES, "ppo/update", "ppo/minibatch")
