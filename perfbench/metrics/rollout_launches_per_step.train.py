"""Launch-type runtime calls a training step: the calls whose host
interval lies inside the port's ``ppo/rollout`` span, over its
``env/step`` spans (``env/wrappers.py::step``, one a step). Launch-type:
``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``,
``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ``cudaMemsetAsync``,
``cudaGraphLaunch`` (``perfbench.program_spans.LAUNCHES``): the policy's
forward and sampling, the wrapped step (K1, K2, K3, shaping, lane resets,
episode records) and the final values' forward."""

from perfbench import program_spans as S


def read(t):
    return S.calls_per(t.profile, S.LAUNCHES, "ppo/rollout", "env/step")
