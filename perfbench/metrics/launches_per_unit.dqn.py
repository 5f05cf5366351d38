"""Launch-type runtime calls a DQN unit: the calls whose host interval
lies inside the port's ``dqn/unit`` span
(``training/dqn.py::collect_and_optimize``), from any thread (the
backward's too), over its count. Launch-type: ``cudaLaunchKernel``,
``cudaLaunchKernelExC``, ``cuLaunchKernel``, ``cuLaunchKernelEx``,
``cudaMemcpyAsync``, ``cudaMemsetAsync``, ``cudaGraphLaunch``
(``perfbench.program_spans.LAUNCHES``)."""

from perfbench import program_spans as S


def read(t):
    return S.calls_per(t.profile, S.LAUNCHES, "dqn/unit", "dqn/unit")
