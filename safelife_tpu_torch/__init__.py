"""SafeLife on PyTorch and CUDA: the port of :mod:`safelife_tpu`.

The JAX package ``safelife_tpu`` stays the reference; this package carries
the same batched lockstep environment with torch tensors, and the three
Pallas kernels of ``safelife_tpu/ops/`` as CUDA C++ kernels written for
Hopper (``ops/csrc/``). It imports torch and numpy, never JAX and nothing
of ``safelife_tpu``.

Quick map:

* :mod:`safelife_tpu_torch.io.levels` — ``load_levels`` for ``.npz`` files.
* :mod:`safelife_tpu_torch.env` — ``pack_levels``, ``reset``/``step``.
* :mod:`safelife_tpu_torch.ops` — the CUDA kernels and their plain versions.
* :mod:`safelife_tpu_torch.models` — the policy network and the flax
  parameter converter.
* :mod:`safelife_tpu_torch.training.runner` — ``run_episodes``/``benchmark``
  (side effects scored by :mod:`safelife_tpu_torch.side_effects`).
* :mod:`safelife_tpu_torch.training.ppo` — the PPO training iteration.
* :mod:`safelife_tpu_torch.training.train` — ``run_benchmark``/
  ``run_validation``, logged by :mod:`safelife_tpu_torch.loggers`.
* :mod:`safelife_tpu_torch.io.iterator` — the level pool manager;
  :mod:`safelife_tpu_torch.training.checkpoints` — checkpoints.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"
