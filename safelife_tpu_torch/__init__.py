"""SafeLife on PyTorch and CUDA: the port of :mod:`safelife_tpu`.

The JAX package ``safelife_tpu`` stays the reference; this package carries
the same batched lockstep environment with torch tensors, and the three
Pallas kernels of ``safelife_tpu/ops/`` as CUDA C++ kernels written for
Hopper (``ops/csrc/``). It imports torch and numpy, never JAX and nothing
of ``safelife_tpu``.

Quick map:

* ``python -m safelife_tpu_torch train DIR -e append-still`` — the
  trainer's CLI (:mod:`safelife_tpu_torch.__main__`; ``--device cpu`` for
  the CPU), with the verbs ``print``, ``new``, ``render`` and ``play``.
* :mod:`safelife_tpu_torch.io.levels` — level files; ``load_levels`` for
  ``.npz`` files.
* :mod:`safelife_tpu_torch.procgen` — the level generator (the native
  annealer of :mod:`safelife_tpu_torch.native`);
  :mod:`safelife_tpu_torch.io.iterator` — ``SafeLifeLevelIterator``.
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
* :mod:`safelife_tpu_torch.training.env_factory` — ``build_environments``;
  :mod:`safelife_tpu_torch.training.train` — ``train_ppo``.
* The front end: :mod:`safelife_tpu_torch.registry` — ``make``, the gym-like
  batched env; :mod:`safelife_tpu_torch.game` — the host game and editor;
  :mod:`safelife_tpu_torch.interactive` (and ``interactive_gl``) — the
  ``play`` verb; :mod:`safelife_tpu_torch.render` — text and sprites;
  :mod:`safelife_tpu_torch.variants` — rule variants.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"
