"""Spawn draws of the exact-match oracle step from NumPy's own PCG64.

Port of ``safelife_tpu/core/pcg64.py`` with a smaller design. The
reference consumes randomness through the NumPy bit generator: its C
kernel calls ``next_double`` once per spawn-eligible cell in raster order
and compares the draw with the spawn probability narrowed to float32
(``advance_board.c:94-124``). The JAX package emulates PCG64 in 16-bit
limbs inside jit because jit cannot call the host generator
(``int_to_limbs``, ``limbs_to_int``, ``_mul128``, ``pcg_step``,
``pcg_output``, ``next_uint64``, ``next_double53``, ``double53_lt``,
``state_from_numpy`` and ``state_to_numpy``). The port draws from the
caller's ``numpy.random.Generator`` itself: ``rng.random(n)`` is ``n``
consecutive ``next_double`` calls, so the stream and the generator's
state after it are the reference's. Those helpers therefore have no
counterpart here; :func:`spawn_threshold` keeps ``threshold_53``'s float
narrowing (``:186-193``) and :func:`raster_spawn_draws` is
``raster_spawn_draws`` (``:196-223``).
"""

import numpy as np
import torch


def require_pcg64(rng):
    """Raises unless ``rng`` is a ``numpy.random.Generator`` on PCG64 (the
    ``default_rng`` bit generator), as ``state_from_numpy`` does."""
    name = type(getattr(rng, "bit_generator", None)).__name__
    if name != "PCG64":
        raise ValueError("oracle mode requires a PCG64 bit generator, got %s"
                         % name)


def spawn_threshold(spawn_prob):
    """The threshold a draw is compared with: ``float64(float32(p))``, the
    C float narrowing of the spawn probability."""
    return float(np.float32(spawn_prob))


def raster_spawn_draws(eligible, rng, spawn_prob):
    """Spawn coin flips for the eligible cells of one board, drawn from
    ``rng`` in raster order, one ``next_double`` an eligible cell.

    eligible: bool [H, W] on any device. Returns bool [H, W] on its
    device; ``rng`` advances by the eligible count. The mask comes to the
    host and the coins go back: one host sync.
    """
    require_pcg64(rng)
    elig = eligible.cpu().numpy()
    spawns = np.zeros(elig.shape, bool)
    # Boolean indexing visits the cells in raster (C) order.
    spawns[elig] = rng.random(int(elig.sum())) < spawn_threshold(spawn_prob)
    return torch.from_numpy(spawns).to(eligible.device)
