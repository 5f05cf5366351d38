"""The level generator's global NumPy generator, swappable in a context.

Port of ``safelife_tpu/utils/rng.py:11-36`` (the port's own copy): a
module-level ``numpy.random.Generator`` with ``get_rng``/``set_rng``/
``coinflip``, as the reference's ``safelife/random.py``. The native
annealer takes explicit seeds drawn from this generator, so one
``SeedSequence`` decides everything about a generated level.
"""

import contextlib

import numpy as np

_rng = np.random.default_rng()


def get_rng():
    return _rng


@contextlib.contextmanager
def set_rng(rng):
    """Temporarily swap the global generator."""
    global _rng
    old = _rng
    _rng = rng
    try:
        yield rng
    finally:
        _rng = old


def coinflip(p, size=None):
    """Boolean sample(s) with probability ``p`` of True."""
    return _rng.random(size) < p
