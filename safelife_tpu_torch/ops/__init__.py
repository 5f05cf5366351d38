"""The port's hand-written CUDA kernels for Hopper, and their plain versions.

These replace the three Pallas kernels of ``safelife_tpu/ops/``:

* K1 :func:`fused_actions_advance` — ``safelife_tpu/ops/physics.py:296``
* K2 :func:`advance` — ``safelife_tpu/ops/physics.py:371``
* K3 :func:`recenter_views` — ``safelife_tpu/ops/obs.py:146``

A wrapper launches its kernel for CUDA tensors (building ``csrc/`` at first
use, see :mod:`._build`) and runs its ``*_plain`` version for CPU tensors.
Each kernel has two forms in its source, chosen by shape: the staged one,
which works out of shared memory, and a global-memory one (``*_global``)
for boards (and, for K3, views) too large to stage.
"""

from . import _build
from .obs import recenter_views, recenter_views_plain  # noqa: F401
from .physics import (  # noqa: F401
    advance,
    advance_plain,
    fused_actions_advance,
    fused_actions_advance_plain,
)


def reset_launch_counts():
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0


def launch_counts():
    """Launches of each kernel form since the last reset, by name
    (``fused_actions_advance``, ``fused_actions_advance_global``, …)."""
    return dict(_build.LAUNCHES)
