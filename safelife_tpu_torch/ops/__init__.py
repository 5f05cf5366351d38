"""The port's hand-written CUDA kernels for Hopper, and their plain versions.

These replace the three Pallas kernels of ``safelife_tpu/ops/``:

* K1 :func:`fused_actions_advance` — ``safelife_tpu/ops/physics.py:296``
* K2 :func:`advance` — ``safelife_tpu/ops/physics.py:371``
* K3 :func:`recenter_views` — ``safelife_tpu/ops/obs.py:146``

A wrapper launches its kernel for CUDA tensors (building ``csrc/`` at first
use, see :mod:`._build`) and runs its ``*_plain`` version for CPU tensors.
"""

from .obs import recenter_views, recenter_views_plain  # noqa: F401
from .physics import (  # noqa: F401
    advance,
    advance_plain,
    fused_actions_advance,
    fused_actions_advance_plain,
)

#: The kernel wrappers, by name; each counts its launches in ``.launches``.
KERNEL_WRAPPERS = {
    "fused_actions_advance": fused_actions_advance,
    "advance": advance,
    "recenter_views": recenter_views,
}


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
