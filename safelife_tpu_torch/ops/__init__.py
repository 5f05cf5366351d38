"""The port's hand-written CUDA kernels for Hopper, and their plain versions.

These replace the three Pallas kernels of ``safelife_tpu/ops/``:

* K1 :func:`fused_actions_advance` — ``safelife_tpu/ops/physics.py:296``
* K2 :func:`advance` — ``safelife_tpu/ops/physics.py:371``
* K3 :func:`recenter_views` — ``safelife_tpu/ops/obs.py:146``

and one more replaces no Pallas kernel:

* K4 :func:`unpack_planes` — the policy network's input, packed views
  unpacked into the trunk's float32 planes in one pass, where the JAX
  package leaves ``unpack_obs`` and the transpose to XLA

A wrapper launches its kernel for CUDA tensors (building ``csrc/`` at first
use, see :mod:`._build`) and runs its ``*_plain`` version for CPU tensors.
Each of K1-K3 has two forms in its source, chosen by shape: the staged one,
which works out of shared memory on whole boards, and one for boards
above 12,288 cells and lanes too large to stage whole (``*_global``: K1
and K2 stage tiles of a board, K3 gathers its views' windows from device
memory).
"""

from . import _build
from .obs import recenter_views, recenter_views_plain  # noqa: F401
from .physics import (  # noqa: F401
    advance,
    advance_plain,
    fused_actions_advance,
    fused_actions_advance_plain,
)
from .unpack import unpack_planes, unpack_planes_plain  # noqa: F401


def reset_launch_counts():
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0


def launch_counts():
    """Launches of each kernel form since the last reset, by name
    (``fused_actions_advance``, ``fused_actions_advance_global``, …,
    ``unpack_planes``)."""
    return dict(_build.LAUNCHES)
