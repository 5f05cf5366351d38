"""K3: packed observation views, and their plain version.

Port of ``safelife_tpu/ops/obs.py::recenter_views_pallas`` (``:146-218``,
kernel ``_obs_kernel`` ``:101-143``). CUDA source ``csrc/obs.cu``.

Per (lane, agent): the packed word ``board | (goal_colour << 16)`` with
white goals removed, in the wrapped ``vh x vw`` window whose origin is
``((cy - vh//2) mod H, (cx - vw//2) mod W)``, with the level exits projected
onto the view's perimeter in exit order, later exits winning (reference
``helper_utils.py:42-75``). Callers centre masked agents at 0, as
``get_obs_batch`` does. The uint8 channel unpack stays separate
(``env.unpack_view_channels``).

The wrapper launches the kernel for CUDA tensors and runs
:func:`recenter_views_plain` for CPU tensors; ``recenter_views.launches``
counts kernel launches. Views larger than the board, which the JAX
package tiles on its XLA path, are refused on both.
"""

import torch

from ..core import cells as C
from . import _build
from .physics import _require


def packed_board(board, goals, remove_white_goals=True):
    """int32 ``board | (goal colours << 16)``, white goals removed."""
    gcol = goals & C.RAINBOW_COLOR
    if remove_white_goals:
        gcol = gcol * (gcol != C.RAINBOW_COLOR).to(torch.int32)
    return board | (gcol << 16)


def recenter_views_plain(board, goals, cy, cx, exit_locs, exit_valid, *,
                         view_shape, remove_white_goals=True):
    """Plain version of K3: a wrapped gather, then the exit projection."""
    b, h, w = board.shape
    a = cy.shape[1]
    vh, vw = view_shape
    dev = board.device
    packed = packed_board(board, goals, remove_white_goals).reshape(b, h * w)
    rows = ((cy - vh // 2)[..., None]
            + torch.arange(vh, device=dev, dtype=cy.dtype)) % h   # [B,A,vh]
    cols = ((cx - vw // 2)[..., None]
            + torch.arange(vw, device=dev, dtype=cx.dtype)) % w   # [B,A,vw]
    idx = (rows[..., :, None] * w + cols[..., None, :]).long()
    views = packed[:, None, :].expand(b, a, h * w).gather(
        2, idx.reshape(b, a, vh * vw)).reshape(b, a, vh, vw)

    vy = torch.arange(vh, device=dev)[:, None]
    vx = torch.arange(vw, device=dev)
    for e in range(exit_locs.shape[1]):
        ey, ex = exit_locs[:, e, 0], exit_locs[:, e, 1]              # [B]
        val = packed.gather(1, (ey * w + ex).long()[:, None])        # [B,1]
        jy = (ey[:, None] - cy + h // 2) % h - h // 2
        jx = (ex[:, None] - cx + w // 2) % w - w // 2
        jy = torch.clamp(jy + vh // 2, 0, vh - 1)                    # [B,A]
        jx = torch.clamp(jx + vw // 2, 0, vw - 1)
        hit = ((vy == jy[..., None, None]) & (vx == jx[..., None, None])
               & exit_valid[:, e, None, None, None])         # [B,A,vh,vw]
        views = torch.where(hit, val[:, :, None, None], views)
    return views


def recenter_views(board, goals, cy, cx, exit_locs, exit_valid, *,
                   view_shape, remove_white_goals=True):
    """Batched packed observation views.

    board, goals int32[B, H, W]; cy, cx int32[B, A] (view centres);
    exit_locs int32[B, E, 2]; exit_valid bool[B, E]; view_shape (vh, vw)
    with vh <= H and vw <= W. Returns int32[B, A, vh, vw].
    """
    b, h, w = board.shape
    vh, vw = view_shape
    if vh > h or vw > w:
        raise ValueError("recenter_views: view %dx%d larger than the %dx%d "
                         "board" % (vh, vw, h, w))
    dev = board.device
    if dev.type == "cpu":
        return recenter_views_plain(board, goals, cy, cx, exit_locs,
                                    exit_valid, view_shape=view_shape,
                                    remove_white_goals=remove_white_goals)
    if dev.type != "cuda":
        raise ValueError("recenter_views: unsupported device %s" % dev)
    a = cy.shape[1]
    e = exit_locs.shape[1]
    _require("board", board, torch.int32, (b, h, w), dev)
    _require("goals", goals, torch.int32, (b, h, w), dev)
    _require("cy", cy, torch.int32, (b, a), dev)
    _require("cx", cx, torch.int32, (b, a), dev)
    _require("exit_locs", exit_locs, torch.int32, (b, e, 2), dev)
    _require("exit_valid", exit_valid, torch.bool, (b, e), dev)
    out = torch.empty((b, a, vh, vw), dtype=torch.int32, device=dev)
    _build.launch("sl_recenter_views", dev, board.data_ptr(),
                  goals.data_ptr(), cy.data_ptr(), cx.data_ptr(),
                  exit_locs.data_ptr(), exit_valid.data_ptr(),
                  out.data_ptr(), b, a, h, w, vh, vw, e,
                  int(bool(remove_white_goals)))
    recenter_views.launches += 1
    return out


recenter_views.launches = 0
