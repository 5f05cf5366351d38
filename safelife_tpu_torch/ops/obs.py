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

Views larger than the board tile it, as the JAX package's XLA path
(``safelife_tpu/env/env.py:168-173``, ``get_obs_batch``) does.

The wrapper launches a kernel for CUDA tensors and runs
:func:`recenter_views_plain` for CPU tensors. On CUDA,
:func:`view_launch_shape` picks the staged form (a block gathers the views
of a few lanes out of shared memory) or, for lanes too large to stage, the
global-memory form. :mod:`._build` counts the launches of each.
"""

import functools

import torch

from ..core import cells as C
from . import _build
from .physics import MAX_SMEM_BYTES, _require

#: View elements (or board cells) a thread of the staged form takes, which
#: sizes its block.
ELEMENTS_PER_THREAD = 8
#: Lanes a staged block may take, and the fewest blocks a batch should
#: give: about two to each of the H100's 132 SMs. Both are the best of the
#: layout sweep at B = 512 and 4096 (``chip_sweep.py views``, PERF.md,
#: PR 3).
LANES_PER_BLOCK = (1, 2, 4, 8, 16)
_TARGET_BLOCKS = 256
#: Threads a block of the global-memory form.
GLOBAL_THREADS = 256
_INT32_MAX = 2 ** 31 - 1


def view_smem_bytes(lanes, a, h, w, vh, vw):
    """Shared bytes of a staged K3 block of ``lanes`` lanes: the boards
    (padded to 16 bytes), the goals, and a row-offset and a column table a
    view (``csrc/obs.cu::view_smem_words``)."""
    cells = lanes * h * w
    return 4 * (-(-cells // 4) * 4 + cells + lanes * a * (vh + vw))


def view_block_threads(lanes, a, h, w, vh, vw,
                       per_thread=ELEMENTS_PER_THREAD):
    """Threads of a staged K3 block: one for each ``per_thread`` view
    elements or board cells, whichever are more, in whole warps, 32 to
    1024."""
    work = lanes * max(a * vh * vw, h * w)
    warps = -(-work // (32 * per_thread))
    return 32 * min(32, max(1, warps))


@functools.lru_cache(maxsize=64)
def view_launch_shape(batch, a, h, w, vh, vw):
    """(lanes_per_block, threads, shared bytes) of a K3 launch.

    ``lanes_per_block`` 0 selects the global-memory form: one lane's board,
    goals and tables do not fit the card's shared memory. Otherwise the
    count is the largest of ``LANES_PER_BLOCK`` that leaves at least
    ``_TARGET_BLOCKS`` blocks and fits the shared memory (above 48 KB the
    kernel opts in), never more than the batch holds: 16 lanes a block at
    26x26 and B = 4096, 2 at B = 512.
    """
    if view_smem_bytes(1, a, h, w, vh, vw) > MAX_SMEM_BYTES:
        return 0, GLOBAL_THREADS, 0
    best = 1
    for n in LANES_PER_BLOCK[1:]:
        if n > batch or -(-batch // n) < _TARGET_BLOCKS or \
                view_smem_bytes(n, a, h, w, vh, vw) > MAX_SMEM_BYTES:
            break
        best = n
    return (best, view_block_threads(best, a, h, w, vh, vw),
            view_smem_bytes(best, a, h, w, vh, vw))


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
    exit_locs int32[B, E, 2]; exit_valid bool[B, E]; view_shape (vh, vw),
    of any size (views larger than the board tile it). Returns
    int32[B, A, vh, vw].
    """
    b, h, w = board.shape
    vh, vw = view_shape
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
    if b * a * vh * vw > _INT32_MAX:
        raise ValueError("recenter_views: %d x %d views of %dx%d exceed "
                         "32-bit indexing" % (b, a, vh, vw))
    out = torch.empty((b, a, vh, vw), dtype=torch.int32, device=dev)
    args = (board.data_ptr(), goals.data_ptr(), cy.data_ptr(), cx.data_ptr(),
            exit_locs.data_ptr(), exit_valid.data_ptr(), out.data_ptr(),
            b, a, h, w, vh, vw, e)
    lanes, threads, _ = view_launch_shape(b, a, h, w, vh, vw)
    if lanes:
        _build.launch("sl_recenter_views", dev, *args, lanes, threads,
                      int(bool(remove_white_goals)))
    else:
        _build.launch("sl_recenter_views_global", dev, *args, threads,
                      int(bool(remove_white_goals)))
    return out
