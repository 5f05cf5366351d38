"""Agent action execution on batched int32 boards.

Port of ``safelife_tpu/core/actions.py:34-246`` (``_read``, ``_cond_write``,
``_agent_positions``, ``_execute_one_fast``, ``execute_actions`` with its
``agent_body``), written over a batch of boards instead of under ``vmap``.
It is the plain version of the actions phase of the K1 kernel
(``ops/csrc/physics.cu``).

Semantics (reference ``advance_board.c:217-300``): 0 = noop, 1-4 = move
up/right/down/left, 5-8 = toggle in the same directions. Agents act
**sequentially** in index order — agent k sees agent k-1's writes — so the
loop over agents is never parallelised; each step of it is vectorised over
the boards. Every action first re-orients the agent.

The fast path needs ``min(H, W) >= 4`` so that the four touched cells
(agent, ahead, two ahead, behind) are distinct and one action is a pure
function of the four cells' initial values. Smaller boards take the
aliasing path, which reads and writes the cells one at a time in the C
kernel's order, so that a write to a cell that is also another of the four
is seen by the later reads.
"""

import torch

from . import cells as C

_NOT_ORIENTATION = ~C.ORIENTATION_MASK  # a negative int32 mask


def _execute_one(flat, locs_k, action, h, w):
    """One agent's action on every board. flat int32[B, H*W], locs_k
    int32[B, 2], action int32[B] → (flat, locs_k)."""
    dirn = (action - 1) & 3
    odd = (dirn & 1) == 1
    zero = torch.zeros_like(action)
    dx = torch.where(odd, 2 - dirn, zero)
    dy = torch.where(odd, zero, dirn - 1)
    y0 = locs_k[:, 0] % h
    x0 = locs_k[:, 1] % w
    ys = torch.stack([y0, (y0 + dy) % h, (y0 + 2 * dy) % h, (y0 - dy) % h], 1)
    xs = torch.stack([x0, (x0 + dx) % w, (x0 + 2 * dx) % w, (x0 - dx) % w], 1)
    idx = (ys * w + xs).long()                              # [B, 4]
    v = flat.gather(1, idx)
    v0, v1, v2, v3 = v.unbind(1)

    active = (action != 0) & ((v0 & C.AGENT) != 0)
    v0o = torch.where(
        active, (v0 & _NOT_ORIENTATION) | (dirn << C.ORIENTATION_BIT), v0)
    is_toggle = action >= 5

    # ---- toggle branch ----
    t_create = v1 == 0
    t_destr = ~t_create & ((v1 & C.DESTRUCTIBLE) != 0)
    t_destr_agent = t_destr & ((v1 & C.AGENT) != 0)
    t_shove = ~t_create & ~t_destr & ((~v0o & v1 & C.PUSHABLE) != 0)
    shove_empty = t_shove & (v2 == 0)
    shove_exit = t_shove & (v2 != 0) & ((v2 & C.EXIT) != 0)
    tog_v1 = torch.where(
        t_create, C.ALIVE | C.DESTRUCTIBLE | (v0o & C.COLORS),
        torch.where(
            t_destr_agent, (v1 ^ (C.AGENT | C.DESTRUCTIBLE)) | C.FROZEN,
            torch.where(t_destr | shove_empty | shove_exit, zero, v1)))
    tog_v2 = torch.where(shove_empty, v1, v2)

    # ---- move branch ----
    m_push = (~v0o & v1 & C.PUSHABLE) != 0
    m_push_empty = m_push & (v2 == 0)
    m_push_exit = m_push & (v2 != 0) & ((v2 & C.EXIT) != 0)
    m_empty = ~m_push & (v1 == 0)
    m_exit = ~m_push & ~m_empty & ((v0o & v1 & C.EXIT) != 0) \
        & ((v1 & C.AGENT) == 0)
    do_move = m_push_empty | m_push_exit | m_empty
    do_reloc = do_move | m_exit
    pull = do_reloc & ((~v0o & v3 & C.PULLABLE) != 0)
    mov_v0 = torch.where(do_reloc, torch.where(pull, v3, zero), v0o)
    mov_v1 = torch.where(do_move, v0o, v1)
    mov_v2 = torch.where(m_push_empty, v1, v2)
    mov_v3 = torch.where(pull, zero, v3)

    n0 = torch.where(is_toggle, v0o, mov_v0)
    n1 = torch.where(is_toggle, tog_v1, mov_v1)
    n2 = torch.where(is_toggle, tog_v2, mov_v2)
    n3 = torch.where(is_toggle, v3, mov_v3)
    new = torch.where(active[:, None], torch.stack([n0, n1, n2, n3], 1), v)
    # The four indices are distinct, so one scatter equals four writes.
    flat = flat.scatter(1, idx, new)

    relocated = active & ~is_toggle & do_reloc
    new_loc = torch.stack([(y0 + dy) % h, (x0 + dx) % w], 1)
    locs_k = torch.where(relocated[:, None], new_loc, locs_k)
    return flat, locs_k


def _read(flat, idx):
    return flat.gather(1, idx[:, None])[:, 0]


def _cond_write(flat, idx, value, cond):
    """Write ``value`` at flat index ``idx`` of each board where ``cond``."""
    cur = _read(flat, idx)
    return flat.scatter(1, idx[:, None], torch.where(cond, value, cur)[:, None])


def _execute_one_aliased(flat, locs_k, action, h, w):
    """One agent's action on every board, for any board size: the
    reference's ``agent_body`` (``safelife_tpu/core/actions.py:163-242``),
    each read and conditional write in its order. flat int32[B, H*W],
    locs_k int32[B, 2], action int32[B] → (flat, locs_k)."""
    dirn = (action - 1) & 3
    odd = (dirn & 1) == 1
    zero = torch.zeros_like(action)
    dx = torch.where(odd, 2 - dirn, zero)
    dy = torch.where(odd, zero, dirn - 1)
    y0 = locs_k[:, 0] % h
    x0 = locs_k[:, 1] % w
    p0 = (y0 * w + x0).long()
    p1 = (((y0 + dy) % h) * w + (x0 + dx) % w).long()
    p2 = (((y0 + 2 * dy) % h) * w + (x0 + 2 * dx) % w).long()
    p3 = (((y0 - dy) % h) * w + (x0 - dx) % w).long()

    v0 = _read(flat, p0)
    active = (action != 0) & ((v0 & C.AGENT) != 0)
    is_toggle = action >= 5
    is_move = active & ~is_toggle
    do_toggle = active & is_toggle

    v0 = torch.where(
        active, (v0 & _NOT_ORIENTATION) | (dirn << C.ORIENTATION_BIT), v0)
    flat = _cond_write(flat, p0, v0, active)

    # ---- toggle branch ----
    v1 = _read(flat, p1)
    t_create = do_toggle & (v1 == 0)
    t_destr = do_toggle & ~t_create & ((v1 & C.DESTRUCTIBLE) != 0)
    t_destr_agent = t_destr & ((v1 & C.AGENT) != 0)
    t_shove = do_toggle & ~t_create & ~t_destr \
        & ((~v0 & v1 & C.PUSHABLE) != 0)
    new_v1 = torch.where(
        t_create, C.ALIVE | C.DESTRUCTIBLE | (v0 & C.COLORS),
        torch.where(t_destr_agent,
                    (v1 ^ (C.AGENT | C.DESTRUCTIBLE)) | C.FROZEN,
                    torch.where(t_destr, zero, v1)))
    flat = _cond_write(flat, p1, new_v1, t_create | t_destr)
    v2 = _read(flat, p2)
    shove_to_empty = t_shove & (v2 == 0)
    shove_to_exit = t_shove & (v2 != 0) & ((v2 & C.EXIT) != 0)
    flat = _cond_write(flat, p2, v1, shove_to_empty)
    flat = _cond_write(flat, p1, zero, shove_to_empty | shove_to_exit)

    # ---- move branch ----
    v1 = _read(flat, p1)
    v2 = _read(flat, p2)
    m_push = is_move & ((~v0 & v1 & C.PUSHABLE) != 0)
    m_push_empty = m_push & (v2 == 0)
    m_push_exit = m_push & (v2 != 0) & ((v2 & C.EXIT) != 0)
    m_empty = is_move & ~m_push & (v1 == 0)
    m_exit = is_move & ~m_push & ~m_empty & ((v0 & v1 & C.EXIT) != 0) \
        & ((v1 & C.AGENT) == 0)
    do_move = m_push_empty | m_push_exit | m_empty
    do_reloc = do_move | m_exit
    flat = _cond_write(flat, p2, v1, m_push_empty)
    # Re-read p0: on tiny boards the writes above may alias it.
    v0f = _read(flat, p0)
    flat = _cond_write(flat, p1, v0f, do_move)
    v3 = _read(flat, p3)
    pull = do_reloc & ((~v0f & v3 & C.PULLABLE) != 0)
    flat = _cond_write(flat, p0, torch.where(pull, v3, zero), do_reloc)
    flat = _cond_write(flat, p3, zero, pull)

    new_loc = torch.stack([(y0 + dy) % h, (x0 + dx) % w], 1)
    locs_k = torch.where(do_reloc[:, None], new_loc, locs_k)
    return flat, locs_k


def execute_actions(board, agent_locs, actions):
    """Apply one action per agent, agents in index order, on every board.

    board int32[B, H, W]; agent_locs int32[B, A, 2] (row, col; padding rows
    are fine when their action is 0); actions int32[B, A] in [0, 8].
    Returns (board, agent_locs).
    """
    b, h, w = board.shape
    one = _execute_one if min(h, w) >= 4 else _execute_one_aliased
    flat = board.reshape(b, h * w)
    new_locs = []
    for k in range(agent_locs.shape[1]):
        flat, lk = one(flat, agent_locs[:, k], actions[:, k], h, w)
        new_locs.append(lk)
    if not new_locs:
        return board, agent_locs
    return flat.reshape(b, h, w), torch.stack(new_locs, 1)
