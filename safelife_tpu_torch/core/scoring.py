"""Goal scoring, point accounting and exit machinery on batched tensors.

Port of ``safelife_tpu/core/scoring.py``: ``DEFAULT_POINTS_TABLE``
(``:21-31``), ``alive_counts`` (``:36-54``), ``flatten_points_table``
(``:57-60``), ``points_base`` (``:74-90``), ``agent_cells`` (``:156-168``),
``has_exited`` (``:171-174``), ``initial_available_points``
(``:207-220``), ``required_points`` (``:223-226``),
``initial_colors_from_board`` (``:244-255``) and ``update_exit_colors``
(``:267-300``). The one-hot forms there were TPU workarounds for gathers;
here they are plain gathers and scatters with the same results. The packed
static-goal rows (``:98-153``) are not ported: ``points_base`` gives the
same points.

Parity targets in the reference: the C census kernel
(``speedups_src/advance_board.c:192-207``) and ``GameWithGoals``
(``safelife_game.py:575-735``).
"""

import numpy as np
import torch

from . import cells as C

#: Default points table: rows = goal color, cols = cell color (KRGYBMCW)
#: + empty.
#: Parity: reference ``safelife_game.py:595-605``.
DEFAULT_POINTS_TABLE = np.array([
    # k   r   g   y   b   m   c   w  empty
    [+0, -1, +0, +0, +0, +0, +0, +0, 0],  # black / no goal
    [-3, +3, -3, +0, -3, +0, -3, -3, 0],  # red goal
    [+0, -3, +5, +0, +0, +0, +3, +0, 0],  # green goal
    [-3, +0, +0, +3, +0, +0, +0, +0, 0],  # yellow goal
    [+3, -3, +3, +0, +5, +3, +3, +3, 0],  # blue goal
    [-3, +3, -3, +0, -3, +5, -3, -3, 0],  # magenta goal
    [+3, -3, +3, +0, +3, +0, +5, +3, 0],  # cyan goal
    [+0, -1, +0, +0, +0, +0, +0, +0, 0],  # white / rainbow goal
], dtype=np.int32)

POINTS_ON_LEVEL_EXIT = 1.0

_MOVABLE = C.DESTRUCTIBLE | C.PUSHABLE | C.PULLABLE


def cell_points_index(board, goals):
    """Per-cell flat index ``goal_color * 9 + (cell_color if alive else 8)``
    into the 72-entry points lookup, and the inclusion mask (movable or not
    frozen: the cells an agent could alter)."""
    include = ((board & _MOVABLE) != 0) | ((board & C.FROZEN) == 0)
    alive = (board & C.ALIVE) != 0
    bc = (board >> C.COLOR_BIT) & 7
    gc = (goals >> C.COLOR_BIT) & 7
    return torch.where(alive, gc * 9 + bc, gc * 9 + 8), include


def alive_counts(board, goals):
    """(goal color x cell color-or-empty) census of changeable cells.
    board/goals int32[..., H, W] → int32[..., 8, 9]."""
    idx, include = cell_points_index(board, goals)
    lead = board.shape[:-2]
    idx = idx.reshape(-1, idx.shape[-2] * idx.shape[-1]).long()
    inc = include.reshape(idx.shape).to(torch.int32)
    counts = torch.zeros((idx.shape[0], 72), dtype=torch.int32,
                         device=board.device)
    counts.scatter_add_(1, idx, inc)
    return counts.reshape(lead + (8, 9))


def flatten_points_table(points_table):
    """(..., A, 8, 9) points table → (..., A, 72) flat lookup."""
    return points_table.reshape(points_table.shape[:-2] + (72,))


def points_base(board, goals, table_flat):
    """Σ points_table ⊙ alive_counts per agent, as a gather of each cell's
    table entry summed under the inclusion mask.

    board/goals int32[B, H, W]; table_flat int32[B, A, 72] → int32[B, A].
    """
    b = board.shape[0]
    a = table_flat.shape[1]
    idx, include = cell_points_index(board, goals)
    idx = idx.reshape(b, 1, -1).expand(b, a, idx[0].numel()).long()
    vals = table_flat.gather(2, idx)
    vals = vals * include.reshape(b, 1, -1).to(torch.int32)
    return vals.sum(-1, dtype=torch.int32)


def _flat_index(board, agent_locs):
    return (agent_locs[..., 0] * board.shape[-1] + agent_locs[..., 1]).long()


def agent_cells(board, agent_locs):
    """Board values at each (padded) agent location; 0 for a location off
    the board, as the one-hot form gives. board int32[B, H, W]; agent_locs
    int32[B, A, 2] → int32[B, A]."""
    b = board.shape[0]
    flat = board.reshape(b, -1)
    idx = _flat_index(board, agent_locs)
    inside = (idx >= 0) & (idx < flat.shape[1])
    cells = flat.gather(1, idx.clamp(0, flat.shape[1] - 1))
    return torch.where(inside, cells, torch.zeros_like(cells))


def has_exited(board, agent_locs):
    """True per agent iff its recorded cell carries EXIT but not AGENT."""
    cell = agent_cells(board, agent_locs)
    return (cell & (C.AGENT | C.EXIT)) == C.EXIT


def initial_available_points(initial_counts, initial_colors, points_table):
    """Max achievable points per agent assuming every goal can be filled.

    initial_counts int32[..., 8, 9]; initial_colors bool[..., 9];
    points_table int32[..., A, 8, 9] → float32[..., A].
    Parity: reference ``safelife_game.py:696-709``.
    """
    goal_counts = initial_counts.sum(-1, dtype=torch.int32)        # [..., 8]
    gated = points_table * initial_colors[..., None, None, :].to(torch.int32)
    max_points = gated.amax(-1)                             # [..., A, 8]
    total = (max_points * goal_counts[..., None, :]).sum(
        -1, dtype=torch.int32)
    init_pts = (points_table * initial_counts[..., None, :, :]).sum(
        (-1, -2), dtype=torch.int32)
    return (total - init_pts).to(torch.float32)


def required_points(min_performance, available):
    """Points needed before the exit opens. min_performance float32[...]."""
    req = min_performance[..., None] * available
    return torch.clamp(torch.ceil(req), min=0).to(torch.int32)


def initial_colors_from_board(board):
    """bool[..., 9]: colors of all generator cells (agent/alive/spawning),
    plus the 'empty' pseudo-color. Parity: ``safelife_game.py:665-675``."""
    generators = C.AGENT | C.ALIVE | C.SPAWNING
    is_gen = (board & generators) != 0
    color = (board >> C.COLOR_BIT) & 7
    arange = torch.arange(8, device=board.device)
    present = (is_gen[..., None] & (color[..., None] == arange)).any(
        -2).any(-2)
    return torch.cat(
        [present, torch.ones(present.shape[:-1] + (1,), dtype=torch.bool,
                             device=board.device)], -1)


def update_exit_colors(board, agent_locs, agent_mask, exit_mask,
                       can_exit_now, cells=None):
    """Recolor exits and set/clear the EXIT bit on agents allowed to leave.

    Parity: ``update_exit_colors`` (safelife_game.py:537-552). Agent-cell
    writes happen first, in agent order, so among agents sharing a cell the
    last write wins; padded agents write nothing; then every exit cell is
    rewritten. ``cells`` may supply ``agent_cells(board, agent_locs)``.
    board int32[B, H, W] → int32[B, H, W].
    """
    b = board.shape[0]
    if cells is None:
        cells = agent_cells(board, agent_locs)
    new_cells = (cells & ~C.EXIT) | can_exit_now.to(torch.int32) * C.EXIT
    idx = _flat_index(board, agent_locs)
    flat = board.reshape(b, -1).clone()
    for k in range(agent_locs.shape[-2]):
        ik = idx[:, k:k + 1]
        cur = flat.gather(1, ik)
        val = torch.where(agent_mask[:, k:k + 1], new_cells[:, k:k + 1], cur)
        flat.scatter_(1, ik, val)
    board = flat.reshape(board.shape)

    any_exit = (can_exit_now & agent_mask).any(-1)
    exit_type = torch.where(
        any_exit, torch.full_like(any_exit, C.LEVEL_EXIT | C.COLOR_R,
                                  dtype=torch.int32),
        torch.full_like(any_exit, C.LEVEL_EXIT, dtype=torch.int32))
    return torch.where(exit_mask, exit_type[:, None, None], board)
