"""ANSI text rendering and cell names, as side-effect dictionaries key them
(``life-green``, ``spawner-yellow``, ``crate-gray``).

Port of ``safelife_tpu/render/text.py:1-127`` (reference
``safelife/render_text.py``): the colour, name and glyph tables,
``cell_name``, ``name_to_cell``, ``render_cell``, ``render_board``,
``_plain_glyph`` and ``render_game``: 256-colour terminal output with the
goal colour as background and the cell colour as foreground.

The renderers take NumPy arrays or torch tensors; a tensor is copied to the
host first.
"""

import numpy as np

from ..core import cells as C

BACKGROUND_COLORS = [251, 217, 114, 229, 117, 183, 123, 255]
FOREGROUND_COLORS = [0, 1, 2, 172, 12, 129, 39, 244]

CELLTYPE_NAMES = {
    C.EMPTY: 'empty',
    C.LIFE: 'life',
    C.ALIVE: 'hard-life',
    C.WALL: 'wall',
    C.CRATE: 'crate',
    C.PLANT: 'plant',
    C.TREE: 'tree',
    C.ICE_CUBE: 'ice-cube',
    C.PARASITE: 'parasite',
    C.WEED: 'weed',
    C.SPAWNER: 'spawner',
    C.HARD_SPAWNER: 'hard-spawner',
    C.LEVEL_EXIT: 'exit',
    C.FOUNTAIN: 'fountain',
}

COLOR_NAMES = {
    0: 'gray',
    C.COLOR_R: 'red',
    C.COLOR_G: 'green',
    C.COLOR_B: 'blue',
    C.COLOR_R | C.COLOR_B: 'magenta',
    C.COLOR_G | C.COLOR_R: 'yellow',
    C.COLOR_B | C.COLOR_G: 'cyan',
    C.RAINBOW_COLOR: 'white',
}

GLYPHS = {
    C.EMPTY: ' ',
    C.LIFE: 'z',
    C.ALIVE: 'Z',
    C.WALL: '#',
    C.CRATE: '%',
    C.PLANT: '&',
    C.TREE: 'T',
    C.ICE_CUBE: '=',
    C.PARASITE: '!',
    C.WEED: '@',
    C.SPAWNER: 's',
    C.HARD_SPAWNER: 'S',
    C.LEVEL_EXIT: 'X',
    C.FOUNTAIN: '+',
}

_INV_CELLTYPE = {v: k for k, v in CELLTYPE_NAMES.items()}
_INV_COLOR = {v: k for k, v in COLOR_NAMES.items()}
AGENT_ARROWS = '⋀>⋁<'


def cell_name(cell):
    """Human name for a cell value, e.g. ``life-green``."""
    cell = int(cell)
    base = cell & ~C.RAINBOW_COLOR
    kind = CELLTYPE_NAMES.get(base, 'agent' if cell & C.AGENT else 'unknown')
    color = COLOR_NAMES.get(cell & C.RAINBOW_COLOR, 'x')
    return kind + '-' + color


def name_to_cell(name):
    """The cell value of a name that :func:`cell_name` gives."""
    kind, _, color = name.rpartition('-')
    return _INV_CELLTYPE.get(kind, 0) | _INV_COLOR.get(color, 0)


def host_array(x):
    """A NumPy array of ``x``; a torch tensor is copied to the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def render_cell(cell, goal=0):
    """One ANSI-colored character for a cell over its goal."""
    cell = int(cell)
    goal = int(goal)
    cc = (cell & C.RAINBOW_COLOR) >> C.COLOR_BIT
    gc = (goal & C.RAINBOW_COLOR) >> C.COLOR_BIT
    out = '\x1b[48;5;%dm\x1b[38;5;%dm' % (
        BACKGROUND_COLORS[gc], FOREGROUND_COLORS[cc])
    base = cell & ~C.RAINBOW_COLOR
    if base & C.AGENT:
        out += '\x1b[1m' + AGENT_ARROWS[(base >> C.ORIENTATION_BIT) & 3]
    elif base == C.EMPTY and cc:
        out += '.'
    elif base == C.FOUNTAIN:
        out += '\x1b[1m+'
    else:
        out += GLYPHS.get(base & ~C.ORIENTATION_MASK, '?')
    return out + '\x1b[0m'


def render_board(board, goals=None, ansi=True):
    """Render a whole board to a string."""
    board = host_array(board)
    goals = np.zeros_like(board) if goals is None else host_array(goals)
    lines = []
    for brow, grow in zip(board, goals):
        if ansi:
            lines.append(''.join(
                render_cell(b, g) for b, g in zip(brow, grow)))
        else:
            lines.append(''.join(_plain_glyph(b) for b in brow))
    return '\n'.join(lines) + '\n'


def _plain_glyph(cell):
    cell = int(cell)
    base = cell & ~C.RAINBOW_COLOR
    if base & C.AGENT:
        return 'A'
    return GLYPHS.get(base & ~C.ORIENTATION_MASK, '?')


def render_game(game_or_state, view_size=None, ansi=True):
    """Render a host game, a level, one lane's state or a board."""
    board = getattr(game_or_state, 'board', game_or_state)
    goals = getattr(game_or_state, 'goals', None)
    return render_board(board, goals, ansi=ansi)
