"""Cell names, as side-effect dictionaries key them (``life-green``,
``spawner-yellow``, ``crate-gray``).

Port of ``safelife_tpu/render/text.py:16-78``: the name tables,
``cell_name`` and ``name_to_cell`` (reference ``safelife/render_text.py``).
The glyph tables and ANSI renderers are not ported yet.
"""

from ..core import cells as C

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

_INV_CELLTYPE = {v: k for k, v in CELLTYPE_NAMES.items()}
_INV_COLOR = {v: k for k, v in COLOR_NAMES.items()}


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
