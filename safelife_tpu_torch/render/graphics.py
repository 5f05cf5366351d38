"""RGB sprite rendering of boards, level files and movies.

Port of ``safelife_tpu/render/graphics.py:1-261`` (reference
``safelife/render_graphics.py``): the colour tables and the procedurally
generated 14x14 sprites (``:18-144``, copied: no binary assets),
``_sprite_index``, ``render_board``, ``render_game``, ``render_mov``,
``render_file`` and ``_write_movie``. Every cell is drawn as its sprite,
tinted by the cell's colour and composited over the goal colour.

The compositing depends only on (sprite, cell colour, goal colour), so it
is done once, at import, in JAX's float64 arithmetic into a uint8 table of
tiles; ``render_board`` gathers a tile a cell. The frames are byte for byte
JAX's, and a torch tensor renders on its own device (a recorded history on
the card renders there). ``imageio`` is imported only by the functions
that write files.
"""

import numpy as np
import torch

from ..core import cells as C
from .text import host_array

SPRITE_SIZE = 14

# Foreground colors per 3-bit cell color (KRGYBMCW), 0..1 RGB.
FG_COLORS = np.array([
    [0.25, 0.25, 0.25],   # black/gray
    [0.80, 0.15, 0.15],   # red
    [0.15, 0.65, 0.15],   # green
    [0.75, 0.65, 0.10],   # yellow
    [0.15, 0.30, 0.80],   # blue
    [0.65, 0.20, 0.70],   # magenta
    [0.10, 0.65, 0.65],   # cyan
    [0.90, 0.90, 0.90],   # white
])

# Background (goal) tints per 3-bit goal color.
BG_COLORS = np.array([
    [0.76, 0.76, 0.76],   # no goal: light gray
    [0.94, 0.70, 0.70],   # red
    [0.70, 0.90, 0.70],   # green
    [0.95, 0.93, 0.65],   # yellow
    [0.70, 0.80, 0.95],   # blue
    [0.90, 0.72, 0.92],   # magenta
    [0.68, 0.92, 0.92],   # cyan
    [0.97, 0.97, 0.97],   # white
])


def _grid():
    y, x = np.mgrid[0:SPRITE_SIZE, 0:SPRITE_SIZE]
    c = (SPRITE_SIZE - 1) / 2
    return (y - c), (x - c)


def _circle(r, ring=None):
    y, x = _grid()
    d = np.sqrt(x * x + y * y)
    if ring:
        return ((d <= r) & (d >= ring)).astype(float)
    return (d <= r).astype(float)


def _square(half, hollow=None):
    y, x = _grid()
    m = (np.abs(x) <= half) & (np.abs(y) <= half)
    if hollow:
        m &= ~((np.abs(x) <= hollow) & (np.abs(y) <= hollow))
    return m.astype(float)


def _plus(half, width=1.6):
    y, x = _grid()
    return (((np.abs(x) <= width) & (np.abs(y) <= half))
            | ((np.abs(y) <= width) & (np.abs(x) <= half))).astype(float)


def _diamond(half):
    y, x = _grid()
    return (np.abs(x) + np.abs(y) <= half).astype(float)


def _triangle(half):
    y, x = _grid()
    return ((y >= -half) & (y <= half)
            & (np.abs(x) <= (y + half) * 0.6)).astype(float)


def _arrow(direction):
    """Agent arrow; 0=up, 1=right, 2=down, 3=left."""
    y, x = _grid()
    body = (np.abs(x) <= 1.5) & (np.abs(y) <= 4.5)
    head = (y <= -1) & (y >= -5.5) & (np.abs(x) <= (-y) * 0.9 - 0.5)
    m = (body & (y >= -1)) | head
    m = m.astype(float)
    return np.rot90(m, -direction)


def _cross(half):
    y, x = _grid()
    return ((np.abs(np.abs(x) - np.abs(y)) <= 1.2)
            & (np.abs(x) <= half)).astype(float)


def _dots():
    y, x = _grid()
    m = np.zeros((SPRITE_SIZE, SPRITE_SIZE))
    for dy in (-3.5, 0, 3.5):
        for dx in (-3.5, 0, 3.5):
            if dy == 0 and dx == 0:
                continue
            m += ((x - dx) ** 2 + (y - dy) ** 2 <= 2.4).astype(float)
    return np.clip(m, 0, 1)


def _build_sprites():
    """Map from the cell's structural value to an alpha mask."""
    sprites = {
        C.EMPTY: np.zeros((SPRITE_SIZE, SPRITE_SIZE)),
        C.LIFE: _circle(4.2),
        C.ALIVE: _circle(5.2, ring=2.4) + _circle(1.8),
        C.WALL: _square(5.8),
        C.CRATE: np.clip(_square(5.8, hollow=4.4) + _cross(4.4), 0, 1),
        C.PLANT: _triangle(4.8),
        C.TREE: np.clip(_circle(4.0) + _square(1.2) * 0.9, 0, 1),
        C.ICE_CUBE: _square(5.4, hollow=3.4) + _square(3.4) * 0.45,
        C.PARASITE: _diamond(5.0),
        C.WEED: np.clip(_plus(5.0) + _cross(5.0), 0, 1),
        C.SPAWNER: _dots(),
        C.HARD_SPAWNER: np.clip(_dots() + _circle(2.2), 0, 1),
        C.LEVEL_EXIT: _square(6.0, hollow=3.2),
        C.FOUNTAIN: _plus(5.2),
    }
    # colored empty cell: a faint dot marking the goal
    dot = _circle(1.4) * 0.5
    table = {}
    for base, mask in sprites.items():
        table[base] = np.clip(mask, 0, 1)
    table["empty_colored"] = dot
    for d in range(4):
        table["agent%d" % d] = _arrow(d)
    return table


_SPRITES = _build_sprites()
_SPRITE_KEYS = list(_SPRITES.keys())
_SPRITE_STACK = np.stack([_SPRITES[k] for k in _SPRITE_KEYS])
_KEY_INDEX = {k: i for i, k in enumerate(_SPRITE_KEYS)}


def _tiles():
    """uint8 [sprites * 64, s, s, 3]: tile ``(sprite * 8 + fg) * 8 + bg``,
    composited as ``safelife_tpu/render/graphics.py:188-196`` does."""
    fg = FG_COLORS[None, :, None, None, None, :]
    bg = BG_COLORS[None, None, :, None, None, :]
    alpha = _SPRITE_STACK[:, None, None, :, :, None]
    out = fg * alpha + bg * (1 - alpha)
    out = (np.clip(out, 0, 1) * 255).astype(np.uint8)
    return out.reshape((-1, SPRITE_SIZE, SPRITE_SIZE, 3))


_TILES = _tiles()


def _sprite_index(cells):
    """Cell value -> sprite index, for a NumPy array or a torch tensor."""
    where = torch.where if isinstance(cells, torch.Tensor) else np.where
    base = cells & ~(C.RAINBOW_COLOR | C.ORIENTATION_MASK)
    # Unknown structures fall back to the generic life circle.
    idx = where(base != 0, _KEY_INDEX[C.LIFE], _KEY_INDEX[C.EMPTY])
    for val in _SPRITES:
        if isinstance(val, int):
            idx = where(base == val, _KEY_INDEX[val], idx)
    colored_empty = (base == 0) & ((cells & C.RAINBOW_COLOR) != 0)
    idx = where(colored_empty, _KEY_INDEX["empty_colored"], idx)
    # Agents override by orientation.
    agent = (cells & C.AGENT) != 0
    for d in range(4):
        m = agent & (((cells >> C.ORIENTATION_BIT) & 3) == d)
        idx = where(m, _KEY_INDEX["agent%d" % d], idx)
    return idx


def render_board(board, goals=None):
    """Render a board (or a batch of boards) to uint8 RGB.

    board: (..., H, W) ints -> (..., H*14, W*14, 3) uint8; a NumPy array
    for NumPy input, a tensor on the board's device for a torch tensor.
    """
    if isinstance(board, torch.Tensor):
        goals = torch.zeros_like(board) if goals is None else goals
        tiles = torch.from_numpy(_TILES).to(board.device)
    else:
        board = np.asarray(board)
        goals = np.zeros_like(board) if goals is None else np.asarray(goals)
        tiles = _TILES
    tile = (_sprite_index(board) * 8 + ((board >> C.COLOR_BIT) & 7)) * 8 \
        + ((goals >> C.COLOR_BIT) & 7)
    out = tiles[tile]                     # (..., H, W, s, s, 3)
    shape = tuple(board.shape)
    h, w = shape[-2], shape[-1]
    if isinstance(out, torch.Tensor):
        out = out.movedim(-3, -4)         # (..., H, s, W, s, 3)
    else:
        out = np.moveaxis(out, -3, -4)
    return out.reshape(shape[:-2] + (h * SPRITE_SIZE, w * SPRITE_SIZE, 3))


def render_game(game_or_level):
    """Render a game, a level, one lane's state or a board on the host."""
    board = host_array(getattr(game_or_level, "board", game_or_level))
    goals = getattr(game_or_level, "goals", None)
    return render_board(board, None if goals is None else host_array(goals))


def render_mov(board, goals, n_steps, spawn_prob=0.3, rng=None):
    """Evolve a board ``n_steps`` on the host and return the (T+1, ...) RGB
    frames."""
    from ..core.advance_np import advance_board_np

    rng = rng or np.random.default_rng()
    frames = [np.asarray(board)]
    b = np.asarray(board)
    for _ in range(n_steps):
        b = advance_board_np(b, rng, spawn_prob)
        frames.append(b)
    return render_board(np.stack(frames), np.asarray(goals)[None])


def render_file(path, steps=0, movie_format=None, out_path=None):
    """Render a level file (or a recorded trajectory ``.npz``) to
    png/gif/mp4 beside it, or at ``out_path``. Returns the paths written.

    Parity: reference ``render_graphics.py:141-193``. Trajectory files
    (with a (T, H, W) 'board' entry) become movies; single levels become
    pngs unless ``steps`` > 0, in which case the board is evolved.
    """
    import imageio

    data = np.load(path)
    base = out_path or path.rsplit(".", 1)[0]
    board = data["board"] if "board" in data else None
    outputs = []
    if board is not None and np.ndim(board) == 3:
        goals = data["goals"] if "goals" in data else np.zeros_like(board)
        frames = render_board(board.astype(np.int64) & C.CELL_MASK,
                              goals.astype(np.int64) & C.CELL_MASK)
        fmt = movie_format or "gif"
        outputs.append(_write_movie(base + "." + fmt, frames, fmt))
    else:
        from ..io.levels import load_levels_npz

        for lv in load_levels_npz(path):
            if steps > 0:
                frames = render_mov(lv.board, lv.goals, steps,
                                    lv.spawn_prob)
                fmt = movie_format or "gif"
                out = _write_movie(
                    "%s-%s.%s" % (base, lv.name or "level", fmt), frames,
                    fmt)
            else:
                out = ("%s.png" % base if lv.name in ("", base)
                       else "%s-%s.png" % (base, lv.name))
                imageio.imwrite(out, render_board(lv.board, lv.goals))
            outputs.append(out)
    return outputs


def _write_movie(path, frames, fmt):
    """Write frames as a movie and return the path written: an mp4 that
    cannot be written (no ffmpeg) becomes a gif, as
    ``safelife_tpu/render/graphics.py:252-261`` does (JAX's ``render_file``
    then still returns the ``.mp4`` name)."""
    import imageio

    if fmt == "mp4":
        try:
            imageio.mimwrite(path, frames, fps=10)
            return path
        except Exception:
            path = path[:-4] + ".gif"
    imageio.mimwrite(path, frames, duration=100, loop=0)
    return path
