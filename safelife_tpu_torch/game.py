"""The host game and editor: the reference ``SafeLifeGame`` API on NumPy.

Port of ``safelife_tpu/game.py:1-559`` (the port's own copy; the JAX
package is pure NumPy here too): ``SafeLifeGame`` with its seeding,
(de)serialization, named actions, the edit commands with the reference's
quirks (``_edit_move_cursor``), the board editing utilities, the host CA
advance, scoring and exit bookkeeping, and ``_execute_actions_np`` and
``_alive_counts_np``.

This is the interactive and editor-facing layer (reference
``safelife/safelife_game.py``): same attributes, methods, action names,
serialization keys and ``.npz`` files. The batched env on the card never
uses it; :mod:`safelife_tpu_torch.interactive` plays it.
"""

import os

import numpy as np

from .core import cells as C
from .core.advance_np import advance_board_np
from .core.scoring import DEFAULT_POINTS_TABLE, POINTS_ON_LEVEL_EXIT
from .io import levels as L
from .utils.rng import get_rng

ORIENTATION = {
    "UP": 0, "RIGHT": 1, "DOWN": 2, "LEFT": 3,
    "FORWARD": 4, "BACKWARD": 6,
}

#: (dy, dx) unit step for each absolute orientation (y grows downward).
DIRECTION_VECTORS = ((-1, 0), (0, 1), (1, 0), (0, -1))

CellTypes = C.CellTypes


class SafeLifeGame:
    """Mutable single-game state (board + goals + agents + scoring)."""

    spawn_prob = 0.3
    edit_loc = (0, 0)
    edit_color = 0
    file_name = None
    game_over = False
    points_on_level_exit = POINTS_ON_LEVEL_EXIT
    num_steps = 0
    min_performance = -1.0
    _seed = None
    _rng = None
    _static_goals = None

    def __init__(self, board_size=(10, 10)):
        self.agent_locs = np.empty((0, 2), dtype=int)
        self.agent_names = np.array([], dtype=str)
        self.exit_locs = (np.array([], dtype=int), np.array([], dtype=int))
        if board_size is not None:
            self.board = np.zeros(board_size, dtype=np.int64)
            self.goals = np.zeros(board_size, dtype=np.int64)
            loc = (board_size[0] // 2, board_size[1] // 2)
            self.board[loc] = C.PLAYER
            self.agent_locs = np.array([loc])
            self.agent_names = np.array(["agent0"])
            self.reset_points_table()
            self.setup_initial_counts()
            self._init_data = self.serialize()

    # -- seeding ---------------------------------------------------------
    @property
    def seed(self):
        return self._seed

    @seed.setter
    def seed(self, seed):
        if not isinstance(seed, np.random.SeedSequence):
            seed = np.random.SeedSequence(seed)
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    @property
    def rng(self):
        return self._rng if self._rng is not None else get_rng()

    # -- (de)serialization ----------------------------------------------
    def serialize(self):
        return {
            "spawn_prob": self.spawn_prob,
            "agent_locs": self.agent_locs.copy(),
            "agent_names": self.agent_names.copy(),
            "board": self.board.astype(np.uint16),
            "goals": self.goals.astype(np.uint16),
            "points_table": self.points_table.copy(),
            "min_performance": self.min_performance,
            "class": "safelife.safelife_game.SafeLifeGame",
        }

    def deserialize(self, data, as_initial_state=True):
        lv = data.copy() if isinstance(data, L.Level) \
            else L.level_from_data(data)
        if as_initial_state:
            self._init_data = data
        self.board = lv.board.astype(np.int64)
        self.goals = lv.goals.astype(np.int64)
        self.agent_locs = lv.agent_locs.astype(int)
        self.agent_names = lv.agent_names
        self.points_table = lv.points_table.astype(np.int64)
        self.min_performance = lv.min_performance
        self.spawn_prob = lv.spawn_prob
        self.game_over = False
        self.num_steps = 0
        self._static_goals = None
        self.update_exit_locs()
        self.setup_initial_counts()
        self.update_exit_colors()

    def revert(self):
        if hasattr(self, "_init_data"):
            self.deserialize(self._init_data)
            return True
        return False

    def save(self, file_name=None):
        file_name = file_name or self.file_name
        if file_name is None:
            raise ValueError("Must specify a file name")
        file_name = os.path.abspath(os.path.expanduser(file_name))
        if not file_name.endswith(".npz"):
            file_name += ".npz"
        self.file_name = file_name
        self._init_data = self.serialize()
        self.num_steps = 0
        np.savez_compressed(file_name, **self._init_data)

    @classmethod
    def loaddata(cls, data):
        obj = cls(board_size=None)
        obj.deserialize(data)
        return obj

    @classmethod
    def load(cls, file_name):
        obj = cls.loaddata(np.load(os.path.abspath(
            os.path.expanduser(file_name))))
        obj.file_name = file_name
        return obj

    @property
    def level(self):
        """Snapshot as a :class:`~safelife_tpu_torch.io.levels.Level`."""
        return L.Level(
            board=self.board.astype(np.int32),
            goals=self.goals.astype(np.int32),
            agent_locs=np.asarray(self.agent_locs, np.int64),
            agent_names=np.asarray(self.agent_names),
            points_table=np.asarray(self.points_table, np.int32),
            min_performance=float(self.min_performance),
            spawn_prob=float(self.spawn_prob),
            name=os.path.basename(self.file_name or "game"),
        )

    # -- geometry --------------------------------------------------------
    @property
    def width(self):
        return self.board.shape[1]

    @property
    def height(self):
        return self.board.shape[0]

    @property
    def title(self):
        if self.file_name is None:
            return None
        fname = os.path.split(self.file_name)[-1].rsplit(".", 1)[0]
        return fname

    @property
    def agent_locs_idx(self):
        return tuple(self.agent_locs.T)

    @property
    def orientation(self):
        agents = self.board[self.agent_locs_idx]
        return ((agents & C.ORIENTATION_MASK)
                >> C.ORIENTATION_BIT).astype(np.int64)

    @orientation.setter
    def orientation(self, value):
        value = (np.asarray(value, np.int64) & 3) << C.ORIENTATION_BIT
        self.board[self.agent_locs_idx] &= ~C.ORIENTATION_MASK
        self.board[self.agent_locs_idx] |= value

    # -- actions ---------------------------------------------------------
    def execute_actions(self, actions):
        """Numeric actions for every agent (0-8)."""
        actions = np.broadcast_to(
            np.atleast_1d(np.asarray(actions, np.int64)),
            (len(self.agent_locs),))
        self.board, self.agent_locs = _execute_actions_np(
            self.board, self.agent_locs, actions)
        self._needs_new_counts = True

    def execute_action(self, action):
        """Named interactive action (parity: safelife_game.py:343-378)."""
        if self.game_over or len(self.agent_locs) == 0:
            pass
        elif action.startswith("MOVE "):
            direction = ORIENTATION[action[5:]]
            flip = 2 if direction == 6 else 0
            if direction < 4:
                self.execute_actions(direction + 1)
            else:
                direction = self.orientation ^ flip
                self.execute_actions(direction + 1)
            self.orientation = self.orientation ^ flip
            self.game_over = bool(self.has_exited().any())
        elif action.startswith("TURN "):
            direction = ORIENTATION[action[5:]]
            self.orientation = (self.orientation + 2 - direction) % 4
        elif action.startswith("FACE "):
            self.orientation = ORIENTATION[action[5:]]
        elif action.startswith("TOGGLE"):
            if len(action) > 6:
                direction = ORIENTATION[action[7:]]
            else:
                direction = self.orientation
            self.execute_actions(np.asarray(direction) + 5)
        elif action in ("RESTART", "ABORT LEVEL", "PREV LEVEL",
                        "NEXT LEVEL"):
            self.game_over = action
        return 0

    # The edit-DSL vocabulary. The command strings and cell-name tables
    # are the interactive editor's wire format (shared with the reference
    # editor's keymaps, safelife_game.py:399-427, so recordings/macros
    # stay interchangeable); the dispatch below is handler-table based.
    EDIT_OBJECTS = {
        'EMPTY': C.EMPTY, 'LIFE': C.LIFE, 'HARD LIFE': C.ALIVE,
        'WALL': C.WALL, 'CRATE': C.CRATE, 'SPAWNER': C.SPAWNER,
        'HARD SPAWNER': C.HARD_SPAWNER, 'EXIT': C.LEVEL_EXIT,
        'ICECUBE': C.ICE_CUBE, 'PLANT': C.PLANT, 'TREE': C.TREE,
        'FOUNTAIN': C.FOUNTAIN, 'PARASITE': C.PARASITE,
        'WEED': C.WEED, 'AGENT': C.PLAYER,
    }
    EDIT_TOGGLES = {
        "AGENT": C.AGENT, "ALIVE": C.ALIVE, "PUSHABLE": C.PUSHABLE,
        "PULLABLE": C.PULLABLE, "DESTRUCTIBLE": C.DESTRUCTIBLE,
        "FROZEN": C.FROZEN, "PRESERVING": C.PRESERVING,
        "INHIBITING": C.INHIBITING, "SPAWNING": C.SPAWNING,
        "EXIT": C.EXIT,
    }

    # -- edit-command handlers (each: (board, argument) -> message|None) --

    def _edit_move_cursor(self, board, arg):
        # ORIENTATION[arg] raises KeyError on unknown directions, like the
        # reference. FORWARD/BACKWARD (orientations 4/6) reproduce the
        # reference's editor quirk (safelife_game.py:431-436): its
        # ``dy = direction - 1`` arithmetic jumps the cursor 3 or 5 rows
        # down — useless but wire-compatible.
        direction = ORIENTATION[arg]
        if direction < 4:
            dy, dx = DIRECTION_VECTORS[direction]
        else:
            dy, dx = direction - 1, 0
        y, x = self.edit_loc
        self.edit_loc = ((y + dy) % board.shape[0],
                         (x + dx) % board.shape[1])

    def _edit_put(self, board, arg):
        cell = self.EDIT_OBJECTS[arg]
        board[self.edit_loc] = cell | (self.edit_color if cell else 0)

    def _edit_cycle_color(self, board, step):
        self.edit_color = (self.edit_color + step * C.COLOR_R) \
            & C.RAINBOW_COLOR
        return "EDIT COLOR: " + self.edit_color_name

    def _edit_apply_color(self, board, arg):
        board[self.edit_loc] = \
            (board[self.edit_loc] & ~C.RAINBOW_COLOR) | self.edit_color

    def _edit_toggle(self, board, arg):
        board[self.edit_loc] ^= self.EDIT_TOGGLES[arg]

    def _edit_revert(self, board, arg):
        if not self.revert():
            return "No saved state; cannot revert."

    def _edit_end_level(self, board, command):
        self.game_over = command

    def execute_edit(self, command, board=None):
        """Run one board-editing DSL command; returns a status message or
        None. Unknown commands are ignored (but still refresh the derived
        state, like the reference editor)."""
        if command.startswith("GOALS "):
            rval = self.execute_edit(command[6:], self.goals)
            self._static_goals = None
            return rval
        if board is None:
            board = self.board

        verb, _, arg = command.partition(" ")
        if verb == "MOVE" and arg:
            # Any argument dispatches (unknown ones raise KeyError in the
            # handler, reproducing the reference's ORIENTATION lookup).
            handler = self._edit_move_cursor
        elif verb == "PUT" and arg in self.EDIT_OBJECTS:
            handler = self._edit_put
        elif verb == "TOGGLE" and arg in self.EDIT_TOGGLES:
            handler = self._edit_toggle
        else:
            handler, arg = {
                "NEXT EDIT COLOR": (self._edit_cycle_color, +1),
                "PREVIOUS EDIT COLOR": (self._edit_cycle_color, -1),
                "APPLY EDIT COLOR": (self._edit_apply_color, None),
                "REVERT": (self._edit_revert, None),
                "ABORT LEVEL": (self._edit_end_level, command),
                "PREV LEVEL": (self._edit_end_level, command),
                "NEXT LEVEL": (self._edit_end_level, command),
            }.get(command, (None, None))

        rval = handler(board, arg) if handler else None

        # Edits invalidate every derived quantity: censuses, the points
        # table's agent axis, exit bookkeeping, and agent locations.
        self._needs_new_counts = True
        if len(self.points_table) != len(self.agent_locs):
            self.reset_points_table()
        self.update_exit_locs()
        self.update_exit_colors()
        self.update_agent_locs()
        return rval

    @property
    def edit_color_name(self):
        return ['black', 'red', 'green', 'yellow', 'blue', 'magenta',
                'cyan', 'white'][self.edit_color >> C.COLOR_BIT]

    # -- board editing utilities ------------------------------------------
    def shift_board(self, dx, dy):
        """Translate board and goals (edges wrap). Parity:
        safelife_game.py:464-470,721-725."""
        self.board = np.roll(np.roll(self.board, dy, axis=0), dx, axis=1)
        self.goals = np.roll(np.roll(self.goals, dy, axis=0), dx, axis=1)
        if len(self.agent_locs):
            self.agent_locs = (self.agent_locs + [dy, dx]) % self.board.shape
        self.update_exit_locs()
        self._needs_new_counts = True

    def resize_board(self, dx, dy):
        """Expand or shrink board and goals. Parity:
        safelife_game.py:472-485,727-735."""
        height, width = self.board.shape
        if width + dx <= 0 or height + dy <= 0:
            raise ValueError("Cannot resize to zero.")

        def grow(arr):
            new = np.zeros((height + dy, width + dx), dtype=arr.dtype)
            h = height + min(0, dy)
            w = width + min(0, dx)
            new[:h, :w] = arr[:h, :w]
            return new

        self.board = grow(self.board)
        self.goals = grow(self.goals)
        if len(self.agent_locs):
            in_bounds = ~np.any(
                self.agent_locs >= self.board.shape, axis=1)
            self.agent_locs = self.agent_locs[in_bounds]
            self.agent_names = np.asarray(self.agent_names)[in_bounds]
            if len(self.points_table) == len(in_bounds):
                self.points_table = self.points_table[in_bounds]
        self.edit_loc = tuple(np.array(self.edit_loc) % self.board.shape)
        self.update_exit_locs()
        self._needs_new_counts = True

    def clip_board(self, left=0, right=0, top=0, bottom=0):
        """Clip edges off the board. Parity: safelife_game.py:487-493."""
        height, width = self.board.shape
        if left + right >= width or top + bottom >= height:
            raise ValueError("Board clipped to zero")
        self.shift_board(-left, -top)
        self.resize_board(-(left + right), -(bottom + top))

    # -- physics ---------------------------------------------------------
    def advance_board(self):
        self.num_steps += 1
        self._needs_new_counts = True
        rng = self.rng
        self.board = advance_board_np(self.board, rng, self.spawn_prob)
        if not self._static_goals:
            new_goals = advance_board_np(self.goals, rng, self.spawn_prob)
            if self._static_goals is None:
                self._static_goals = (
                    not (new_goals & C.SPAWNING).any()
                    and (new_goals == self.goals).all())
            self.goals = new_goals

    @property
    def is_stochastic(self):
        return bool((self.board & C.SPAWNING).any())

    # -- scoring ---------------------------------------------------------
    def reset_points_table(self):
        self.points_table = np.tile(
            DEFAULT_POINTS_TABLE, (max(len(self.agent_locs), 1), 1, 1)
        )[:max(len(self.agent_locs), 0)].astype(np.int64)
        if len(self.agent_locs) == 0:
            self.points_table = np.zeros((0, 8, 9), np.int64)

    @property
    def alive_counts(self):
        if getattr(self, "_needs_new_counts", True):
            self._needs_new_counts = False
            self._alive_counts = _alive_counts_np(self.board, self.goals)
        return self._alive_counts

    def setup_initial_counts(self):
        self._needs_new_counts = True
        self.initial_counts = self.alive_counts.copy()
        self.initial_colors = np.zeros(9, dtype=bool)
        gen = C.AGENT | C.ALIVE | C.SPAWNING
        colors = self.board[(self.board & gen) > 0] & C.RAINBOW_COLOR
        self.initial_colors[np.unique(colors) >> C.COLOR_BIT] = True
        self.initial_colors[-1] = True

    def has_exited(self):
        cells = self.board[self.agent_locs_idx]
        return cells & (C.AGENT | C.EXIT) == C.EXIT

    def agent_is_active(self):
        return self.board[self.agent_locs_idx] & C.AGENT > 0

    def current_points(self):
        pts = (self.points_table * self.alive_counts).reshape(
            len(self.agent_locs), -1).sum(axis=1)
        return pts + self.points_on_level_exit * self.has_exited()

    def points_earned(self):
        delta = self.alive_counts - self.initial_counts
        pts = (self.points_table * delta).reshape(
            len(self.agent_locs), -1).sum(axis=1)
        return pts + self.points_on_level_exit * self.has_exited()

    def initial_available_points(self):
        goal_counts = self.initial_counts.sum(axis=1)
        table = self.points_table * self.initial_colors
        total = (table.max(axis=2) * goal_counts).sum(axis=1)
        init = (self.points_table * self.initial_counts).reshape(
            len(self.agent_locs), -1).sum(axis=1)
        return total - init

    def required_points(self):
        req = self.min_performance * self.initial_available_points()
        return np.maximum(0, np.int64(np.ceil(req)))

    def can_exit(self):
        earned = np.maximum(0, self.points_earned())
        return self.agent_is_active() & (earned >= self.required_points())

    def update_exit_locs(self):
        exits = self.board & (C.EXIT | C.AGENT) == C.EXIT
        self.exit_locs = np.nonzero(exits)

    def update_exit_colors(self):
        ce = self.can_exit()
        idx = self.agent_locs_idx
        self.board[idx] &= ~C.EXIT
        self.board[idx] |= C.EXIT * ce
        exit_type = C.LEVEL_EXIT | (C.COLOR_R if ce.any() else 0)
        self.board[self.exit_locs] = exit_type

    def update_agent_locs(self):
        new_locs = np.stack(
            np.nonzero(self.board & C.AGENT), axis=1)
        old_locs = self.agent_locs
        if len(old_locs):
            compare = np.all(new_locs[None] == old_locs[:, None], axis=-1)
            self.agent_locs = np.append(
                old_locs[np.any(compare, axis=1)],
                new_locs[~np.any(compare, axis=0)], axis=0)
        else:
            self.agent_locs = new_locs
        if len(old_locs) != len(new_locs):
            self.agent_names = np.array(
                ["agent%i" % i for i in range(len(self.agent_locs))])
            self.reset_points_table()


def _execute_actions_np(board, locs, actions):
    """Sequential per-agent action execution (same semantics as the device
    kernel in core/actions.py; see its docstring for the rules)."""
    board = np.array(board, dtype=np.int64)
    locs = np.array(locs, dtype=np.int64)
    h, w = board.shape
    for k in range(len(locs)):
        action = int(actions[k])
        if action == 0:
            continue
        dirn = (action - 1) & 3
        if dirn & 1:
            dx, dy = 2 - dirn, 0
        else:
            dx, dy = 0, dirn - 1
        y0, x0 = int(locs[k, 0]) % h, int(locs[k, 1]) % w
        p0 = (y0, x0)
        p1 = ((y0 + dy) % h, (x0 + dx) % w)
        p2 = ((y0 + 2 * dy) % h, (x0 + 2 * dx) % w)
        p3 = ((y0 - dy) % h, (x0 - dx) % w)
        if not board[p0] & C.AGENT:
            continue
        board[p0] = (board[p0] & ~C.ORIENTATION_MASK) | \
            (dirn << C.ORIENTATION_BIT)
        if action >= 5:  # toggle
            if board[p1] == 0:
                board[p1] = C.ALIVE | C.DESTRUCTIBLE | \
                    (board[p0] & C.COLORS)
            elif board[p1] & C.DESTRUCTIBLE:
                if board[p1] & C.AGENT:
                    board[p1] ^= C.AGENT | C.DESTRUCTIBLE
                    board[p1] |= C.FROZEN
                else:
                    board[p1] = 0
            elif ~board[p0] & board[p1] & C.PUSHABLE:
                if board[p2] == 0:
                    board[p2] = board[p1]
                    board[p1] = 0
                elif board[p2] & C.EXIT:
                    board[p1] = 0
        else:  # move
            moved = exited = False
            if ~board[p0] & board[p1] & C.PUSHABLE:
                if board[p2] == 0:
                    board[p2] = board[p1]
                    moved = True
                elif board[p2] & C.EXIT:
                    moved = True
            elif board[p1] == 0:
                moved = True
            elif (board[p0] & board[p1] & C.EXIT) and \
                    not board[p1] & C.AGENT:
                exited = True
            if moved:
                board[p1] = board[p0]
            if moved or exited:
                locs[k] = [(y0 + dy) % h, (x0 + dx) % w]
                if ~board[p0] & board[p3] & C.PULLABLE:
                    board[p0] = board[p3]
                    board[p3] = 0
                else:
                    board[p0] = 0
    return board, locs


def _alive_counts_np(board, goals):
    movable = C.DESTRUCTIBLE | C.PUSHABLE | C.PULLABLE
    include = ((board & movable) != 0) | ((board & C.FROZEN) == 0)
    alive = (board & C.ALIVE) != 0
    bc = (board >> C.COLOR_BIT) & 7
    gc = (goals >> C.COLOR_BIT) & 7
    idx = np.where(alive, gc * 9 + bc, gc * 9 + 8)
    out = np.bincount(idx[include].ravel(), minlength=72)
    return out.reshape(8, 9).astype(np.int64)
