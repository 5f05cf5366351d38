"""Level loading for ``.npz`` files and archives.

Port of ``safelife_tpu/io/levels.py``: ``Level`` (``:35-66``),
``level_from_data`` (``:69-122``), ``load_levels_npz`` (``:145-157``),
``find_files`` (``:181-213``, npz only) and ``load_levels`` (``:216-222``).
YAML procgen specs are not handled here.

The level files themselves stay where the JAX package ships them:
:data:`LEVEL_DIRECTORY` points at ``safelife_tpu/levels/`` on disk, and the
files are read by path (the package is never imported).

Boards are uint16 on disk and int32 in memory.
"""

import dataclasses
import glob as _glob
import os

import numpy as np

from ..core import cells as C
from ..core.scoring import DEFAULT_POINTS_TABLE

#: The shipped level tree, read by path beside this package.
LEVEL_DIRECTORY = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "safelife_tpu", "levels")


@dataclasses.dataclass
class Level:
    """Host-side level: plain numpy arrays, single level, variable shapes."""

    board: np.ndarray                # int32 (H, W)
    goals: np.ndarray                # int32 (H, W)
    agent_locs: np.ndarray           # int64 (A, 2) row, col
    agent_names: np.ndarray          # str (A,)
    points_table: np.ndarray         # int32 (A, 8, 9)
    min_performance: float = -1.0
    spawn_prob: float = 0.3
    name: str = ""

    @property
    def shape(self):
        return self.board.shape

    @property
    def num_agents(self):
        return len(self.agent_locs)


def level_from_data(data, name=""):
    """Build a :class:`Level` from a dict / npz mapping / structured record.

    Handles the old single-agent format (``agent_loc`` is (x, y)!) exactly
    like the reference's ``deserialize`` (safelife_game.py:211-234).
    """
    if hasattr(data, "dtype") and data.dtype.fields:
        keys = data.dtype.fields
    else:
        keys = set(data.keys())

    board = np.asarray(data["board"]).astype(np.int32) & C.CELL_MASK
    goals = (np.asarray(data["goals"]).astype(np.int32) & C.CELL_MASK
             if "goals" in keys else np.zeros_like(board))

    if "agent_loc" in keys:  # old single-agent format, (x, y) order
        agent_locs = np.array(data["agent_loc"], dtype=np.int64)[None, ::-1]
    elif "agent_locs" in keys:
        agent_locs = np.array(data["agent_locs"], dtype=np.int64)
    else:
        agent_locs = np.zeros((0, 2), dtype=np.int64)

    if "agent_names" in keys:
        agent_names = np.array(data["agent_names"])
    else:
        agent_names = np.array(
            ["agent%i" % i for i in range(len(agent_locs))])

    if "orientation" in keys:  # old format: scalar orientation to board bits
        orient = (int(data["orientation"]) & 3) << C.ORIENTATION_BIT
        for (r, c) in agent_locs:
            board[r, c] = (board[r, c] & ~C.ORIENTATION_MASK) | orient

    if "points_table" in keys:
        points_table = np.array(data["points_table"], dtype=np.int32)
    else:
        points_table = np.tile(DEFAULT_POINTS_TABLE,
                               (max(len(agent_locs), 1), 1, 1))
        points_table = points_table[:len(agent_locs)]

    min_performance = (float(data["min_performance"])
                       if "min_performance" in keys else -1.0)
    spawn_prob = float(data["spawn_prob"]) if "spawn_prob" in keys else 0.3

    if not name and "name" in keys:
        name = str(data["name"])

    return Level(
        board=board, goals=goals, agent_locs=agent_locs,
        agent_names=agent_names, points_table=points_table,
        min_performance=min_performance, spawn_prob=spawn_prob, name=name,
    )


def load_levels_npz(file_name):
    """Load one npz file → list of Levels (archives expand to many)."""
    out = []
    with np.load(file_name) as data:
        if "levels" in data:
            for rec in data["levels"]:
                name = str(rec["name"]) if "name" in rec.dtype.fields else ""
                out.append(level_from_data(rec, name=name))
        else:
            d = {k: data[k] for k in data.keys()}
            out.append(level_from_data(
                d, name=os.path.basename(file_name)[:-4]))
    return out


def find_files(*paths):
    """Resolve ``.npz`` level paths: exact or glob match, then with the
    extension appended, then directory contents; tried relative to the
    working directory first, then to :data:`LEVEL_DIRECTORY`."""
    dirs = [None, LEVEL_DIRECTORY]
    out = []
    for path in paths:
        found = None
        for base in dirs:
            p = (os.path.join(base, path) if base
                 else os.path.abspath(os.path.expanduser(path)))
            candidates = sorted(
                f for f in _glob.glob(p, recursive=True)
                if os.path.isfile(f) and f.endswith(".npz"))
            if not candidates:
                candidates = sorted(
                    f for f in _glob.glob(p + ".npz", recursive=True)
                    if os.path.isfile(f))
            if not candidates and os.path.isdir(p):
                candidates = sorted(
                    os.path.join(p, f) for f in os.listdir(p)
                    if f.endswith(".npz"))
            if candidates:
                found = candidates
                break
        if found is None:
            raise FileNotFoundError("No level files found for '%s'" % path)
        out.extend(found)
    return out


def load_levels(*paths):
    """Load every level reachable from the given ``.npz`` paths."""
    out = []
    for f in find_files(*paths):
        out.extend(load_levels_npz(f))
    return out
