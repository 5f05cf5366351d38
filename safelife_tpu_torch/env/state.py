"""Environment state and level packing as tensor dataclasses.

Port of ``safelife_tpu/env/state.py``: ``LaneLevel`` (``:24-56``),
``LevelBatch`` (``:59-114``), ``EnvState`` (``:117-141``), ``lane_level``
(``:144-170``), ``goals_are_static`` (``:173-186``), ``_derived_fields``
(``:189-251``) and ``pack_levels`` (``:254-340``); ``level_metadata`` of
``safelife_tpu/training/runner.py:186-208`` and the per-slot metadata of
``safelife_tpu/io/iterator.py:444-455, :661-676`` (``slot_metadata``), read
from the packed pool. The packed static-goal
census rows (``row_w0``/``row_w8``) are left out: scoring uses the plain
gather of ``core.scoring.points_base``, which gives the same points.

An :class:`EnvState` batch of boards advances in lockstep; a
:class:`LevelBatch` pool on the device holds the levels that resets draw
from. Agent arrays are padded to a fixed ``A`` with ``agent_mask``; exits
to a fixed ``E`` with ``exit_locs_valid``. ``EnvState`` is slim: level data
is looked up by ``level_idx`` in the pool every step.
"""

import dataclasses

import numpy as np
import torch

from ..core import cells as C, scoring
from ..core.advance_np import advance_board_np
from ..utils.device import resolve_device


@dataclasses.dataclass
class LaneLevel:
    """The per-lane slice of level data the step reads."""

    agent_mask: torch.Tensor        # bool  [B, A]
    table_flat: torch.Tensor        # int32 [B, A, 72]
    init_points: torch.Tensor       # int32 [B, A]
    required_points: torch.Tensor   # int32 [B, A]
    available_points: torch.Tensor  # float32 [B, A]
    spawn_prob: torch.Tensor        # float32 [B]
    goals_static: torch.Tensor      # bool [B]
    exit_mask: torch.Tensor         # bool [B, H, W]
    #: True iff every level of the pool has static goals (skips the goals
    #: advance).
    all_goals_static: bool = False
    #: True iff no level has spawner cells (skips the spawn draws).
    spawner_free: bool = False


@dataclasses.dataclass
class LevelBatch:
    """A pool of levels on one device. Leading axis = levels."""

    board: torch.Tensor             # int32 [L, H, W]
    goals: torch.Tensor             # int32 [L, H, W]
    agent_locs: torch.Tensor        # int32 [L, A, 2]
    agent_mask: torch.Tensor        # bool  [L, A]
    points_table: torch.Tensor      # int32 [L, A, 8, 9]
    min_performance: torch.Tensor   # float32 [L]
    spawn_prob: torch.Tensor        # float32 [L]
    exit_mask: torch.Tensor         # bool  [L, H, W]
    exit_locs: torch.Tensor         # int32 [L, E, 2] (padded, raster order)
    exit_locs_valid: torch.Tensor   # bool  [L, E]
    goals_static: torch.Tensor      # bool  [L]
    initial_counts: torch.Tensor    # int32 [L, 8, 9]
    initial_colors: torch.Tensor    # bool  [L, 9]
    table_flat: torch.Tensor        # int32 [L, A, 72]
    init_points: torch.Tensor       # int32 [L, A]
    required_points: torch.Tensor   # int32 [L, A]
    available_points: torch.Tensor  # float32 [L, A]
    #: The board after the t=0 exit recolouring: [:, 0] for a positive
    #: min-performance fraction, [:, 1] for a fraction of 0 (exits open).
    reset_boards: torch.Tensor      # int32 [L, 2, H, W]
    reset_old_value: torch.Tensor   # float32 [L, A]
    all_goals_static: bool = False
    spawner_free: bool = False

    @property
    def num_levels(self):
        return self.board.shape[0]

    @property
    def board_shape(self):
        return tuple(self.board.shape[-2:])

    @property
    def num_agents(self):
        return self.agent_locs.shape[-2]

    @property
    def device(self):
        return self.board.device


@dataclasses.dataclass
class EnvState:
    """Batched environment state. Leading axis = parallel boards."""

    board: torch.Tensor             # int32 [B, H, W]
    goals: torch.Tensor             # int32 [B, H, W]
    agent_locs: torch.Tensor        # int32 [B, A, 2]
    num_steps: torch.Tensor         # int32 [B]
    old_value: torch.Tensor         # float32 [B, A] — last point value
    episode_reward: torch.Tensor    # float32 [B, A]
    episode_length: torch.Tensor    # int32 [B, A]
    is_active: torch.Tensor         # bool [B, A]
    level_idx: torch.Tensor         # int64 [B] — pool index of the level
    #: min_performance scale active when this lane last reset.
    min_perf_fraction: torch.Tensor  # float32 [B]

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def lane_level(pool, idx, min_perf_fraction):
    """Per-lane :class:`LaneLevel` gathered from the pool by ``idx`` (the
    exits the views need are gathered by ``env._batch_obs`` itself)."""
    def g(x):
        return x.index_select(0, idx)

    mperf = g(pool.min_performance) * min_perf_fraction
    return LaneLevel(
        agent_mask=g(pool.agent_mask),
        table_flat=g(pool.table_flat),
        init_points=g(pool.init_points),
        required_points=scoring.required_points(
            mperf, g(pool.available_points)),
        available_points=g(pool.available_points),
        spawn_prob=g(pool.spawn_prob),
        goals_static=g(pool.goals_static),
        exit_mask=g(pool.exit_mask),
        all_goals_static=pool.all_goals_static,
        spawner_free=pool.spawner_free,
    )


def goals_are_static(goals):
    """Host-side check: goals are static iff one advance leaves them
    unchanged and has no spawners (reference ``safelife_game.py:753-761``).
    """
    g = np.asarray(goals).astype(np.int64)
    adv = advance_board_np(g)
    return (not (adv & C.SPAWNING).any()) and (adv == g).all()


def _derived_fields(boards, goals, tables, mperf, agent_locs, agent_mask,
                    exit_mask):
    """The LevelBatch fields computed on the device, including the t=0
    reset board and initial point value of every level."""
    initial_counts = scoring.alive_counts(boards, goals)
    initial_colors = scoring.initial_colors_from_board(boards)
    init_points = (tables * initial_counts[:, None]).sum(
        (-1, -2), dtype=torch.int32)
    available = scoring.initial_available_points(
        initial_counts, initial_colors, tables)
    required = scoring.required_points(mperf, available)

    # The reset's can-exit test (earned 0 vs required) has the same outcome
    # for every positive min-performance fraction; a fraction of 0 opens
    # every exit at t=0 and gets its own board
    # (safelife_tpu/env/state.py:216-237).
    cells = scoring.agent_cells(boards, agent_locs)
    exited = (cells & (C.AGENT | C.EXIT)) == C.EXIT
    earned = scoring.POINTS_ON_LEVEL_EXIT * exited.to(torch.float32)
    active = ((cells & C.AGENT) != 0) & agent_mask
    can_exit = active & (torch.clamp(earned, min=0.0) >= required)
    reset_board = scoring.update_exit_colors(
        boards, agent_locs, agent_mask, exit_mask, can_exit, cells=cells)
    reset_board_open = scoring.update_exit_colors(
        boards, agent_locs, agent_mask, exit_mask, active, cells=cells)
    reset_old_value = (init_points.to(torch.float32)
                       + scoring.POINTS_ON_LEVEL_EXIT * exited) * agent_mask
    return dict(
        initial_counts=initial_counts,
        initial_colors=initial_colors,
        table_flat=scoring.flatten_points_table(tables),
        init_points=init_points,
        required_points=required,
        available_points=available,
        reset_boards=torch.stack([reset_board, reset_board_open], 1),
        reset_old_value=reset_old_value,
    )


def pack_levels(levels, pad_agents=None, pad_exits=None, device="cuda"):
    """Pack host :class:`~safelife_tpu_torch.io.levels.Level` objects into a
    :class:`LevelBatch` on ``device``. All levels must share a board shape.
    """
    dev = resolve_device(device)
    shapes = {lv.shape for lv in levels}
    if len(shapes) != 1:
        raise ValueError("levels in one batch must share a board shape, "
                         "got %s" % shapes)
    A = pad_agents or max(1, max(lv.num_agents for lv in levels))
    boards, goals, locs, masks, tables = [], [], [], [], []
    mperf, sprob, emasks, elocs, gstatic = [], [], [], [], []
    for lv in levels:
        a = lv.num_agents
        if a > A:
            raise ValueError("level has %d agents > pad_agents=%d" % (a, A))
        boards.append(lv.board)
        goals.append(lv.goals)
        locs.append(np.concatenate(
            [lv.agent_locs, np.zeros((A - a, 2), np.int64)]))
        masks.append(np.arange(A) < a)
        tables.append(np.concatenate(
            [lv.points_table.astype(np.int32),
             np.zeros((A - a, 8, 9), np.int32)]))
        mperf.append(np.float32(lv.min_performance))
        sprob.append(np.float32(lv.spawn_prob))
        em = (lv.board & (C.EXIT | C.AGENT)) == C.EXIT
        emasks.append(em)
        elocs.append(np.stack(np.nonzero(em), axis=1))
        gstatic.append(goals_are_static(lv.goals))

    E = pad_exits or max(1, max(len(e) for e in elocs))
    elocs_p, evalid_p = [], []
    for e in elocs:
        if len(e) > E:
            raise ValueError("level has %d exits > pad_exits=%d"
                             % (len(e), E))
        elocs_p.append(np.concatenate([e, np.zeros((E - len(e), 2),
                                                   np.int64)]))
        evalid_p.append(np.arange(E) < len(e))

    boards_np = np.stack(boards).astype(np.int32)
    goals_np = np.stack(goals).astype(np.int32)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)

    host = dict(
        board=t(boards_np, torch.int32),
        goals=t(goals_np, torch.int32),
        agent_locs=t(np.stack(locs), torch.int32),
        agent_mask=t(np.stack(masks), torch.bool),
        points_table=t(np.stack(tables), torch.int32),
        min_performance=t(np.stack(mperf), torch.float32),
        spawn_prob=t(np.stack(sprob), torch.float32),
        exit_mask=t(np.stack(emasks), torch.bool),
        exit_locs=t(np.stack(elocs_p), torch.int32),
        exit_locs_valid=t(np.stack(evalid_p), torch.bool),
        goals_static=t(np.stack(gstatic), torch.bool),
    )
    derived = _derived_fields(
        host["board"], host["goals"], host["points_table"],
        host["min_performance"], host["agent_locs"], host["agent_mask"],
        host["exit_mask"])
    return LevelBatch(
        **host, **derived, all_goals_static=bool(np.all(gstatic)),
        spawner_free=not bool(((boards_np | goals_np) & C.SPAWNING).any()))


def slot_metadata(pool, names, masks=None, min_performance=None):
    """The record metadata of each row of ``pool`` (a :class:`LevelBatch`),
    read in one host copy: ``names[i]``, reward_possible and reward_needed
    summed over the agents of ``masks[i]`` (the pool's ``agent_mask`` by
    default: team totals of multi-agent levels), and ``min_performance[i]``
    (the pool's float32 values by default). Returns a list."""
    avail, req, mask, mperf = (x.cpu().numpy() for x in (
        pool.available_points, pool.required_points, pool.agent_mask,
        pool.min_performance))
    masks = mask if masks is None else masks
    mperf = mperf if min_performance is None else min_performance
    return [{"name": name,
             "reward_possible": float(
                 (avail[i] + scoring.POINTS_ON_LEVEL_EXIT)[masks[i]].sum()),
             "reward_needed": int(req[i][masks[i]].sum()),
             "min_performance": float(mperf[i])}
            for i, name in enumerate(names)]


def level_metadata(levels, pool):
    """Per-level metadata of ``levels`` (packed as ``pool``), keyed by
    index, as the JAX package's ``runner.level_metadata`` gives it: a level
    without agents reports its first agent slot, and min_performance is
    the level's own float."""
    a = pool.num_agents
    return dict(enumerate(slot_metadata(
        pool, [lv.name or ("level-%d" % i) for i, lv in enumerate(levels)],
        masks=[np.arange(a) < max(lv.num_agents, 1) for lv in levels],
        min_performance=[lv.min_performance for lv in levels])))
