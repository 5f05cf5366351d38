"""The SafeLife environment as batched functions on torch tensors.

Port of ``safelife_tpu/env/env.py``: ``EnvConfig`` (``:33-53``),
``unpack_view_channels`` (``:211-221``), ``reset_batch`` (``:228-264``),
``reset_impl`` (``:267-275``), ``_physics_batch`` (``:300-353``),
``_finish_one`` (``:356-419``, here over the whole batch),
``advance_batch`` (``:422-439``), ``step_core`` (``:442-454``),
``_batch_obs`` (``:457-480``), ``merge_lane_reset`` (``:483-501``),
``sample_episode_record`` and ``all_episode_records`` (``:504-550``) and
``step_impl`` (``:553-578``).

One step, for every board in lockstep (reference
``safelife_env.py:148-201``): actions, the CA advance of the board and of
non-static goals, the exit recolouring, reward = change of the points
value, done = agent gone or time up, then the packed observation views.

On CUDA the physics phase is always kernel K1 (and K2 for the goals) and
the views are always kernel K3; on the CPU the same wrappers run their
plain versions. Randomness comes from the caller's ``torch.Generator``,
which must live on the pool's device.

Sharded lanes (:mod:`..parallel.mesh`): ``reset``, ``step_core``, ``step``
and ``advance_batch`` take the rank's ``lanes`` (a ``LaneRange``; its
``start`` is the rank's lane offset) and then hold only those lanes of the
global batch. Per-lane draws (the reset level picks) are made at the
global shape and cut to the rank's lanes, the seed words are drawn as in
one process, and K1 and K2 draw their coins at the global lanes
(``lane_offset``), so a rank steps its lanes as the one-process run steps
the same lanes of the global batch. K3 reads only the rank's own lanes and
needs no offset (JAX's ``recenter_views_sharded``).
"""

import dataclasses

import torch

from .. import ops
from ..core import cells as C, scoring
from ..parallel.mesh import draw_global
from ..core.scoring import POINTS_ON_LEVEL_EXIT
from ..utils.trace import span
from .state import EnvState, lane_level

DEFAULT_CHANNELS = tuple(range(16)) + (25, 26, 27)

_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration. Parity: constructor attributes of
    the reference ``SafeLifeEnv`` (safelife_env.py:60-96).

    Whether the goals advance and whether spawners draw is read from the
    pool (``all_goals_static``, ``spawner_free``), not configured.
    """

    view_shape: tuple = (15, 15)
    output_channels: tuple = DEFAULT_CHANNELS  # None → packed int32 views
    time_limit: int = 1000
    remove_white_goals: bool = True
    auto_reset: bool = True


# ---------------------------------------------------------------------------
# Observations


def unpack_view_channels(cfg, views):
    """Binary-channel unpack of packed int32 views per ``output_channels``
    (reference ``safelife_env.py:140-143``): uint8 [B, A, vh, vw, C]."""
    if cfg.output_channels is None:
        return views
    shifts = torch.tensor(cfg.output_channels, dtype=torch.int32,
                          device=views.device)
    return ((views[..., None] >> shifts) & 1).to(torch.uint8)


def _batch_obs(cfg, pool, state):
    """Observations of every lane: kernel K3 (or its plain version on the
    CPU), then the channel unpack."""
    with span("env/obs"):
        idx = state.level_idx
        agent_mask = pool.agent_mask.index_select(0, idx)
        center = torch.where(agent_mask[..., None], state.agent_locs, 0)
        views = ops.recenter_views(
            state.board, state.goals,
            center[..., 0].contiguous(), center[..., 1].contiguous(),
            pool.exit_locs.index_select(0, idx),
            pool.exit_locs_valid.index_select(0, idx),
            view_shape=cfg.view_shape,
            remove_white_goals=cfg.remove_white_goals)
        return unpack_view_channels(cfg, views)


# ---------------------------------------------------------------------------
# Reset


def reset_batch(cfg, pool, idx, min_perf_fraction=1.0):
    """Fresh state from pool levels ``idx`` (int64[B]); the t=0 board and
    value are precomputed in the pool, so a reset is a gather."""
    mpf = torch.as_tensor(min_perf_fraction, dtype=torch.float32,
                          device=pool.device).expand(idx.shape)
    b, a = idx.shape[0], pool.num_agents
    dev = pool.device
    rb = pool.reset_boards.reshape((-1,) + pool.board_shape)
    return EnvState(
        board=rb.index_select(0, 2 * idx + (mpf <= 0).long()),
        goals=pool.goals.index_select(0, idx),
        agent_locs=pool.agent_locs.index_select(0, idx),
        num_steps=torch.zeros((b,), dtype=torch.int32, device=dev),
        old_value=pool.reset_old_value.index_select(0, idx),
        episode_reward=torch.zeros((b, a), dtype=torch.float32, device=dev),
        episode_length=torch.zeros((b, a), dtype=torch.int32, device=dev),
        is_active=torch.ones((b, a), dtype=torch.bool, device=dev),
        level_idx=idx,
        min_perf_fraction=mpf.contiguous(),
    )


def reset(cfg, pool, batch_size, min_perf_fraction=1.0, lanes=None):
    """Lane i starts on pool level ``i mod L``. With ``lanes`` the state
    holds lanes ``lanes.start``..``lanes.stop`` of a global batch of
    ``batch_size``. Returns (state, obs)."""
    first, stop = (0, batch_size) if lanes is None else lanes[:2]
    idx = torch.arange(first, stop, device=pool.device) % pool.num_levels
    state = reset_batch(cfg, pool, idx, min_perf_fraction)
    return state, _batch_obs(cfg, pool, state)


# ---------------------------------------------------------------------------
# Step


def seed_words(generator, n, device):
    """int32[n, 2]: two independent seed words per random stream."""
    return torch.randint(_INT32_MIN, _INT32_MAX, (n, 2), dtype=torch.int32,
                         generator=generator, device=device)


def _physics_batch(cfg, lv, state, actions, generator, lane_offset=0):
    """Actions, the CA advance of the board (and of non-static goals), and
    the agents' post-advance cells: K1, and K2 for the goals, their coins
    drawn at global lane ``lane_offset`` + lane.

    Returns (board, goals, agent_locs, cells).
    """
    b, h, w = state.board.shape
    # The goals advance is skipped when every pool level has static goals,
    # and the spawn draws when no level has spawners.
    evolve_goals = not lv.all_goals_static
    stochastic = not lv.spawner_free
    if stochastic:
        seed = seed_words(generator, 2, state.board.device)
    else:
        seed = torch.zeros((2, 2), dtype=torch.int32,
                           device=state.board.device)
    board, agent_locs, cells = ops.fused_actions_advance(
        state.board.reshape(b, h * w).contiguous(),
        state.agent_locs.contiguous(), actions, lv.spawn_prob, seed[0],
        h=h, w=w, stochastic=stochastic, lane_offset=lane_offset)
    board = board.reshape(b, h, w)
    goals = state.goals
    if evolve_goals:
        adv = ops.advance(
            state.goals.reshape(b, h * w).contiguous(), lv.spawn_prob,
            seed[1], h=h, w=w, stochastic=stochastic,
            lane_offset=lane_offset).reshape(b, h, w)
        goals = torch.where(lv.goals_static[:, None, None], state.goals, adv)
    return board, goals, agent_locs, cells


def _finish(cfg, s, lv, board, goals, agent_locs, cells):
    """Scoring, exits and bookkeeping of every lane, given the physics."""
    num_steps = s.num_steps + 1
    base = scoring.points_base(board, goals, lv.table_flat)
    exited = (cells & (C.AGENT | C.EXIT)) == C.EXIT
    active = ((cells & C.AGENT) != 0) & lv.agent_mask
    earned = (base - lv.init_points).to(torch.float32) \
        + POINTS_ON_LEVEL_EXIT * exited
    can_exit = active & (torch.clamp(earned, min=0.0) >= lv.required_points)
    # has_exited / the AGENT bit are unchanged by the exit recolouring
    # (safelife_tpu/core/scoring.py:275-279), so the reads above serve.
    board = scoring.update_exit_colors(
        board, agent_locs, lv.agent_mask, lv.exit_mask, can_exit,
        cells=cells)

    times_up = num_steps >= cfg.time_limit
    value = (base.to(torch.float32) + POINTS_ON_LEVEL_EXIT * exited) \
        * lv.agent_mask
    reward = (value - s.old_value) * s.is_active
    done = ~active | times_up[:, None]
    episode_reward = s.episode_reward + reward
    episode_length = s.episode_length + s.is_active
    s = s.replace(
        board=board, goals=goals, agent_locs=agent_locs,
        num_steps=num_steps, old_value=value,
        episode_reward=episode_reward, episode_length=episode_length,
        is_active=s.is_active & ~done,
    )
    info = {
        "times_up": times_up,
        "success": exited & lv.agent_mask,
        "done": done,
        "lane_done": (done | ~lv.agent_mask).all(-1),
        "episode_reward": episode_reward,
        "episode_length": episode_length,
        "level_idx": s.level_idx,
        "agent_mask": lv.agent_mask,
        "reward_possible": (lv.available_points + POINTS_ON_LEVEL_EXIT)
        * lv.agent_mask,
        "reward_needed": lv.required_points * lv.agent_mask,
    }
    return s, reward, done, info


def advance_batch(boards, spawn_prob, generator, stochastic=True,
                  lane_offset=0):
    """Batched plain CA advance (no agents) through K2, board i drawing its
    coins at global lane ``lane_offset + i``. boards int32[B, H, W];
    spawn_prob float32[B]. With ``stochastic=False``
    spawners never fire, as under the JAX ``EnvConfig(stochastic=False)``
    that its inaction-baseline caller passes
    (``safelife_tpu/env/wrappers.py:202-207``)."""
    b, h, w = boards.shape
    if stochastic:
        seed = seed_words(generator, 1, boards.device)[0]
    else:
        seed = torch.zeros((2,), dtype=torch.int32, device=boards.device)
    return ops.advance(boards.reshape(b, h * w).contiguous(), spawn_prob,
                       seed, h=h, w=w, stochastic=stochastic,
                       lane_offset=lane_offset).reshape(b, h, w)


def lane_offset(lanes):
    """The global index of a rank's first lane (0 in one process)."""
    return 0 if lanes is None else lanes.start


def reset_picks(shape, generator, device, lanes=None):
    """The auto-reset draws of every lane (int64, before ``mod L``), drawn
    at the global shape and cut to ``lanes``."""
    return draw_global(
        lambda s: torch.randint(0, _INT32_MAX, s, generator=generator,
                                device=device), shape, lanes)


def step_core(cfg, pool, state, actions, generator, lanes=None):
    """Batched env step without auto-reset or observations.
    Returns (state, reward, done, info)."""
    with span("env/core"):
        lv = lane_level(pool, state.level_idx, state.min_perf_fraction)
        actions = torch.where(lv.agent_mask, actions.to(torch.int32), 0)
        board, goals, agent_locs, cells = _physics_batch(
            cfg, lv, state, actions.contiguous(), generator,
            lane_offset(lanes))
        return _finish(cfg, state, lv, board, goals, agent_locs, cells)


def _select_lanes(lane_done, new, old):
    """``new`` where ``lane_done``, else ``old``: a tensor or a state
    dataclass, merged field by field into nested dataclasses."""
    if dataclasses.is_dataclass(old):
        return dataclasses.replace(old, **{
            f.name: _select_lanes(lane_done, getattr(new, f.name),
                                  getattr(old, f.name))
            for f in dataclasses.fields(old)})
    shape = (lane_done.shape[0],) + (1,) * (old.dim() - 1)
    return torch.where(lane_done.reshape(shape), new, old)


def merge_lane_reset(lane_done, idx, fresh_fn, state):
    """Replace finished lanes with ``fresh_fn(idx)``, an unconditional
    per-lane select (no host round trip). ``state`` is any state
    dataclass whose fields are [B, ...] tensors or such dataclasses."""
    return _select_lanes(lane_done, fresh_fn(idx), state)


def sample_episode_record(pool, init_boards, state, info):
    """One finished episode's (init, final) board pair for side-effect
    telemetry: the first lane whose episode ended this step (lane 0, with
    ``found`` False, when none did). ``init_boards`` are the episodes' own
    starting boards."""
    lane = torch.argmax(info["lane_done"].to(torch.int32)).reshape(1)
    lane_idx = state.level_idx.index_select(0, lane)
    return {
        "found": info["lane_done"].any(),
        "init_board": init_boards.index_select(0, lane)[0],
        "final_board": state.board.index_select(0, lane)[0],
        "num_steps": state.num_steps.index_select(0, lane)[0],
        "spawn_prob": pool.spawn_prob.index_select(0, lane_idx)[0],
        "level_idx": lane_idx[0],
    }


def all_episode_records(pool, init_boards, state, info):
    """Every lane's (init, final) board pair, ``found`` flagging the lanes
    whose episode ended this step."""
    return {
        "found": info["lane_done"],
        "init_board": init_boards,
        "final_board": state.board,
        "num_steps": state.num_steps,
        "spawn_prob": pool.spawn_prob.index_select(0, state.level_idx),
        "level_idx": state.level_idx,
    }


def step(cfg, pool, state, actions, generator, lanes=None):
    """Batched environment step with auto-reset.

    actions int32[B, A]. Returns (state, obs, reward float32[B, A],
    done bool[B, A], info).
    """
    state, reward, done, info = step_core(cfg, pool, state, actions,
                                          generator, lanes)
    if cfg.auto_reset:
        idx = reset_picks(state.level_idx.shape, generator, pool.device,
                          lanes)
        mpf = state.min_perf_fraction
        state = merge_lane_reset(
            info["lane_done"], idx % pool.num_levels,
            lambda r: reset_batch(cfg, pool, r, mpf), state)
    obs = _batch_obs(cfg, pool, state)
    return state, obs, reward, done, info
