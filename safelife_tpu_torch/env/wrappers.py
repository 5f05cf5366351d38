"""Training-time reward shaping, folded into the batched env step.

Port of ``safelife_tpu/env/wrappers.py``: ``WrapperConfig`` (``:39-61``),
``WrappedState`` (``:64-74``), ``_fresh_wrapper_fields`` (``:77-84``, as
``_wrap``), ``reset_impl`` (``:87-95``), ``_movement_bonus`` (``:98-124``),
``_side_effect_count`` (``:127-144``), ``_shape_one`` (``:147-167``, here
over the whole batch as ``_shape``), ``_fresh_wrapped`` (``:170-178``) and
``step_impl`` (``:181-238``). Semantics of the reference's gym wrappers
(``safelife/env_wrappers.py``):

* **movement bonus**: speed over a trailing ``period``-step window of agent
  positions (a ring buffer); with ``as_penalty`` recentred into a
  standing-still penalty. ``speed ** 1e-100`` is computed float32-safely.
* **extra exit bonus**: on episode end other than time-up, add
  ``bonus * episode_reward``, the core env's episode reward.
* **simple side-effect penalty**: the change in the number of cells that
  deviate from a baseline board (the starting state, or an inaction
  counterfactual advanced alongside by kernel K2), ignoring player bits
  and exit recolouring.
* **min-performance scheduler**: the ``min_perf_fraction`` argument scales
  each fresh level's ``min_performance``.

JAX shapes one lane under ``vmap``; here every function takes the batch
axis B, with gathers and scatters on it and no loop over lanes. With a
rank's ``lanes`` (:mod:`..parallel.mesh`) ``reset`` and ``step`` hold those
lanes of the global batch, as :mod:`.env`'s do; the inaction baseline's
K2 draws its coins at the global lanes.
"""

import dataclasses

import torch

from ..core import cells as C
from ..utils.device import require_device
from ..utils.trace import span
from . import env as E
from .state import EnvState, lane_level


@dataclasses.dataclass(frozen=True)
class WrapperConfig:
    movement_bonus: float = 0.1
    movement_bonus_period: int = 4
    movement_bonus_power: float = 1e-100
    movement_as_penalty: bool = True
    single_agent: bool = True  # scalar (agent-0) vs per-agent move bonus
    exit_bonus: float = 0.5
    se_baseline: str = "starting-state"  # or "inaction"
    ignore_reward_cells: bool = False
    enabled: bool = True
    # The learner-visible ``done`` fires only on time-up (the reference's
    # ContinuingEnv, env_wrappers.py:101-118); lanes still auto-reset.
    continuing: bool = False
    # Capture every lane's (init, final) boards each step instead of the
    # first finished lane's.
    exhaustive_se: bool = False


@dataclasses.dataclass
class WrappedState:
    env: EnvState
    prior_positions: torch.Tensor   # int32 [B, period, A, 2] ring buffer
    prior_count: torch.Tensor       # int32 [B] — steps written (+1 at reset)
    last_side_effect: torch.Tensor  # int32 [B]
    baseline_board: torch.Tensor    # int32 [B, H, W]
    #: The episode's own starting board, for episode-end side-effect
    #: samples (the inaction baseline evolves).
    episode_start_board: torch.Tensor  # int32 [B, H, W]


def _wrap(wcfg, env_state):
    """The wrapped state of lanes right after a reset (JAX's
    ``_fresh_wrapper_fields``): the ring holds the start positions, the
    baselines are the start boards."""
    locs = env_state.agent_locs  # [B, A, 2]
    b, dev = locs.shape[0], locs.device
    ring = torch.zeros((b, wcfg.movement_bonus_period) + tuple(locs.shape[1:]),
                       dtype=torch.int32, device=dev)
    ring[:, 0] = locs
    return WrappedState(
        env=env_state, prior_positions=ring,
        prior_count=torch.ones((b,), dtype=torch.int32, device=dev),
        last_side_effect=torch.zeros((b,), dtype=torch.int32, device=dev),
        baseline_board=env_state.board, episode_start_board=env_state.board)


def reset(cfg, wcfg, pool, batch_size, min_perf_fraction=1.0,
          device="cuda", lanes=None):
    """Lane i starts on pool level ``i mod L``; ``pool`` must live on
    ``device``. With ``lanes`` the state holds those lanes of a global
    batch of ``batch_size``. Returns (WrappedState, obs)."""
    require_device(device, pool.device, "the level pool")
    state, obs = E.reset(cfg, pool, batch_size, min_perf_fraction, lanes)
    return _wrap(wcfg, state), obs


def _movement_bonus(wcfg, ring, count, locs, agent_mask):
    """Movement bonus of every lane: [B] in single-agent mode (agent 0's,
    the reference's squeeze), else per agent [B, A]."""
    period = wcfg.movement_bonus_period
    full = count >= period
    # The oldest entry: with a full ring the slot about to be overwritten;
    # before that, slot 0.
    oldest = torch.where(full, count % period, 0).long()
    lanes = torch.arange(ring.shape[0], device=ring.device)
    p1 = ring[lanes, oldest]  # [B, A, 2]
    dist = (locs - p1).abs().sum(-1).to(torch.float32)
    dist = dist + torch.where(full, 0, period - count).to(
        torch.float32)[:, None]
    speed = dist / period
    if wcfg.single_agent:
        speed = (speed[:, :1] * agent_mask[:, :1]).sum(-1)
    # speed ** 1e-100 in float64 is ~(speed > 0); computed float32-safely.
    p = wcfg.movement_bonus_power
    powd = torch.where(
        speed > 0, torch.exp(p * torch.log(torch.clamp(speed, min=1e-30))),
        0.0)
    bonus = wcfg.movement_bonus * powd
    if wcfg.movement_as_penalty:
        bonus = bonus - wcfg.movement_bonus
    return bonus


def _side_effect_count(wcfg, board, baseline_board, goals, exit_mask):
    """int32 [B]: non-player cells of each lane that deviate from its
    baseline."""
    b = board & ~C.PLAYER
    bb = baseline_board & ~C.PLAYER
    b = torch.where(exit_mask, bb, b)  # ignore exit recolouring
    unchanged = b == bb
    if wcfg.ignore_reward_cells:
        red_life = C.ALIVE | C.COLOR_R
        start_red = (bb & red_life) == red_life
        end_red = (b & red_life) == red_life
        goal_cell = (goals & C.RAINBOW_COLOR) == C.COLOR_B
        end_alive = (b & red_life) == C.ALIVE
        non_effects = unchanged | (start_red & ~end_red) | \
            (goal_cell & end_alive)
    else:
        non_effects = unchanged
    return (~non_effects).sum((-1, -2), dtype=torch.int32)


def _shape(wcfg, ring, count, last_se, s, lv, reward, done, times_up,
           baseline, se_penalty_coef):
    """Reward shaping of every lane given the core step's results, in the
    wrappers' order: movement bonus (from the ring before it is written),
    exit bonus, side-effect penalty. Returns (shaped, ring, count, se)."""
    bonus = _movement_bonus(wcfg, ring, count, s.agent_locs, lv.agent_mask)
    shaped = reward + (bonus[:, None] if bonus.dim() == 1 else bonus)
    lanes = torch.arange(ring.shape[0], device=ring.device)
    ring = ring.clone()
    ring[lanes, (count % wcfg.movement_bonus_period).long()] = s.agent_locs
    count = count + 1

    shaped = shaped + torch.where(
        done & ~times_up[:, None], wcfg.exit_bonus * s.episode_reward, 0.0)

    se = _side_effect_count(wcfg, s.board, baseline, s.goals, lv.exit_mask)
    delta = (se - last_se).to(torch.float32)
    shaped = shaped - (delta * se_penalty_coef)[:, None]
    return shaped, ring, count, se


def _fresh_wrapped(cfg, wcfg, pool, idx, min_perf_fraction):
    """Fresh WrappedState from pool levels ``idx`` (int64 [B])."""
    return _wrap(wcfg, E.reset_batch(cfg, pool, idx, min_perf_fraction))


def step(cfg, wcfg, pool, state, actions, generator, se_penalty_coef=0.0,
         min_perf_fraction=1.0, lanes=None):
    """Batched wrapped step. actions int [B, A]; ``generator`` lives on the
    pool's device. Returns (state, obs, shaped reward float32 [B, A],
    done bool [B, A], info)."""
    with span("env/step"):
        # The core step without auto-reset: rewards are shaped from the
        # pre-reset state, then lanes and wrapper fields reset together.
        core_cfg = dataclasses.replace(cfg, auto_reset=False)
        env2, reward, done, info = E.step_core(core_cfg, pool, state.env,
                                               actions, generator, lanes)
        record = (E.all_episode_records if wcfg.exhaustive_se
                  else E.sample_episode_record)
        info["ep_sample"] = record(pool, state.episode_start_board, env2,
                                   info)

        ring, count, last_se, baseline = (
            state.prior_positions, state.prior_count,
            state.last_side_effect, state.baseline_board)
        if wcfg.enabled:
            if wcfg.se_baseline == "inaction":
                # The counterfactual board advances under the spawn
                # probability of the lane's post-step level (K2).
                baseline = E.advance_batch(
                    state.baseline_board,
                    pool.spawn_prob.index_select(0, env2.level_idx),
                    generator, stochastic=not pool.spawner_free,
                    lane_offset=E.lane_offset(lanes))
            lv2 = lane_level(pool, env2.level_idx, env2.min_perf_fraction)
            reward, ring, count, last_se = _shape(
                wcfg, ring, count, last_se, env2, lv2, reward, done,
                info["times_up"], baseline, se_penalty_coef)

        state = WrappedState(
            env=env2, prior_positions=ring, prior_count=count,
            last_side_effect=last_se, baseline_board=baseline,
            episode_start_board=state.episode_start_board)
        if cfg.auto_reset:
            # Fresh lanes take the schedule's fraction, not the lane's own.
            idx = E.reset_picks(env2.level_idx.shape, generator,
                                pool.device, lanes)
            state = E.merge_lane_reset(
                info["lane_done"], idx % pool.num_levels,
                lambda r: _fresh_wrapped(cfg, wcfg, pool, r,
                                         min_perf_fraction), state)
        obs = E._batch_obs(cfg, pool, state.env)
        if wcfg.continuing:
            done = done & info["times_up"][:, None]
        return state, obs, reward, done, info
