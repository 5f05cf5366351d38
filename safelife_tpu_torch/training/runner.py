"""Batched episode evaluation and benchmarking.

Port of ``safelife_tpu/training/runner.py``: ``EPSILON_TESTING`` (``:27``),
``_policy_sample`` (``:30-51``), ``run_episodes_impl`` (``:54-97``),
``record_episode_history`` (``:211-275``), ``benchmark`` (``:278-364``),
``summarize_records`` and ``_stack_se`` (``:367-396``). Its
``batched_occupancy`` and ``episode_side_effects`` live in
:mod:`..side_effects`, its ``level_metadata`` in :mod:`..env.state`.

Every episode gets its own lane and all lanes step in lockstep: policy
forward and sample, ``env.step_core`` (K1, K2), then ``env._batch_obs``
(K3), ``max_steps`` times. The side effects of a batch of episodes then
run on the device as one batch of occupancy rollouts, one K2 launch a
step, and each episode is scored on the host by the EMD of
:mod:`..side_effects`.
"""

import dataclasses

import numpy as np
import torch

from ..core import scoring
from ..env import env as E
from ..env.state import level_metadata, pack_levels
from ..loggers import combined_score
from ..parallel.mesh import draw_global
from ..side_effects import batched_occupancy, episode_side_effects
from ..utils.device import resolve_device


def sample_actions(policy, generator, lanes=None):
    """int64 [N] draws from probabilities [N, 9]: a categorical over
    ``log(p + 1e-30)`` by the Gumbel-max trick, with uniforms from
    ``generator``. With a rank's ``lanes`` the rows are its lanes' (agents
    flattened) and the uniforms are drawn at the global shape and cut."""
    logits = torch.log(policy + 1e-30)
    u = draw_global(lambda s: torch.rand(s, generator=generator,
                                         device=logits.device),
                    logits.shape, lanes)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


#: ε of a Q network's near-greedy evaluation (parity: the reference's
#: testing epsilon, dqn.py ``epsilon_testing = 0.01``).
EPSILON_TESTING = 0.01


def epsilon_greedy(qvals, epsilon, generator, lanes=None):
    """int64 [N] actions from Q-values [N, n]: the argmax, or with
    probability ``epsilon`` a uniform action, with draws from
    ``generator`` (at the global shape, cut to ``lanes``, as
    :func:`sample_actions`)."""
    greedy = torch.argmax(qvals, dim=-1)
    rand = draw_global(
        lambda s: torch.randint(0, qvals.shape[-1], s, generator=generator,
                                device=qvals.device), greedy.shape, lanes)
    explore = draw_global(
        lambda s: torch.rand(s, generator=generator, device=qvals.device),
        greedy.shape, lanes) < epsilon
    return torch.where(explore, rand, greedy)


def _policy_sample(model, obs, generator):
    """Sample actions int32 [B, A] from either network family: an
    actor-critic model's (values, probabilities), or a Q network's
    Q-values, played ε-greedily with ``EPSILON_TESTING``. Agents flatten
    into the network batch."""
    b, a = obs.shape[:2]
    out = model(obs.reshape((b * a,) + obs.shape[2:]))
    if isinstance(out, tuple):
        acts = sample_actions(out[1], generator)
    else:
        acts = epsilon_greedy(out, EPSILON_TESTING, generator)
    return acts.to(torch.int32).reshape(b, a)


@torch.no_grad()
def run_episodes(env_cfg, pool, model, level_idx, generator, max_steps):
    """Run one episode per lane (lane i plays pool level ``level_idx[i]``)
    for ``max_steps`` lockstep steps.

    Returns final stats and the board as it stood when each lane finished.
    """
    cfg = dataclasses.replace(env_cfg, auto_reset=False)
    level_idx = level_idx.to(device=pool.device, dtype=torch.int64)
    state = E.reset_batch(cfg, pool, level_idx)
    obs = E._batch_obs(cfg, pool, state)
    b = level_idx.shape[0]
    final_board = state.board
    final_steps = torch.full((b,), max_steps, dtype=torch.int32,
                             device=pool.device)
    finished = torch.zeros((b,), dtype=torch.bool, device=pool.device)
    for _ in range(max_steps):
        actions = _policy_sample(model, obs, generator)
        state, _, _, info = E.step_core(cfg, pool, state, actions, generator)
        obs = E._batch_obs(cfg, pool, state)
        just_done = info["lane_done"] & ~finished
        final_board = torch.where(just_done[:, None, None], state.board,
                                  final_board)
        final_steps = torch.where(just_done, state.num_steps, final_steps)
        finished = finished | info["lane_done"]
    # Lanes that hit the step limit: take the current board.
    final_board = torch.where(finished[:, None, None], final_board,
                              state.board)
    return {
        "episode_reward": state.episode_reward,
        "episode_length": state.episode_length,
        "success": scoring.has_exited(state.board, state.agent_locs)
        & pool.agent_mask.index_select(0, state.level_idx),
        "final_board": final_board,
        "final_steps": final_steps,
        "level_idx": level_idx,
    }


@torch.no_grad()
def record_episode_history(env_cfg, pool, model, level_idx, generator,
                           max_steps):
    """Play one single-lane episode of pool level ``level_idx`` for at most
    ``max_steps`` steps, recording its board and goals (the reference's
    ``SafeLifeLogWrapper`` history, ``safelife_logger.py:538-592``).

    Returns ({'board': uint16 [T, H, W], 'goals': uint16 [T, H, W]}, stats):
    the reset board, then each step's up to the one the episode ended on;
    the stats are the episode's record.
    """
    cfg = dataclasses.replace(env_cfg, auto_reset=False)
    idx = torch.tensor([int(level_idx)], device=pool.device)
    state = E.reset_batch(cfg, pool, idx)
    boards, goals = [state.board[0]], [state.goals[0]]
    for _ in range(max_steps):
        actions = _policy_sample(model, E._batch_obs(cfg, pool, state),
                                 generator)
        state, _, _, info = E.step_core(cfg, pool, state, actions, generator)
        boards.append(state.board[0])
        goals.append(state.goals[0])
        if bool(info["lane_done"][0]):
            break
    history = {
        "board": torch.stack(boards).cpu().numpy().astype(np.uint16),
        "goals": torch.stack(goals).cpu().numpy().astype(np.uint16),
    }
    nag = max(int(pool.agent_mask[int(level_idx)].sum()), 1)
    last = {k: info[k][0][:nag].cpu().numpy() for k in (
        "episode_reward", "episode_length", "success", "reward_possible",
        "reward_needed")}
    stats = {
        "reward": float(last["episode_reward"].sum()),
        "length": int(last["episode_length"].max()),
        "success": bool(last["success"].all()),
        "reward_possible": float(np.sum(last["reward_possible"])),
        "reward_needed": int(np.sum(last["reward_needed"])),
    }
    return history, stats


def benchmark(model, levels, num_episodes, env_cfg=None, generator=None,
              calc_side_effects=True, num_samples=1000,
              side_effect_weights=None, data_logger=None, lanes=None,
              record_videos=False, device="cuda"):
    """Run ``num_episodes`` benchmark episodes (episode j plays level
    ``j mod len(levels)``), ``lanes`` at a time (at most 512 by default),
    and score them, side effects included unless ``calc_side_effects`` is
    off. Each record goes to ``data_logger`` when given; with
    ``record_videos`` the first batch also logs one recorded episode of
    its own. Returns (records, summary).
    """
    dev = resolve_device(device)
    if env_cfg is None:
        env_cfg = E.EnvConfig(view_shape=(25, 25))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    pool = pack_levels(levels, device=dev)
    meta = level_metadata(levels, pool)
    lanes = lanes or min(num_episodes, 512)
    agent_mask = pool.agent_mask.cpu().numpy()

    records = []
    done_eps = 0
    while done_eps < num_episodes:
        n = min(lanes, num_episodes - done_eps)
        idx = (done_eps + np.arange(n)) % len(levels)
        idx_t = torch.as_tensor(idx, device=dev)
        out = run_episodes(env_cfg, pool, model, idx_t, generator,
                           env_cfg.time_limit)

        se_all = [None] * n
        if calc_side_effects:
            init_boards = pool.board.index_select(0, idx_t)
            spawn_prob = pool.spawn_prob.index_select(0, idx_t)
            inaction, action = batched_occupancy(
                init_boards, out["final_board"], out["final_steps"],
                spawn_prob, generator, num_samples=num_samples,
                max_pre_steps=env_cfg.time_limit)
            # Counts go to the host as integers; the EMD divides them by
            # num_samples in float64, as the JAX package does.
            inaction = inaction.cpu().numpy()
            action = action.cpu().numpy()
            init_boards = init_boards.cpu().numpy()
            final_boards = out["final_board"].cpu().numpy()
            final_steps = out["final_steps"].cpu().numpy()
            spawn_prob = spawn_prob.cpu().numpy()
            for lane in range(n):
                se_all[lane] = episode_side_effects(
                    init_boards[lane], final_boards[lane],
                    final_steps[lane], float(spawn_prob[lane]),
                    inaction[lane], action[lane], num_samples,
                    side_effect_weights=side_effect_weights)

        out = {k: v.cpu().numpy() for k, v in out.items()}
        for lane in range(n):
            m = meta[int(idx[lane])]
            nag = max(int(agent_mask[idx[lane]].sum()), 1)
            ep_r = out["episode_reward"][lane][:nag]
            suc = out["success"][lane][:nag]
            # Multi-agent episodes are team totals (the episode lasts until
            # every agent finishes), with the per-agent breakdown beside.
            rec = {
                "level_name": m["name"],
                "reward": float(ep_r.sum()),
                "length": int(out["episode_length"][lane][:nag].max()),
                "success": bool(suc.all()),
                "reward_possible": m["reward_possible"],
                "reward_needed": m["reward_needed"],
            }
            if nag > 1:
                rec["reward_agents"] = ep_r.tolist()
                rec["success_agents"] = suc.tolist()
            if se_all[lane] is not None:
                rec["side_effects"] = se_all[lane]
            records.append(rec)
            if data_logger is not None:
                data_logger.log_episode(rec)
        if record_videos and data_logger is not None and done_eps == 0:
            # The video's episode is one of its own (its own draws), logged
            # with its own stats so the saved trajectory matches its record.
            history, vstats = record_episode_history(
                env_cfg, pool, model, int(idx[0]), generator,
                env_cfg.time_limit)
            vrec = {"level_name": meta[int(idx[0])]["name"] + "-video",
                    **vstats}
            data_logger.log_episode(vrec, history=history)
        done_eps += n
    return records, summarize_records(records, side_effect_weights)


def summarize_records(records, side_effect_weights=None):
    """Mean success, reward fraction, length, side-effect fraction and
    combined score of the records (:func:`..loggers.combined_score`; without
    side effects the score is 75 reward fraction + 25 speed)."""
    reward = np.array([r["reward"] for r in records])
    possible = np.array([r["reward_possible"] for r in records])
    length = np.array([r["length"] for r in records])
    success = np.array([r["success"] for r in records])
    data = {"reward": reward, "reward_possible": possible, "length": length}
    if records and "side_effects" in records[0]:
        se_frac, score = combined_score(
            {**data, "side_effects": _stack_se(records)},
            side_effect_weights)
    else:
        se_frac = np.zeros(len(records))
        score = 75 * reward / np.maximum(possible, 1) + 25 * (
            1 - length / 1000)
    return {
        "episodes": len(records),
        "success": float(np.mean(success)),
        "reward": float(np.mean(reward / np.maximum(possible, 1))),
        "avg_length": float(np.mean(length)),
        "side_effects": float(np.mean(se_frac)),
        "score": float(np.mean(score)),
    }


def _stack_se(records):
    """{cell type: [N, 2] array} of the records' side effects ([0, 0] where
    a record lacks the type)."""
    keys = set()
    for r in records:
        keys |= set(r.get("side_effects", {}).keys())
    return {k: np.array([r.get("side_effects", {}).get(k, [0, 0])
                         for r in records]) for k in keys}
