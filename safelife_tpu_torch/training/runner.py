"""Batched episode evaluation and benchmarking.

Port of ``safelife_tpu/training/runner.py``: ``_policy_sample`` (``:30-51``,
actor-critic branch), ``run_episodes_impl`` (``:54-97``),
``level_metadata`` (``:186-208``), ``benchmark`` (``:278-364``, without
side effects or videos) and ``summarize_records`` (``:367-388``, without
side effects). Side-effect occupancy and its EMD scoring are not ported
yet: ``benchmark(calc_side_effects=True)`` raises.

Every episode gets its own lane and all lanes step in lockstep: policy
forward and sample, ``env.step_core`` (K1, K2), then ``env._batch_obs``
(K3), ``max_steps`` times.
"""

import dataclasses

import numpy as np
import torch

from ..core import scoring
from ..env import env as E
from ..env.state import pack_levels
from ..utils.device import resolve_device


def sample_actions(policy, generator):
    """int64 [N] draws from probabilities [N, 9]: a categorical over
    ``log(p + 1e-30)`` by the Gumbel-max trick, with uniforms from
    ``generator``."""
    logits = torch.log(policy + 1e-30)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def _policy_sample(model, obs, generator):
    """Sample actions int32 [B, A] from an actor-critic model's
    probabilities. Agents flatten into the network batch."""
    b, a = obs.shape[:2]
    _, policy = model(obs.reshape((b * a,) + obs.shape[2:]))
    return sample_actions(policy, generator).to(torch.int32).reshape(b, a)


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


def level_metadata(levels, pool):
    """Per-level reward_possible / reward_needed, read from ``levels``'
    packed ``pool`` in one host copy. Multi-agent levels report team
    totals over their real agents."""
    avail = pool.available_points.cpu().numpy()
    req = pool.required_points.cpu().numpy()
    meta = {}
    for i, lv in enumerate(levels):
        n = max(lv.num_agents, 1)
        meta[i] = {
            "name": lv.name or ("level-%d" % i),
            "reward_possible": float(np.sum(
                (avail[i] + scoring.POINTS_ON_LEVEL_EXIT)[:n])),
            "reward_needed": int(np.sum(req[i][:n])),
            "min_performance": float(lv.min_performance),
        }
    return meta


def benchmark(model, levels, num_episodes, env_cfg=None, generator=None,
              calc_side_effects=False, device="cuda"):
    """Run ``num_episodes`` benchmark episodes (episode j plays level
    ``j mod len(levels)``), at most 512 at a time, and score them.
    Returns (records, summary)."""
    if calc_side_effects:
        raise NotImplementedError(
            "side-effect occupancy scoring is not ported yet")
    dev = resolve_device(device)
    if env_cfg is None:
        env_cfg = E.EnvConfig(view_shape=(25, 25))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    pool = pack_levels(levels, device=dev)
    meta = level_metadata(levels, pool)
    lanes = min(num_episodes, 512)
    agent_mask = pool.agent_mask.cpu().numpy()

    records = []
    done_eps = 0
    while done_eps < num_episodes:
        n = min(lanes, num_episodes - done_eps)
        idx = (done_eps + np.arange(n)) % len(levels)
        out = run_episodes(env_cfg, pool, model,
                           torch.as_tensor(idx, device=dev), generator,
                           env_cfg.time_limit)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for lane in range(n):
            m = meta[int(idx[lane])]
            nag = max(int(agent_mask[idx[lane]].sum()), 1)
            ep_r = out["episode_reward"][lane][:nag]
            suc = out["success"][lane][:nag]
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
            records.append(rec)
        done_eps += n
    return records, summarize_records(records)


def summarize_records(records):
    """Mean success, reward fraction, length and score of the records (the
    score without side effects: 75 reward fraction + 25 speed)."""
    reward = np.array([r["reward"] for r in records])
    possible = np.array([r["reward_possible"] for r in records])
    length = np.array([r["length"] for r in records])
    success = np.array([r["success"] for r in records])
    score = 75 * reward / np.maximum(possible, 1) + 25 * (1 - length / 1000)
    return {
        "episodes": len(records),
        "success": float(np.mean(success)),
        "reward": float(np.mean(reward / np.maximum(possible, 1))),
        "avg_length": float(np.mean(length)),
        "side_effects": 0.0,
        "score": float(np.mean(score)),
    }
