"""PPO actor-learner on the batched lockstep env.

Port of ``safelife_tpu/training/ppo.py``: ``PPOConfig`` (``:33-48``),
``PPOState`` (``:51-55``), ``make_optimizer`` and ``init_ppo_state``
(``:58-65``), ``_flatten_agents`` (``:72-74``), ``rollout`` (``:77-138``),
``compute_gae`` (``:141-173``), ``calculate_loss`` (``:180-219``),
``_minibatch_bounds`` (``:222-227``), ``train_on_batch`` (``:230-286``),
``train_iteration_impl`` (``:289-335``) and ``train_chunk_impl``
(``:344-373``). Math of the reference (``training/ppo.py``):

* advantages ``adv[t] = (r[t] + γ·v[t+1] − v[t]) + λ·adv[t+1]``: the tail
  is multiplied by λ alone, and episode ends cut the recursion;
* returns: discounted reward sums bootstrapped by the final value only
  where the trajectory did not end;
* the policy loss in ratio-difference form
  ``|adv| · max(sign(adv)·(1 − π/π_old), −ε)``, the clipped value loss,
  and an entropy bonus clipped at ``entropy_clip``;
* 3 epochs over the batch, each in ``num_minibatches + 1`` slices.

One iteration is a rollout of ``steps_per_env`` wrapped steps (kernels K1,
K2 and K3 on CUDA, through :mod:`..env.wrappers`), GAE, then the Adam
minibatch updates. The network's forward, backward and optimizer step run
in the network's precision (:func:`..models.nets.learner_precision`;
strict float32, no TF32, by default). Randomness comes
from one ``torch.Generator`` on the pool's device; ``actions`` and
``perms`` inject the draws instead (tests replay the JAX package's).

Sharded over ranks (a rank's ``lanes``, :mod:`..parallel.mesh`), a
rank rolls out its own lanes and keeps its trajectory. The learner is
replicated: each epoch's permutation runs over the global sample count,
drawn alike on every rank, and a rank takes the samples of each global
minibatch that lie in its lanes. A minibatch's loss is the global one:
each rank's weighted sums of the three terms and of the weights are
all-reduced (:func:`calculate_loss`), so the entropy clamp takes the
branch of the global mean on every rank; the gradients are then summed
over the ranks (``allreduce_grads``) and every rank takes the same Adam
step. The iteration's metrics are global on every rank.
"""

import dataclasses

import numpy as np
import torch

from ..env import wrappers as W
from ..models.nets import learner_precision
from ..parallel import mesh as M
from ..utils.device import require_device
from ..utils.trace import span
from .runner import sample_actions


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    steps_per_env: int = 20
    num_minibatches: int = 4
    epochs_per_batch: int = 3
    gamma: float = 0.97
    lmda: float = 0.95
    learning_rate: float = 3e-4
    entropy_reg: float = 0.01
    entropy_clip: float = 1.0
    vf_coef: float = 0.5
    eps_policy: float = 0.2
    eps_value: float = 0.2
    report_interval: int = 960


@dataclasses.dataclass
class PPOState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    num_steps: int = 0  # env steps (lanes x steps), not agent samples


def make_optimizer(cfg, model):
    """Adam with optax ``adam``'s defaults."""
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def _model_device(model):
    return next(model.parameters()).device


def init_ppo_state(cfg, model, device="cuda"):
    """A fresh learner around ``model``, whose parameters live on
    ``device``."""
    require_device(device, _model_device(model), "the model")
    return PPOState(model=model, optimizer=make_optimizer(cfg, model))


# ---------------------------------------------------------------------------
# Rollout


def _flatten_agents(x):
    """[B, A, ...] -> [B*A, ...] (the learner batch axis)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


#: The per-step episode records a training step keeps for the episode
#: logger (``EpisodeCollector.observe``).
EPISODE_KEYS = ("lane_done", "episode_reward", "episode_length", "success",
                "level_idx", "agent_mask", "reward_possible", "reward_needed")


def _stack(steps):
    """A list of (nested dicts of) tensors -> the same with [T, ...]."""
    if isinstance(steps[0], dict):
        return {k: _stack([s[k] for s in steps]) for k in steps[0]}
    return torch.stack(steps)


@torch.no_grad()
def rollout(env_cfg, wcfg, pool, model, ws, obs, generator, n_steps,
            se_penalty_coef=0.0, min_perf_fraction=1.0, actions=None,
            lanes=None):
    """Collect ``n_steps`` of experience from every lane.

    obs: the env's observations [B, A, ...]. Agents flatten into the
    learner batch ([B, A] -> [B*A]); ``weight`` masks padded agents and
    agents already finished before the step. ``actions`` int [T, B, A], if
    given, replaces the sampled actions. With a rank's ``lanes`` the
    state and observations are those lanes' of the global batch.

    Returns (traj dict of [T, B*A, ...] tensors, final (ws, obs), final
    values [B*A]).
    """
    with span("ppo/rollout"):
        out = []
        for t in range(n_steps):
            b, a = obs.shape[:2]
            flat_obs = _flatten_agents(obs)
            weight = _flatten_agents(
                ws.env.is_active
                & pool.agent_mask.index_select(0, ws.env.level_idx)
            ).to(torch.float32)
            with span("policy/sample"):
                values, policy = model(flat_obs)
                if actions is None:
                    act = sample_actions(policy, generator, lanes)
                else:
                    act = actions[t].reshape(-1).to(device=policy.device,
                                                    dtype=torch.int64)
                a_prob = policy.gather(-1, act[:, None])[:, 0]
            ws, obs, reward, done, info = W.step(
                env_cfg, wcfg, pool, ws, act.reshape(b, a), generator,
                se_penalty_coef, min_perf_fraction, lanes)
            out.append({
                "obs": flat_obs,
                "actions": act,
                "action_prob": a_prob,
                "rewards": _flatten_agents(reward),
                "values": values,
                "done": _flatten_agents(done),
                "weight": weight,
                "ep": {k: info[k] for k in EPISODE_KEYS}
                | {"sample": info["ep_sample"]},
            })
        final_values, _ = model(_flatten_agents(obs))
        return _stack(out), (ws, obs), final_values


def compute_gae(cfg, traj, final_values):
    """(returns, advantages) [T, N] with the reference's recursions."""
    rewards = traj["rewards"]
    values = traj["values"]
    not_done = (~traj["done"]).to(torch.float32)
    boot = final_values * not_done[-1]
    # v[t+1] within an episode; 0 across boundaries and at the (done) end.
    val1 = torch.cat([values[1:], final_values[None]], 0) * not_done
    delta = rewards + cfg.gamma * val1 - values

    adv = torch.empty_like(delta)
    ret = torch.empty_like(rewards)
    a, r = torch.zeros_like(delta[-1]), boot
    for t in reversed(range(rewards.shape[0])):
        a = delta[t] + cfg.lmda * not_done[t] * a
        r = rewards[t] + cfg.gamma * not_done[t] * r
        adv[t], ret[t] = a, r
    return ret, adv


# ---------------------------------------------------------------------------
# Loss and update


def _loss_terms(cfg, model, obs, actions, old_policy, old_values, returns,
                advantages):
    """Per-sample (policy, value, entropy) terms of the loss."""
    values, policy = model(obs)
    a_policy = policy.gather(-1, actions[..., None])[..., 0]
    prob_diff = torch.sign(advantages) * (1 - a_policy / old_policy)
    policy_term = torch.abs(advantages) * torch.clamp(
        prob_diff, min=-cfg.eps_policy)
    v_clip = old_values + torch.clamp(values - old_values, -cfg.eps_value,
                                      cfg.eps_value)
    value_term = torch.maximum((v_clip - returns) ** 2,
                               (values - returns) ** 2)
    entropy = torch.sum(-policy * torch.log(policy + 1e-12), -1)
    return policy_term, value_term, entropy


def _combine(cfg, policy_loss, value_loss, entropy_mean):
    entropy_loss = -cfg.entropy_reg * torch.clamp(entropy_mean,
                                                  max=cfg.entropy_clip)
    loss = policy_loss + value_loss * cfg.vf_coef + entropy_loss
    return loss, {"loss": loss, "policy_loss": policy_loss,
                  "value_loss": value_loss, "entropy": entropy_mean}


def calculate_loss(cfg, model, obs, actions, old_policy, old_values, returns,
                   advantages, weight=None):
    """(loss, metrics) of a minibatch, of which these rows are the rank's
    (possibly none). ``weight`` masks samples out of every mean (padded
    or already-finished agents); ``None`` means all ones. The weighted
    sums of the three terms and of the weights are summed over the ranks,
    so the loss's value is the global one, equal on every rank, and the
    entropy clamp follows the global mean; the gradient is that of the
    rank's own rows, which the ranks then sum (``allreduce_grads``). In
    one process both are the minibatch's own."""
    if weight is None:
        weight = torch.ones_like(advantages)
    if weight.numel():
        terms = _loss_terms(cfg, model, obs, actions, old_policy, old_values,
                            returns, advantages)
        sums = torch.stack([torch.sum(x * weight) for x in terms])
    else:
        sums = torch.zeros(3, device=weight.device)
    tot = M.all_reduce_sum(
        torch.cat([sums.detach(), weight.sum().reshape(1)]))
    wsum = torch.clamp(tot[3], min=1.0)
    # Value: the global sums, exactly; gradient: the rank's rows'.
    return _combine(cfg, *((tot[:3] + (sums - sums.detach())) / wsum))


@dataclasses.dataclass(frozen=True)
class SampleShard:
    """A rank's rows of the global learner batch of a sharded iteration."""

    index: torch.Tensor   # int64 [n]: the global sample index of each row
    total: int            # the global sample count


def sample_shard(steps, agents, lanes, device):
    """The :class:`SampleShard` of a rank holding ``lanes``: its rows are
    ``[T, b, A]`` flattened, the global samples ``[T, B, A]`` flattened."""
    t = torch.arange(steps, device=device)[:, None, None]
    lane = torch.arange(lanes.start, lanes.stop,
                        device=device)[None, :, None]
    a = torch.arange(agents, device=device)[None, None, :]
    index = ((t * lanes.total + lane) * agents + a).reshape(-1)
    return SampleShard(index, steps * lanes.total * agents)


def _batch_loss(cfg, model, batch, chunk):
    """:func:`calculate_loss` over the whole (global) batch without a
    graph, in chunks of ``chunk`` samples (the unpacked views of all
    samples at once would take gigabytes)."""
    n = batch["obs"].shape[0]
    chunk = max(chunk, 1)
    sums = torch.zeros(3, device=batch["advantages"].device)
    with torch.no_grad(), learner_precision(
            model.precision, batch["advantages"].device.type, min(n, chunk)):
        for lo in range(0, n, chunk):
            mb = {k: v[lo:lo + chunk] for k, v in batch.items()}
            terms = _loss_terms(cfg, model, mb["obs"], mb["actions"],
                                mb["action_prob"], mb["values"],
                                mb["returns"], mb["advantages"])
            sums += torch.stack([torch.sum(x * mb["weight"]) for x in terms])
    sums = M.all_reduce_sum(
        torch.cat([sums, batch["weight"].sum().reshape(1)]))
    return _combine(cfg, *(sums[:3] / torch.clamp(sums[3], min=1.0)))


def _minibatch_bounds(n, num_minibatches):
    """The reference's split points (ppo.py:170-172): linspace interior
    points -> num_minibatches + 1 slices."""
    pts = np.linspace(0, n, num_minibatches + 2, dtype=int)
    bounds = [0] + list(pts[1:-1]) + [n]
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def _shard_minibatches(perm, bounds, local_of):
    """The rank's local rows of each global minibatch of ``perm``, in the
    permutation's order (two host syncs an epoch)."""
    pos = local_of.index_select(0, perm)
    keep = pos >= 0
    ends = torch.tensor([b for _, b in bounds], device=perm.device) - 1
    counts = torch.cumsum(keep.to(torch.int64), 0).index_select(0, ends)
    rows = pos[keep]
    out, start = [], 0
    for end in counts.tolist():
        out.append(rows[start:end])
        start = end
    return out


def train_on_batch(cfg, ppo_state, batch, generator, perms=None,
                   shard=None):
    """``epochs_per_batch`` epochs of shuffled minibatch Adam steps over a
    flattened batch (dict of [N, ...] tensors). Each epoch draws a
    permutation with ``torch.randperm`` on ``generator``, or takes
    ``perms[epoch]``. With a ``shard`` (:class:`SampleShard`) the batch is
    the rank's rows of a global batch, the permutations run over the
    global samples and each minibatch's loss and gradients are global.
    Updates ``ppo_state`` in place and returns it."""
    model, opt = ppo_state.model, ppo_state.optimizer
    n = batch["obs"].shape[0] if shard is None else shard.total
    dev = batch["obs"].device
    bounds = _minibatch_bounds(n, cfg.num_minibatches)
    if shard is not None:
        local_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
        local_of[shard.index] = torch.arange(shard.index.shape[0],
                                             device=dev)
    # A rank's share of a global minibatch changes width from one to the
    # next, and each new width would search anew: the heuristic's picks.
    width = None if shard is not None else min(b - a for a, b in bounds)
    with span("ppo/update"), learner_precision(model.precision, dev.type,
                                               width):
        for epoch in range(cfg.epochs_per_batch):
            if perms is None:
                perm = torch.randperm(n, generator=generator, device=dev)
            else:
                perm = torch.as_tensor(perms[epoch], device=dev).long()
            rows = ([perm[a:b] for a, b in bounds] if shard is None
                    else _shard_minibatches(perm, bounds, local_of))
            for idx in rows:
                with span("ppo/minibatch"):
                    mb = {k: v.index_select(0, idx)
                          for k, v in batch.items()}
                    loss, _ = calculate_loss(
                        cfg, model, mb["obs"], mb["actions"],
                        mb["action_prob"], mb["values"], mb["returns"],
                        mb["advantages"], mb["weight"])
                    opt.zero_grad(set_to_none=False)
                    if idx.numel():
                        loss.backward()
                    M.allreduce_grads(model)
                    opt.step()
    return ppo_state


def flatten_batch(traj, returns, advantages):
    """The learner batch: [T, N, ...] trajectory fields -> [T*N, ...]."""
    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))

    return {
        "obs": flat(traj["obs"]),
        "actions": flat(traj["actions"]),
        "action_prob": flat(traj["action_prob"]),
        "values": flat(traj["values"]),
        "returns": flat(returns),
        "advantages": flat(advantages),
        "weight": flat(traj["weight"]),
    }


def train_iteration(env_cfg, wcfg, ppo_cfg, pool, ppo_state, ws, obs,
                    generator, se_penalty_coef=0.0, min_perf_fraction=1.0,
                    actions=None, perms=None, device="cuda", lanes=None):
    """One PPO iteration: rollout -> GAE -> minibatch updates, then the
    loss metrics of the whole batch under the updated parameters. The pool
    and the model live on ``device``. With a rank's ``lanes`` the state is
    those lanes', the update and the scalar metrics global (collectives
    over the default process group); ``actions`` are then the rank's
    lanes'.

    Returns (ppo_state, ws, obs, metrics): the metrics hold 0-dim tensors,
    ``episodes`` (each lane's episode record of every step, [T*B, ...])
    and ``ep_samples`` ([T, ...]).
    """
    with span("ppo/iteration"):
        require_device(device, pool.device, "the level pool")
        require_device(device, _model_device(ppo_state.model), "the model")
        n_lanes = obs.shape[0]
        traj, (ws, obs), final_values = rollout(
            env_cfg, wcfg, pool, ppo_state.model, ws, obs, generator,
            ppo_cfg.steps_per_env, se_penalty_coef, min_perf_fraction,
            actions, lanes)
        with span("ppo/gae"):
            returns, advantages = compute_gae(ppo_cfg, traj, final_values)
            t = traj["rewards"].shape[0]
            batch = flatten_batch(traj, returns, advantages)
            shard = None if lanes is None else sample_shard(
                t, traj["rewards"].shape[1] // n_lanes, lanes,
                batch["obs"].device)
        train_on_batch(ppo_cfg, ppo_state, batch, generator, perms, shard)
        # Step counting is per env step, not per agent slot.
        ppo_state.num_steps += t * (n_lanes if lanes is None
                                    else lanes.total)

        with span("ppo/metrics"):
            chunk = _minibatch_bounds(batch["obs"].shape[0],
                                      ppo_cfg.num_minibatches)[0][1]
            _, metrics = _batch_loss(ppo_cfg, ppo_state.model, batch, chunk)
            w = batch["weight"]
            sums = torch.stack([w.sum()] + [
                torch.sum(x * w) for x in (traj["rewards"].reshape(-1),
                                           batch["values"],
                                           batch["advantages"])])
            sums = M.all_reduce_sum(sums)
            wsum = torch.clamp(sums[0], min=1.0)
            metrics["reward_mean"] = sums[1] / wsum
            metrics["values_mean"] = sums[2] / wsum
            metrics["advantages_mean"] = sums[3] / wsum
        ep = dict(traj["ep"])
        metrics["ep_samples"] = ep.pop("sample")
        metrics["episodes"] = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                               for k, v in ep.items()}
        return ppo_state, ws, obs, metrics


def train_chunk(env_cfg, wcfg, ppo_cfg, pool, ppo_state, ws, obs, generator,
                n_iters, se_penalty_coef=0.0, min_perf_fraction=1.0,
                device="cuda", lanes=None):
    """``n_iters`` iterations. The episode records and side-effect samples
    are concatenated over the chunk; the scalar metrics are the last
    iteration's."""
    runs = []
    for _ in range(n_iters):
        ppo_state, ws, obs, metrics = train_iteration(
            env_cfg, wcfg, ppo_cfg, pool, ppo_state, ws, obs, generator,
            se_penalty_coef, min_perf_fraction, device=device, lanes=lanes)
        runs.append(metrics)
    metrics = dict(runs[-1])
    for key in ("episodes", "ep_samples"):
        metrics[key] = {k: torch.cat([r[key][k] for r in runs])
                        for k in runs[-1][key]}
    return ppo_state, ws, obs, metrics
