"""DQN with a device-resident replay buffer.

Port of ``safelife_tpu/training/dqn.py``: ``DQNConfig`` (``:24-40``),
``epsilon_schedule`` (``:43-48``), ``ReplayBuffer`` and ``init_replay``
(``:51-76``), ``push_masked`` (``:79-93``), ``TrajectoryState``,
``init_trajectories`` and ``step_trajectories`` (``:96-190``),
``push_emissions`` (``:193-216``), ``td_loss`` (``:219-239``),
``DQNState`` and ``init_dqn_state`` (``:242-261``), ``act_epsilon_greedy``
(``:264-271``), ``collect_and_optimize_impl`` (``:274-361``, as
:func:`collect` then :func:`optimize`) and ``train_chunk_impl``
(``:369-386``). Math of the reference (``training/dqn.py``): multi-step
(5) returns assembled per lane, a uniform replay (100k), ε-greedy on a
piecewise-linear schedule (1 -> 0.5 -> 0.03 over 5e4 / 5e5 / 4e6 steps),
the target network synced every 10k steps, the dueling Q network, the
squared TD error.

Replay writes. JAX materialises each step's [K, N, ...] candidate entries
(K = n + 2: outgoing-normal, outgoing-terminal, then the ring flushed
0..n-1) and scatters them, invalid ones to a dropped slot. Here a step's
emissions hold its [K, N] validity, actions, rewards and done flags, and
references to the tensors its views come from: the ring before the step,
the step's observation and the next one. A push takes the valid positions
of the flattened [T, K, N] planes, in arrival order, with one ``nonzero``
(the push's one host sync, which also tells the host the push count, so
that ``idx``, the size and whether the buffer is warm need no other),
keeps the last ``capacity`` of them (what JAX's capacity-sized segments
leave: the newest entry overwrites the oldest) and gathers each kept
entry's views from its source into its slot. Only kept rows are written:
at 4096 lanes about 20 MB a step, where seven copies of every view would
be 143 MB.

The network's forward, backward and Adam step run in the network's
precision (:func:`..models.nets.learner_precision`). Observations are
stored as the env emits them: packed int32 views, or uint8 channels with
``packed_obs`` off. Randomness comes from one ``torch.Generator`` on the
pool's device; ``actions`` and ``sample_idx`` inject the draws instead
(tests replay the JAX package's).

Sharded over ranks (a rank's ``lanes``, :mod:`..parallel.mesh`), each
rank keeps the n-step rings of its own lanes, and the replay is
replicated: a unit's emissions are gathered from every rank and pushed in
global lane order (:func:`push_emissions`), so every rank's replay
equals the one-process replay. The sample indices come from the generator
that every rank seeds alike, so every rank takes the same Adam step;
rank 0's gradients are broadcast before it, which keeps the parameters
bitwise equal where a library's backward does not sum in a fixed order.

Under a profiler a unit opens the spans ``dqn/unit``
(:func:`collect_and_optimize`), ``dqn/collect``, ``dqn/push`` (inside
it) and ``dqn/optimize`` (:mod:`..utils.trace`). :func:`replay_counts`
counts the replay rows pushed (every valid entry, ``idx``'s advance) and
sampled into learner batches, as ``ops.launch_counts`` counts launches.
"""

import copy
import dataclasses
import functools

import torch

from ..env import wrappers as W
from ..models.nets import learner_precision
from ..parallel import mesh as M
from ..utils.device import require_device, resolve_device
from ..utils.trace import span
from .ppo import (EPISODE_KEYS, _flatten_agents, _model_device, _stack,
                  make_optimizer)
from .runner import epsilon_greedy


#: Replay rows since the last :func:`reset_replay_counts`: "pushed", the
#: valid entries of every push (the last ``capacity`` of them written),
#: and "sampled", the rows gathered into learner batches.
_ROWS = {"pushed": 0, "sampled": 0}


def reset_replay_counts():
    for name in _ROWS:
        _ROWS[name] = 0


def replay_counts():
    """Replay rows pushed and sampled since the last reset, by name."""
    return dict(_ROWS)


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    gamma: float = 0.97
    multi_step: int = 5
    batch_size: int = 96
    optimize_interval: int = 32
    learning_rate: float = 3e-4
    epsilon_points: tuple = ((5e4, 1.0), (5e5, 0.5), (4e6, 0.03))
    epsilon_testing: float = 0.01
    replay_initial: int = 40000
    replay_size: int = 100000
    target_update_interval: int = 10000
    # Reporting cadence in env steps; ``dqn.report_interval`` in the global
    # config overrides.
    report_interval: int = 4096


def epsilon_schedule(cfg, step):
    """Piecewise-linear ε with constant extrapolation, in float32 as
    ``jnp.interp`` computes it: a float32 tensor of ``step``'s shape
    (parity: the UnivariateSpline(k=1, ext='const') at dqn.py:51-54)."""
    xs = torch.tensor([p[0] for p in cfg.epsilon_points], dtype=torch.float32)
    ys = torch.tensor([p[1] for p in cfg.epsilon_points], dtype=torch.float32)
    x = torch.as_tensor(step, dtype=torch.float32)
    i = torch.searchsorted(xs, x.reshape(-1), right=True).clamp(
        1, len(xs) - 1).reshape(x.shape)
    f = ys[i - 1] + ((x - xs[i - 1]) / (xs[i] - xs[i - 1])) * (
        ys[i] - ys[i - 1])
    f = torch.where(x < xs[0], ys[0], f)
    return torch.where(x > xs[-1], ys[-1], f)


@dataclasses.dataclass
class ReplayBuffer:
    obs: torch.Tensor       # [cap, ...obs]
    action: torch.Tensor    # [cap] int32
    reward: torch.Tensor    # [cap] float32
    next_obs: torch.Tensor  # [cap, ...obs]
    done: torch.Tensor      # [cap] bool
    idx: int = 0            # total pushes (slots mod capacity), on the host

    @property
    def capacity(self):
        return self.obs.shape[0]

    def size(self):
        return min(self.idx, self.capacity)


def init_replay(capacity, obs_shape, obs_dtype=torch.uint8, device="cuda"):
    dev = resolve_device(device)
    return ReplayBuffer(
        obs=torch.zeros((capacity,) + tuple(obs_shape), dtype=obs_dtype,
                        device=dev),
        action=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        reward=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        next_obs=torch.zeros((capacity,) + tuple(obs_shape), dtype=obs_dtype,
                             device=dev),
        done=torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )


def _land(buf, valid):
    """The entries a push of ``valid`` (any shape, flattened in arrival
    order) writes: (their flat positions, their slots). The last
    ``capacity`` valid entries, so slots are distinct and the newest entry
    wins; advances ``buf.idx`` by every valid entry. One host sync."""
    pos = torch.nonzero(valid.reshape(-1))[:, 0]
    count = pos.shape[0]
    first = max(count - buf.capacity, 0)
    slots = (buf.idx + torch.arange(first, count, device=pos.device)) \
        % buf.capacity
    buf.idx += count
    _ROWS["pushed"] += count
    return pos[first:], slots


def _write(buf, slots, **fields):
    for name, rows in fields.items():
        dst = getattr(buf, name)
        dst.index_copy_(0, slots, rows.to(dst.dtype))


def push_masked(buf, obs, action, reward, next_obs, done, valid):
    """Append the ``valid`` entries of [M, ...] candidates in arrival
    order (others skipped), in place. Returns ``buf``."""
    pos, slots = _land(buf, valid)
    _write(buf, slots, obs=obs.index_select(0, pos),
           action=action.index_select(0, pos),
           reward=reward.index_select(0, pos),
           next_obs=next_obs.index_select(0, pos),
           done=done.index_select(0, pos))
    return buf


@dataclasses.dataclass
class TrajectoryState:
    """Per-lane n-step assembly ring (parity: dqn.py:82-134). Slot 0 is the
    newest step; rewards accumulate discounted future rewards in place."""

    obs: torch.Tensor     # [B, n, ...obs]
    action: torch.Tensor  # [B, n] int32
    reward: torch.Tensor  # [B, n] float32
    filled: torch.Tensor  # [B, n] bool


def init_trajectories(batch, n, obs_shape, obs_dtype=torch.uint8,
                      device="cuda"):
    dev = resolve_device(device)
    return TrajectoryState(
        obs=torch.zeros((batch, n) + tuple(obs_shape), dtype=obs_dtype,
                        device=dev),
        action=torch.zeros((batch, n), dtype=torch.int32, device=dev),
        reward=torch.zeros((batch, n), dtype=torch.float32, device=dev),
        filled=torch.zeros((batch, n), dtype=torch.bool, device=dev),
    )


@functools.lru_cache(maxsize=None)
def _discounts(gamma, n, device):
    """float64 [n] on ``device``: 0, then gamma^1 .. gamma^(n-1) as float32
    powers. Made once a (gamma, n, device): a copy to the card every step
    would make the host wait for the device every step."""
    gammas = torch.tensor(gamma, dtype=torch.float32) ** torch.arange(
        1, n, dtype=torch.float32)
    return torch.cat([torch.zeros(1), gammas]).double().to(device)


def step_trajectories(cfg, traj, obs, action, reward, next_obs, done,
                      valid=None):
    """Advance the n-step rings one step; emit replay-entry candidates.

    Per slot (a lane, or a flattened lane x agent pair): the outgoing
    (oldest) entry emits with its accumulated n-step reward; on episode
    end the whole ring flushes (a terminal state bootstraps nothing) and
    clears. Steps with ``valid`` False (padded or already-finished agents)
    enter the ring unfilled and are never emitted.

    Returns (traj, emissions): ``emissions`` holds [K, N] planes
    ``action``, ``reward``, ``done`` and ``valid``, K = n + 2 candidates a
    slot in arrival order (outgoing-normal, outgoing-terminal, ring flush
    0..n-1), and the tensors their views come from: ``ring`` (the rings
    before the step), ``obs`` and ``next_obs``. Entry k's view is the
    ring's oldest slot for k < 2, ``obs`` for k = 2 and ring slot k - 3
    after; its next view is ``obs`` for k = 0, else ``next_obs``.
    :func:`push_emissions` writes a chunk's emissions in one push.
    """
    n = cfg.multi_step
    if valid is None:
        valid = torch.ones_like(done)
    action = action.to(traj.action.dtype)
    out_action = traj.action[:, -1]
    out_reward = traj.reward[:, -1]
    out_valid = traj.filled[:, -1]

    # Shift and insert the new step at slot 0.
    new_obs = torch.cat([obs[:, None].to(traj.obs.dtype), traj.obs[:, :-1]],
                        1)
    new_action = torch.cat([action[:, None], traj.action[:, :-1]], 1)
    shifted_reward = torch.cat([reward[:, None], traj.reward[:, :-1]], 1)
    new_filled = torch.cat([valid[:, None], traj.filled[:, :-1]], 1)
    # Discount the new reward into the older entries, rounded once as the
    # fused multiply-add that XLA makes of it under jit (float64 holds the
    # float32 product exactly).
    new_reward = (shifted_reward.double() + reward.double()[:, None]
                  * _discounts(cfg.gamma, n, reward.device)[None, :]).float()

    done_t = torch.ones_like(done)
    emissions = {
        "action": torch.stack([out_action, out_action]
                              + list(new_action.unbind(1))),
        "reward": torch.stack([out_reward, out_reward]
                              + list(new_reward.unbind(1))),
        "done": torch.stack([torch.zeros_like(done)] + [done_t] * (n + 1)),
        "valid": torch.stack([out_valid & ~done, out_valid & done]
                             + [f & done for f in new_filled.unbind(1)]),
        "ring": traj.obs, "obs": obs, "next_obs": next_obs,
    }

    cleared = done[:, None]
    traj = TrajectoryState(
        obs=new_obs.masked_fill_(
            done.reshape((-1,) + (1,) * (new_obs.dim() - 1)), 0),
        action=torch.where(cleared, 0, new_action),
        reward=torch.where(cleared, 0.0, new_reward),
        filled=new_filled & ~cleared,
    )
    return traj, emissions


def _emission_rows(emissions, pos):
    """The replay rows of the emissions at flat positions ``pos`` of the
    [T, K, N] planes: (planes dict, obs, next_obs)."""
    k_n, n_lanes = emissions[0]["valid"].shape
    planes = {name: torch.stack([e[name] for e in emissions]).reshape(-1)
              .index_select(0, pos) for name in ("action", "reward", "done")}
    step, k, lane = pos // (k_n * n_lanes), (pos // n_lanes) % k_n, \
        pos % n_lanes
    n = k_n - 2
    ring_slot = torch.where(k < 2, n - 1, k - 3).clamp(min=0)
    obs = next_obs = None
    for t, e in enumerate(emissions):
        cur = e["obs"].index_select(0, lane)
        ring = e["ring"][lane, ring_slot].to(cur.dtype)
        shape = (-1,) + (1,) * (cur.dim() - 1)
        o = torch.where((k == 2).reshape(shape), cur, ring)
        no = torch.where((k == 0).reshape(shape), cur,
                         e["next_obs"].index_select(0, lane))
        if obs is None:
            obs, next_obs = o, no
        else:
            here = (step == t).reshape(shape)
            obs = torch.where(here, o, obs)
            next_obs = torch.where(here, no, next_obs)
    return planes, obs, next_obs


def push_emissions(buf, emissions):
    """Write a chunk's step emissions (a list of
    :func:`step_trajectories`' dicts, in step order; [T, K, N] flattened
    in arrival order) to the replay buffer, in place: one push. Returns
    ``buf``.

    Over R ranks each rank's [T, K, n] planes hold its lanes' slots
    (``n = N / R``), and the push writes the valid entries of the global
    [T, K, N] planes, so every rank's replay equals the one-process
    replay: the validity masks are all-gathered, each rank builds the
    rows of the kept entries that lie in its lanes (zeros elsewhere), and
    the rows are summed over the ranks, bit for bit (as integers). In one
    process the gather and the sum are the identity."""
    with span("dqn/push"):
        valid = torch.stack([e["valid"] for e in emissions])
        n = valid.shape[2]
        masks = torch.stack(M.all_gather(valid), 2)  # [T, K, R, n]
        world = masks.shape[2]
        pos, slots = _land(buf, masks)
        if not pos.numel():
            return buf
        # A global position of [T, K, R, n] -> the rank's [T, K, n] one.
        tk, lane = pos // (world * n), pos % (world * n)
        planes, obs, next_obs = _emission_rows(emissions,
                                               tk * n + lane % n)
        other = lane // n != M.process_index()
        rows = {"action": planes["action"].to(torch.int32),
                "reward": planes["reward"].view(torch.int32),
                "done": planes["done"].to(torch.int32),
                "obs": obs, "next_obs": next_obs}
        rows = {k: M.all_reduce_sum(v.masked_fill_(
            other.reshape((-1,) + (1,) * (v.dim() - 1)), 0))
            for k, v in rows.items()}
        _write(buf, slots, action=rows["action"],
               reward=rows["reward"].view(torch.float32),
               done=rows["done"] != 0, obs=rows["obs"],
               next_obs=rows["next_obs"])
        return buf


def td_loss(cfg, model, target_model, batch):
    """(loss, metrics) of a replay batch: squared n-step TD error against
    the target network's greedy value, which takes no gradient.
    Observations reach the networks in their stored dtype: packed int32
    views must not round-trip through float32 (bits above 24 would not
    survive)."""
    q_values = model(batch["obs"])
    with torch.no_grad():
        next_q = target_model(batch["next_obs"])
    q_taken = q_values.gather(-1, batch["action"].long()[:, None])[:, 0]
    discount = cfg.gamma ** cfg.multi_step * (
        1.0 - batch["done"].to(torch.float32))
    target = batch["reward"] + discount * next_q.max(-1).values
    loss = torch.mean((q_taken - target) ** 2)
    q_values = q_values.detach()
    metrics = {
        "loss": loss.detach(),
        "q_model_mean": q_values.mean(),
        "q_model_max": q_values.max(-1).values.mean(),
        "q_target_mean": next_q.mean(),
        "q_target_max": next_q.max(-1).values.mean(),
    }
    return loss, metrics


@dataclasses.dataclass
class DQNState:
    model: torch.nn.Module
    target_model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    replay: ReplayBuffer
    traj: TrajectoryState
    num_steps: int = 0  # env steps (lanes x steps), not agent samples

    @classmethod
    def around(cls, cfg, model, replay, traj, num_steps=0):
        """A learner around ``model``: its target a copy of it, Adam with
        optax ``adam``'s defaults at ``cfg.learning_rate``."""
        return cls(model=model,
                   target_model=copy.deepcopy(model).requires_grad_(False),
                   optimizer=make_optimizer(cfg, model), replay=replay,
                   traj=traj, num_steps=num_steps)


def init_dqn_state(cfg, model, batch, obs_shape, obs_dtype=torch.uint8,
                   device="cuda"):
    """A fresh learner around ``model`` (on ``device``), an empty replay of
    ``cfg.replay_size`` entries and ``batch`` empty n-step rings."""
    dev = _model_device(model)
    require_device(device, dev, "the model")
    return DQNState.around(
        cfg, model, init_replay(cfg.replay_size, obs_shape, obs_dtype, dev),
        init_trajectories(batch, cfg.multi_step, obs_shape, obs_dtype, dev))


@torch.no_grad()
def act_epsilon_greedy(model, obs, epsilon, generator, lanes=None):
    return epsilon_greedy(model(obs), epsilon, generator, lanes)


@torch.no_grad()
def collect(env_cfg, wcfg, cfg, pool, dstate, ws, obs, generator, n_steps,
            actions=None, lanes=None):
    """``n_steps`` env steps, acting ε-greedily (or taking ``actions`` int
    [T, B, A]); the n-step rings advance and the emissions land in the
    replay in one push. The env step applies no side-effect penalty and
    no exit-difficulty schedule, as the JAX package's DQN
    (``dqn.py:296-297``). With a rank's ``lanes`` the state is those
    lanes' and the push gathers every rank's emissions. Returns (ws, obs,
    each step's episode records [T, B, ...])."""
    with span("dqn/collect"):
        emissions, records = [], []
        for t in range(n_steps):
            b, a = obs.shape[:2]
            flat_obs = _flatten_agents(obs)
            # Only live (non-padded, not-yet-finished) agents make entries.
            valid = _flatten_agents(
                ws.env.is_active
                & pool.agent_mask.index_select(0, ws.env.level_idx))
            if actions is None:
                act = act_epsilon_greedy(
                    dstate.model, flat_obs,
                    float(epsilon_schedule(cfg, dstate.num_steps)),
                    generator, lanes)
            else:
                act = actions[t].reshape(-1).to(device=flat_obs.device,
                                                dtype=torch.int64)
            ws, obs, reward, done, info = W.step(
                env_cfg, wcfg, pool, ws, act.reshape(b, a), generator,
                se_penalty_coef=0.0, min_perf_fraction=1.0, lanes=lanes)
            dstate.traj, em = step_trajectories(
                cfg, dstate.traj, flat_obs, act, _flatten_agents(reward),
                _flatten_agents(obs), _flatten_agents(done), valid)
            dstate.num_steps += b if lanes is None else lanes.total
            emissions.append(em)
            records.append({k: info[k] for k in EPISODE_KEYS})
        dstate.replay = push_emissions(dstate.replay, emissions)
        return ws, obs, _stack(records)


def optimize(cfg, dstate, generator, n_env_steps, sample_idx=None):
    """One Adam step on ``cfg.batch_size`` entries drawn uniformly from the
    replay (or at ``sample_idx``) once it holds ``replay_initial``; while
    it is cold the loss is reported and nothing moves. The target network
    then syncs if ``num_steps`` crossed a multiple of
    ``target_update_interval`` over the ``n_env_steps`` steps just
    collected. Over ranks every rank holds the same replay and draws the
    same indices; rank 0's gradients are broadcast before the step.
    Returns the metrics (the loss's from before the step)."""
    with span("dqn/optimize"):
        replay = dstate.replay
        size = replay.size()
        dev = replay.obs.device
        if sample_idx is None:
            sample_idx = torch.randint(0, max(size, 1), (cfg.batch_size,),
                                       generator=generator, device=dev)
        else:
            sample_idx = torch.as_tensor(sample_idx, device=dev).long()
        _ROWS["sampled"] += sample_idx.shape[0]
        batch = {k: getattr(replay, k).index_select(0, sample_idx)
                 for k in ("obs", "action", "reward", "next_obs", "done")}
        warm = size >= cfg.replay_initial
        with learner_precision(dstate.model.precision, dev.type,
                               sample_idx.shape[0]), \
                torch.set_grad_enabled(warm):
            loss, metrics = td_loss(cfg, dstate.model, dstate.target_model,
                                    batch)
            if warm:
                dstate.optimizer.zero_grad(set_to_none=False)
                loss.backward()
                M.broadcast_grads(dstate.model)
                dstate.optimizer.step()
        n, every = dstate.num_steps, cfg.target_update_interval
        if n // every > (n - n_env_steps) // every:
            dstate.target_model.load_state_dict(dstate.model.state_dict())
        metrics["epsilon"] = epsilon_schedule(cfg, n)
        metrics["replay_size"] = size
        return metrics


def collect_and_optimize(env_cfg, wcfg, cfg, pool, dstate, ws, obs,
                         generator, n_steps, actions=None, sample_idx=None,
                         device="cuda", lanes=None):
    """``n_steps`` env steps filling the replay (:func:`collect`), then one
    optimizer step if the buffer is warm (:func:`optimize`). The pool and
    the model live on ``device``. Updates ``dstate`` in place; returns
    (dstate, ws, obs, metrics) with ``episodes`` [T, B, ...] in the
    metrics."""
    with span("dqn/unit"):
        require_device(device, pool.device, "the level pool")
        require_device(device, _model_device(dstate.model), "the model")
        b = obs.shape[0] if lanes is None else lanes.total
        ws, obs, episodes = collect(env_cfg, wcfg, cfg, pool, dstate, ws,
                                    obs, generator, n_steps, actions, lanes)
        metrics = optimize(cfg, dstate, generator, n_steps * b, sample_idx)
        metrics["episodes"] = episodes
        return dstate, ws, obs, metrics


def train_chunk(env_cfg, wcfg, cfg, pool, dstate, ws, obs, generator,
                n_steps, n_iters, device="cuda", lanes=None):
    """``n_iters`` collect-and-optimize units. The episode records are
    flattened over the chunk's units, steps and lanes ([U*T*B, ...], the
    form ``EpisodeCollector.observe`` takes); the scalar metrics are the
    last unit's."""
    episodes = []
    for _ in range(n_iters):
        dstate, ws, obs, metrics = collect_and_optimize(
            env_cfg, wcfg, cfg, pool, dstate, ws, obs, generator, n_steps,
            device=device, lanes=lanes)
        episodes.append(metrics.pop("episodes"))
    metrics["episodes"] = {
        k: torch.cat([e[k].reshape((-1,) + tuple(e[k].shape[2:]))
                      for e in episodes]) for k in episodes[-1]}
    return dstate, ws, obs, metrics
