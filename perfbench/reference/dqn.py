"""The plain reference of SafeLife's dueling Q network and of a DQN unit
(safelife v1.2.2, ``training/models.py`` SafeLifeQNetwork and
``training/dqn.py``), in plain PyTorch float32 with TF32 off.

The network takes packed int32 views, unpacks the configured bits into
binary channels, swaps the view's axes (the reference's (c, w, h) layout),
runs the configured VALID convolutions with ReLU and flattens in (h, w, c)
order; two heads of one hidden ReLU layer each give the advantages and
the value, and Q = value + advantage - mean advantage. Parameters are a
dict of tensors under the configuration's layer names.

A unit: each lane's n-step ring takes the step (slot 0 newest), its
oldest entry leaves with its discounted n-step reward and, where the
episode ends, every filled entry leaves as terminal and the ring clears;
the valid entries of the step, in arrival order (candidate-major, then
lane), land in a uniform replay of ``capacity`` slots, the last
``capacity`` of them to slots ``idx mod capacity``; an Adam step on the
squared n-step TD error against the target network's greedy value; the
target takes the online parameters when the env steps cross a multiple
of the sync interval.

Departures from safelife's ``training/dqn.py``, which keeps one Python
list of pending transitions per agent and pushes them one at a time:

* all lanes step at once, and a step's candidates are the oldest entry
  (normal or terminal) and the n ring slots flushed on an episode's end,
  pushed in that order;
* the oldest entry of a ring that ends with the step leaves as terminal
  with the rewards it had gathered (the step's reward is not added and
  nothing is bootstrapped);
* an entry's discounted reward is the older sum plus the new reward times
  gamma^k, rounded to float32 once (computed in float64), with gamma^k a
  float32 power;
* views are stored as the packed int32 words the network unpacks, not as
  float planes;
* the replay is sampled uniformly with replacement from the filled slots,
  and the target syncs when ``num_steps`` crosses a multiple of the sync
  interval (safelife counts steps modulo it).
"""

import dataclasses

import torch
import torch.nn.functional as F


def forward(net, params, obs):
    """Q-values [N, actions] of packed views [N, vh, vw] under ``net``
    (the configuration's ``q_network``)."""
    shifts = torch.tensor(net["channels"], dtype=torch.int32,
                          device=obs.device)
    x = ((obs[..., None] >> shifts) & 1).to(torch.float32)
    x = x.permute(0, 3, 2, 1)
    for layer in net["convs"]:
        x = torch.relu(F.conv2d(x, params[layer["name"] + ".weight"],
                                params[layer["name"] + ".bias"],
                                stride=layer["stride"]))
    x = x.permute(0, 2, 3, 1).flatten(1)

    def head(hidden, out):
        h = torch.relu(F.linear(x, params[net[hidden] + ".weight"],
                                params[net[hidden] + ".bias"]))
        return F.linear(h, params[net[out] + ".weight"],
                        params[net[out] + ".bias"])

    adv = head("adv_hidden", "adv")
    value = head("value_hidden", "value")
    return value + adv - adv.mean(-1, keepdim=True)


@dataclasses.dataclass
class Rings:
    """Each slot's n-step ring (a flattened lane x agent): views [N, n,
    vh, vw], actions [N, n] int32, discounted rewards [N, n] float32, and
    whether each entry holds a live step [N, n]."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    filled: torch.Tensor


def discounts(gamma, n, device):
    """float64 [n]: 0, then gamma^1 .. gamma^(n-1) as float32 powers."""
    g = torch.tensor(gamma, dtype=torch.float32) ** torch.arange(
        1, n, dtype=torch.float32)
    return torch.cat([torch.zeros(1), g]).double().to(device)


def ring_step(gamma, old, obs, action, reward, next_obs, done, valid):
    """One step of every ring of ``old`` (:class:`Rings`). ``obs`` [N, vh,
    vw] the step's views, ``next_obs`` the views after it, ``action`` [N],
    ``reward`` [N], ``done`` [N] and ``valid`` [N] (a live agent). Returns
    (rings, candidates): ``candidates`` holds [K, N] planes ``action``,
    ``reward``, ``done`` and ``valid`` and [K, N, vh, vw] ``obs`` and
    ``next_obs``, K = n + 2 in arrival order: the oldest entry leaving
    normally, the oldest leaving as terminal, ring slots 0 .. n-1 flushed."""
    n = old.action.shape[1]
    new_obs = torch.cat([obs[:, None], old.obs[:, :-1]], 1)
    new_action = torch.cat([action.to(torch.int32)[:, None],
                            old.action[:, :-1]], 1)
    shifted = torch.cat([reward[:, None], old.reward[:, :-1]], 1)
    new_reward = (shifted.double() + reward.double()[:, None]
                  * discounts(gamma, n, reward.device)[None]).float()
    new_filled = torch.cat([valid[:, None], old.filled[:, :-1]], 1)
    out_obs = old.obs[:, -1]
    flushed = range(n)
    cand_obs = [out_obs, out_obs] + [
        obs if k == 0 else old.obs[:, k - 1] for k in flushed]
    cand_next = [obs] + [next_obs] * (n + 1)
    cand = {
        "action": torch.stack([old.action[:, -1], old.action[:, -1]]
                              + [new_action[:, k] for k in flushed]),
        "reward": torch.stack([old.reward[:, -1], old.reward[:, -1]]
                              + [new_reward[:, k] for k in flushed]),
        "done": torch.stack([torch.zeros_like(done)]
                            + [torch.ones_like(done)] * (n + 1)),
        "valid": torch.stack([old.filled[:, -1] & ~done,
                              old.filled[:, -1] & done]
                             + [new_filled[:, k] & done for k in flushed]),
        "obs": torch.stack(cand_obs),
        "next_obs": torch.stack(cand_next),
    }
    keep = ~done[:, None]
    rings = Rings(
        obs=new_obs * keep.reshape(keep.shape + (1,) * (obs.dim() - 1)).to(
            new_obs.dtype),
        action=torch.where(keep, new_action, 0),
        reward=torch.where(keep, new_reward, 0.0),
        filled=new_filled & keep)
    return rings, cand


def push(candidates, idx, capacity):
    """The replay writes of one step's ``candidates``: (rows {name:
    [M, ...]}, slots int64 [M], the new ``idx``). The valid candidates in
    arrival order, the last ``capacity`` of them, to slots
    ``idx mod capacity`` onward; ``idx`` counts every valid one."""
    valid = candidates["valid"].reshape(-1)
    pos = torch.arange(valid.shape[0], device=valid.device)[valid]
    count = pos.shape[0]
    first = max(count - capacity, 0)
    pos = pos[first:]
    slots = (idx + torch.arange(first, count, device=valid.device)) \
        % capacity
    rows = {k: v.reshape((-1,) + tuple(v.shape[2:]))[pos]
            for k, v in candidates.items() if k != "valid"}
    return rows, slots, idx + count


def td_loss(gamma, n, net, params, target, batch):
    """(loss, Q-values [M, actions]) of a replay batch: the mean squared
    gap between the taken action's Q and reward + gamma^n (1 - done) max
    of the target's Q at the next views."""
    q = forward(net, params, batch["obs"])
    with torch.no_grad():
        next_q = forward(net, target, batch["next_obs"]).max(-1).values
    taken = q.gather(-1, batch["action"].long()[:, None])[:, 0]
    boot = gamma ** n * (1.0 - batch["done"].to(torch.float32))
    loss = torch.mean((taken - (batch["reward"] + boot * next_q)) ** 2)
    return loss, q


def grads(gamma, n, net, params, target, batch):
    """(loss, Q-values, {name: gradient}) of :func:`td_loss`."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, q = td_loss(gamma, n, net, leaves, target, batch)
    names = list(leaves)
    g = torch.autograd.grad(loss, [leaves[k] for k in names])
    return float(loss.detach()), q.detach(), dict(zip(names, g))


def syncs(num_steps, steps, every):
    """Whether the target syncs after ``steps`` env steps that bring the
    count to ``num_steps``: a multiple of ``every`` was crossed."""
    return num_steps // every > (num_steps - steps) // every
