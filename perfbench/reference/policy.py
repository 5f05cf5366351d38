"""The plain reference of SafeLife's policy network and of a PPO iteration
(safelife v1.2.2, ``training/models.py`` SafeLifePolicyNetwork and
``training/ppo.py``), in plain PyTorch float32 with TF32 off.

The network takes packed int32 views, unpacks the configured bits into
binary channels, swaps the view's axes (the reference's (c, w, h) layout),
runs the configured VALID convolutions with ReLU, flattens in (h, w, c)
order, then a dense ReLU layer and the value and policy heads; the policy
is a softmax. Parameters are a dict of tensors under the configuration's
layer names, weights [out, in, kh, kw] or [out, in].

PPO: advantages ``adv[t] = (r[t] + γ v[t+1] − v[t]) + λ adv[t+1]`` and
discounted returns bootstrapped by the final value, both cut at episode
ends; the loss in ratio-difference form ``|adv| max(sign(adv)(1 − π/π_old),
−ε)``, the clipped value loss and a clipped entropy bonus, means weighted
by the live-agent mask; ``epochs`` passes over the batch in
``num_minibatches + 1`` slices of a permutation, each one Adam step.
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def strict_float32(tf32=False):
    """cuBLAS and cuDNN without TF32 (``tf32=True``: with it, the
    control's lower precision)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def forward(net, params, obs):
    """(value [N], probabilities [N, actions]) of packed views [N, vh, vw]
    under ``net`` (the configuration's ``policy``)."""
    shifts = torch.tensor(net["channels"], dtype=torch.int32,
                          device=obs.device)
    x = ((obs[..., None] >> shifts) & 1).to(torch.float32)
    x = x.permute(0, 3, 2, 1)
    for layer in net["convs"]:
        x = torch.relu(F.conv2d(x, params[layer["name"] + ".weight"],
                                params[layer["name"] + ".bias"],
                                stride=layer["stride"]))
    x = x.permute(0, 2, 3, 1).flatten(1)
    hidden = net["dense"]["name"]
    x = torch.relu(F.linear(x, params[hidden + ".weight"],
                            params[hidden + ".bias"]))
    value = F.linear(x, params[net["value"] + ".weight"],
                     params[net["value"] + ".bias"])[..., 0]
    logits = F.linear(x, params[net["logits"] + ".weight"],
                      params[net["logits"] + ".bias"])
    return value, torch.softmax(logits, dim=-1)


def gae(cfg, rewards, values, done, final_values):
    """(returns, advantages) [T, N]."""
    not_done = (~done).to(torch.float32)
    boot = final_values * not_done[-1]
    val1 = torch.cat([values[1:], final_values[None]], 0) * not_done
    delta = rewards + cfg["gamma"] * val1 - values
    adv = torch.empty_like(delta)
    ret = torch.empty_like(rewards)
    a, r = torch.zeros_like(delta[-1]), boot
    for t in reversed(range(rewards.shape[0])):
        a = delta[t] + cfg["lmda"] * not_done[t] * a
        r = rewards[t] + cfg["gamma"] * not_done[t] * r
        adv[t], ret[t] = a, r
    return ret, adv


def loss_sums(cfg, net, params, mb):
    """Weighted sums of the (policy, value, entropy) terms of a batch."""
    values, policy = forward(net, params, mb["obs"])
    a_policy = policy.gather(-1, mb["actions"][:, None])[:, 0]
    adv = mb["advantages"]
    diff = torch.sign(adv) * (1 - a_policy / mb["action_prob"])
    p_term = torch.abs(adv) * torch.clamp(diff, min=-cfg["eps_policy"])
    v_clip = mb["values"] + torch.clamp(values - mb["values"],
                                        -cfg["eps_value"], cfg["eps_value"])
    v_term = torch.maximum((v_clip - mb["returns"]) ** 2,
                           (values - mb["returns"]) ** 2)
    ent = torch.sum(-policy * torch.log(policy + 1e-12), -1)
    w = mb["weight"]
    return torch.stack([torch.sum(x * w) for x in (p_term, v_term, ent)])


def combine(cfg, sums, wsum):
    """The loss from the terms' weighted sums and the weights' sum."""
    wsum = torch.clamp(wsum, min=1.0)
    p, v, e = sums / wsum
    return p + v * cfg["vf_coef"] - cfg["entropy_reg"] * torch.clamp(
        e, max=cfg["entropy_clip"])


def minibatch_bounds(n, num_minibatches):
    pts = np.linspace(0, n, num_minibatches + 2, dtype=int)
    bounds = [0] + list(pts[1:-1]) + [n]
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


class Adam:
    """Adam (Kingma and Ba) with bias correction, as optax's defaults."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params, grads):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            denom = (self.v[k] / c2).sqrt() + self.eps
            out[k] = p - self.lr * (self.m[k] / c1) / denom
        return out


def update(cfg, net, params, opt, batch, perms, steps=None, record=None):
    """Minibatch Adam steps over ``batch`` (dict of [N, ...]) in the order
    of ``perms`` (int64 [epochs, N]): every epoch's, or the first
    ``steps``. ``record`` (a dict) gets each step's loss under "losses"
    and the first step's gradient under "grad1". Returns the
    parameters."""
    n = batch["obs"].shape[0]
    done = 0
    for epoch in range(cfg["epochs_per_batch"]):
        perm = perms[epoch]
        for lo, hi in minibatch_bounds(n, cfg["num_minibatches"]):
            if steps is not None and done == steps:
                return params
            idx = perm[lo:hi]
            mb = {k: v.index_select(0, idx) for k, v in batch.items()}
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss = combine(cfg, loss_sums(cfg, net, leaves, mb),
                           mb["weight"].sum())
            names = list(leaves)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [leaves[k] for k in names])))
            if record is not None:
                record.setdefault("losses", []).append(float(loss.detach()))
                if "grad1" not in record:
                    record["grad1"] = {k: g.detach().clone()
                                       for k, g in grads.items()}
            params = opt.step({k: v.detach() for k, v in params.items()},
                              grads)
            done += 1
    return params
