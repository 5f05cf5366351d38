"""Load the JAX package's network parameters into the torch networks.

Takes the flax parameter tree of ``SafeLifePolicyNetwork`` as
``safelife_tpu/models/nets.py:174`` (``init_policy_params``) builds it,
with numpy arrays as leaves — ``SafeLifeCNN_0/Conv_{0,1,2}`` and
``Dense_{0,1,2}`` (hidden, value, logits) — and maps it onto
:class:`~safelife_tpu_torch.models.nets.SafeLifePolicyNetwork`; likewise
the tree of ``SafeLifeQNetwork`` (``nets.py:149-171``) onto
:class:`~safelife_tpu_torch.models.nets.SafeLifeQNetwork`. Flax numbers
dense layers in the order they are constructed, and in
``Dense(9)(relu(Dense(256)(x)))`` the outer layer is constructed first:
``Dense_0`` is the advantage output, ``Dense_1`` its hidden layer,
``Dense_2`` the value output and ``Dense_3`` its hidden layer. Both:

* conv kernels HWIO → OIHW;
* dense kernels [in, out] → [out, in].

The torch trunk flattens its feature map in flax's NHWC order, so the first
dense layer needs no row permutation.

:func:`ppo_state_from_jax` carries a whole learner across: a JAX
``PPOState`` (``safelife_tpu/training/ppo.py:51-65``: the flax params,
optax ``adam``'s ``ScaleByAdamState`` and ``num_steps``) becomes a
:class:`~safelife_tpu_torch.training.ppo.PPOState` whose
``torch.optim.Adam`` holds the same step count and moments, transposed as
the parameters are. :func:`dqn_state_from_jax` does the same for a JAX
``DQNState`` (``safelife_tpu/training/dqn.py:242-261``), its target
parameters, replay buffer and n-step rings included.
"""

import numpy as np
import torch


def _conv(p):
    return {"weight": np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)),
            "bias": np.asarray(p["bias"])}


def _dense(p):
    return {"weight": np.asarray(p["kernel"]).T, "bias": np.asarray(p["bias"])}


def _state_dict(parts):
    return {"%s.%s" % (name, k): torch.tensor(v, dtype=torch.float32)
            for name, p in parts.items() for k, v in p.items()}


def _cnn_parts(params):
    cnn = params["SafeLifeCNN_0"]
    return {"cnn.conv%d" % i: _conv(cnn["Conv_%d" % i]) for i in range(3)}


def policy_params_from_flax(tree):
    """State dict for ``SafeLifePolicyNetwork`` from a flax parameter tree
    (with or without the top ``"params"``)."""
    params = tree.get("params", tree)
    return _state_dict({
        **_cnn_parts(params),
        "dense": _dense(params["Dense_0"]),
        "value": _dense(params["Dense_1"]),
        "logits": _dense(params["Dense_2"]),
    })


def q_params_from_flax(tree):
    """State dict for ``SafeLifeQNetwork`` from a flax parameter tree (with
    or without the top ``"params"``), dense layers by flax's construction
    order."""
    params = tree.get("params", tree)
    return _state_dict({
        **_cnn_parts(params),
        "adv": _dense(params["Dense_0"]),
        "adv_hidden": _dense(params["Dense_1"]),
        "value": _dense(params["Dense_2"]),
        "value_hidden": _dense(params["Dense_3"]),
    })


def _adam_state(opt_state):
    """optax ``adam``'s ``ScaleByAdamState`` (the part of the chain with
    ``count``, ``mu`` and ``nu``)."""
    for part in opt_state:
        if all(hasattr(part, k) for k in ("count", "mu", "nu")):
            return part
    raise ValueError("no ScaleByAdamState in the optimizer state")


def _load_adam(optimizer, model, opt_state, params_from_flax):
    """Adam's step count and moments from optax's state into
    ``optimizer``, whose parameters are ``model``'s."""
    dev = next(model.parameters()).device
    adam = _adam_state(opt_state)
    mu = params_from_flax(adam.mu)
    nu = params_from_flax(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": step.clone(),
            "exp_avg": mu[name].to(dev),
            "exp_avg_sq": nu[name].to(dev),
        }


def ppo_state_from_jax(pstate_tree, model):
    """A :class:`~safelife_tpu_torch.training.ppo.PPOState` around
    ``model`` (a ``SafeLifePolicyNetwork`` of the same shapes, on its
    device) from a JAX ``PPOState`` with numpy (or JAX) leaves, its
    optimizer built from ``PPOConfig()``'s learning rate."""
    from ..training import ppo

    model.load_state_dict(policy_params_from_flax(pstate_tree.params))
    state = ppo.PPOState(model=model,
                         optimizer=ppo.make_optimizer(ppo.PPOConfig(), model),
                         num_steps=int(np.asarray(pstate_tree.num_steps)))
    _load_adam(state.optimizer, model, pstate_tree.opt_state,
               policy_params_from_flax)
    return state


def dqn_state_from_jax(dstate_tree, model):
    """A :class:`~safelife_tpu_torch.training.dqn.DQNState` around
    ``model`` (a ``SafeLifeQNetwork`` of the same shapes, on its device)
    from a JAX ``DQNState`` with numpy (or JAX) leaves: parameters, target
    parameters, Adam, ``num_steps``, the replay buffer and the n-step
    rings, its optimizer built from ``DQNConfig()``'s learning rate."""
    from ..training import dqn

    dev = next(model.parameters()).device

    def t(x):
        return torch.tensor(np.asarray(x), device=dev)

    model.load_state_dict(q_params_from_flax(dstate_tree.params))
    r, tr = dstate_tree.replay, dstate_tree.traj
    state = dqn.DQNState.around(
        dqn.DQNConfig(), model,
        replay=dqn.ReplayBuffer(obs=t(r.obs), action=t(r.action),
                                reward=t(r.reward), next_obs=t(r.next_obs),
                                done=t(r.done), idx=int(np.asarray(r.idx))),
        traj=dqn.TrajectoryState(obs=t(tr.obs), action=t(tr.action),
                                 reward=t(tr.reward), filled=t(tr.filled)),
        num_steps=int(np.asarray(dstate_tree.num_steps)))
    state.target_model.load_state_dict(
        q_params_from_flax(dstate_tree.target_params))
    _load_adam(state.optimizer, model, dstate_tree.opt_state,
               q_params_from_flax)
    return state
