"""Load the JAX package's policy parameters into the torch network.

Takes the flax parameter tree of ``SafeLifePolicyNetwork`` as
``safelife_tpu/models/nets.py:174`` (``init_policy_params``) builds it,
with numpy arrays as leaves — ``SafeLifeCNN_0/Conv_{0,1,2}`` and
``Dense_{0,1,2}`` (hidden, value, logits) — and maps it onto
:class:`~safelife_tpu_torch.models.nets.SafeLifePolicyNetwork`:

* conv kernels HWIO → OIHW;
* dense kernels [in, out] → [out, in].

The torch trunk flattens its feature map in flax's NHWC order, so the first
dense layer needs no row permutation.

:func:`ppo_state_from_jax` carries a whole learner across: a JAX
``PPOState`` (``safelife_tpu/training/ppo.py:51-65``: the flax params,
optax ``adam``'s ``ScaleByAdamState`` and ``num_steps``) becomes a
:class:`~safelife_tpu_torch.training.ppo.PPOState` whose
``torch.optim.Adam`` holds the same step count and moments, transposed as
the parameters are.
"""

import numpy as np
import torch


def _conv(p):
    return {"weight": np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)),
            "bias": np.asarray(p["bias"])}


def _dense(p):
    return {"weight": np.asarray(p["kernel"]).T, "bias": np.asarray(p["bias"])}


def policy_params_from_flax(tree):
    """State dict for ``SafeLifePolicyNetwork`` from a flax parameter tree
    (with or without the top ``"params"``)."""
    params = tree.get("params", tree)
    cnn = params["SafeLifeCNN_0"]
    parts = {
        "cnn.conv0": _conv(cnn["Conv_0"]),
        "cnn.conv1": _conv(cnn["Conv_1"]),
        "cnn.conv2": _conv(cnn["Conv_2"]),
        "dense": _dense(params["Dense_0"]),
        "value": _dense(params["Dense_1"]),
        "logits": _dense(params["Dense_2"]),
    }
    return {"%s.%s" % (name, k): torch.tensor(v, dtype=torch.float32)
            for name, p in parts.items() for k, v in p.items()}


def _adam_state(opt_state):
    """optax ``adam``'s ``ScaleByAdamState`` (the part of the chain with
    ``count``, ``mu`` and ``nu``)."""
    for part in opt_state:
        if all(hasattr(part, k) for k in ("count", "mu", "nu")):
            return part
    raise ValueError("no ScaleByAdamState in the optimizer state")


def ppo_state_from_jax(pstate_tree, model):
    """A :class:`~safelife_tpu_torch.training.ppo.PPOState` around
    ``model`` (a ``SafeLifePolicyNetwork`` of the same shapes, on its
    device) from a JAX ``PPOState`` with numpy (or JAX) leaves, its
    optimizer built from ``PPOConfig()``'s learning rate."""
    from ..training import ppo

    dev = next(model.parameters()).device
    model.load_state_dict(policy_params_from_flax(pstate_tree.params))
    state = ppo.PPOState(model=model,
                         optimizer=ppo.make_optimizer(ppo.PPOConfig(), model),
                         num_steps=int(np.asarray(pstate_tree.num_steps)))
    adam = _adam_state(pstate_tree.opt_state)
    mu = policy_params_from_flax(adam.mu)
    nu = policy_params_from_flax(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    for name, p in model.named_parameters():
        state.optimizer.state[p] = {
            "step": step.clone(),
            "exp_avg": mu[name].to(dev),
            "exp_avg_sq": nu[name].to(dev),
        }
    return state
