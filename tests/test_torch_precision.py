"""The learner's precision modes (``models/nets.py::PRECISIONS``,
``learner_precision``) against the JAX package's, on the CPU.

"float32" is the strict path the port had before it had modes, bit for
bit. JAX's CPU backend ignores its precision, so every mode is held
against JAX's float32 result on the same parameters and batch: the loss
relative and the gradients as a norm over all parameters. "tensorfloat32"
changes nothing on the CPU (there is no TF32 there) and keeps float32's
bounds, 1e-5. "bfloat16" rounds the inputs and weights of every
convolution and dense layer to bfloat16's 8-bit mantissa (unit roundoff
2^-9, 2e-3) in the forward and the backward pass: over seeds 0-3 the
loss lay at most 5.4e-4 relative from JAX's and the gradients at most
0.095 of their norm, so the bounds are 5e-3 and 0.25, well under a
gross fault's 1 (a dropped layer, a sign)."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu.models import nets as JN  # noqa: E402
from safelife_tpu.training import dqn as JD  # noqa: E402
from safelife_tpu.training import ppo as JP  # noqa: E402
from safelife_tpu_torch.env import env as TE  # noqa: E402
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.models.convert import (  # noqa: E402
    policy_params_from_flax, q_params_from_flax)
from safelife_tpu_torch.training import dqn as TD  # noqa: E402
from safelife_tpu_torch.training import global_config as TGC  # noqa: E402
from safelife_tpu_torch.training import ppo as TP  # noqa: E402
from safelife_tpu_torch.training import train as TT  # noqa: E402

VIEW = (25, 25)
CHANNELS = TN.TRAINING_CHANNELS
#: (loss relative, gradients over their norm) of each mode against JAX's
#: float32 (the module docstring says why).
BOUNDS = {"float32": (1e-5, 1e-5), "tensorfloat32": (1e-5, 1e-5),
          "bfloat16": (5e-3, 0.25)}
PPO_KEYS = ("obs", "actions", "action_prob", "values", "returns",
            "advantages", "weight")


def _ppo_case(seed, n=48):
    model = JN.SafeLifePolicyNetwork(unpack_channels=CHANNELS)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), np.zeros((1,) + VIEW, np.int32)))
    rng = np.random.default_rng(seed)
    batch = {
        "obs": rng.integers(0, 2 ** 28, (n,) + VIEW).astype(np.int32),
        "actions": rng.integers(0, 9, n).astype(np.int32),
        "action_prob": rng.uniform(0.05, 1.0, n).astype(np.float32),
        "values": rng.normal(size=n).astype(np.float32),
        "returns": rng.normal(size=n).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "weight": (rng.random(n) < 0.8).astype(np.float32),
    }
    return model, params, batch


def _q_case(seed, n=24):
    model = JN.SafeLifeQNetwork(unpack_channels=CHANNELS)
    dummy = np.zeros((1,) + VIEW, np.int32)
    params, target = (jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(s), dummy)) for s in (seed + 10, seed + 20))
    rng = np.random.default_rng(seed)
    batch = {
        "obs": rng.integers(0, 2 ** 28, (n,) + VIEW).astype(np.int32),
        "action": rng.integers(0, 9, n).astype(np.int32),
        "reward": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.integers(0, 2 ** 28, (n,) + VIEW).astype(np.int32),
        "done": rng.random(n) < 0.3,
    }
    return model, params, target, batch


def _net(cls, params, precision="float32"):
    convert = (policy_params_from_flax if cls is TN.SafeLifePolicyNetwork
               else q_params_from_flax)
    net = cls(view_shape=VIEW, unpack_channels=CHANNELS, device="cpu",
              precision=precision)
    net.load_state_dict(convert(params))
    return net


def _grad_norm_diff(net, ref):
    diff = torch.cat([(p.grad - ref[k]).flatten()
                      for k, p in net.named_parameters()])
    norm = torch.cat([ref[k].flatten() for k, _ in net.named_parameters()])
    return float(diff.norm() / norm.norm())


def test_precision_names_match_jax():
    assert set(TN.PRECISIONS) == set(JN.PRECISIONS)
    for a in TN.PRECISIONS:
        for b in TN.PRECISIONS:
            assert (TN.PRECISIONS[a] == TN.PRECISIONS[b]) == \
                (JN.PRECISIONS[a] == JN.PRECISIONS[b]), (a, b)
    assert [TN.PRECISIONS[k] for k in ("highest", "high", "default")] == \
        ["float32", "tensorfloat32", "bfloat16"]


def test_unknown_precision_raises():
    with pytest.raises(KeyError):
        JN.PRECISIONS["float16"]
    with pytest.raises(ValueError, match="unknown precision"):
        TN.SafeLifePolicyNetwork(num_channels=2, device="cpu",
                                 precision="float16")
    with pytest.raises(ValueError, match="unknown precision"):
        with TN.learner_precision("float16", "cpu"):
            pass
    TGC.config.clear()
    try:
        TGC.config["train.precision"] = "float16"
        with pytest.raises(ValueError, match="unknown precision"):
            TT.build_model(_bundle(), device="cpu")
    finally:
        TGC.config.clear()
        TGC.config._used.clear()


def _strict_reference(net, obs):
    """The float32 forward as the port computed it before it had modes:
    the layers under TF32-off flags, the heads in float32."""
    x = TN.unpack_obs(obs, CHANNELS).permute(0, 3, 2, 1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for conv in (net.cnn.conv0, net.cnn.conv1, net.cnn.conv2):
            x = torch.relu(conv(x))
        x = x.permute(0, 2, 3, 1).flatten(1)
        if isinstance(net, TN.SafeLifePolicyNetwork):
            h = torch.relu(net.dense(x))
            return (net.value(h)[..., 0],
                    torch.softmax(net.logits(h), dim=-1))
        adv = net.adv(torch.relu(net.adv_hidden(x)))
        val = net.value(torch.relu(net.value_hidden(x)))
        return (val + adv - adv.mean(-1, keepdim=True),)


@pytest.mark.parametrize("cls", [TN.SafeLifePolicyNetwork,
                                 TN.SafeLifeQNetwork])
def test_float32_is_the_strict_path_bit_for_bit(cls):
    torch.manual_seed(3)
    net = cls(view_shape=VIEW, unpack_channels=CHANNELS, device="cpu")
    assert net.precision == "float32"
    obs = torch.from_numpy(np.random.default_rng(2).integers(
        0, 2 ** 28, (16,) + VIEW).astype(np.int32))
    grads = []
    for fn in (lambda o: net(o), lambda o: _strict_reference(net, o)):
        net.zero_grad(set_to_none=True)
        with TN.learner_precision(net.precision, "cpu"):
            out = fn(obs)
            out = out if isinstance(out, tuple) else (out,)
            sum(o.pow(2).sum() for o in out).backward()
        grads.append(([o.detach() for o in out],
                      [p.grad.clone() for p in net.parameters()]))
    (o1, g1), (o2, g2) = grads
    assert all(torch.equal(a, b) for a, b in zip(o1, o2))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("precision", ["tensorfloat32", "bfloat16"])
def test_policy_loss_and_gradients_within_bound_of_jax(precision):
    model, params, batch = _ppo_case(1)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JP.calculate_loss(JP.PPOConfig(), model.apply, p, *[
            jnp.asarray(batch[k]) for k in PPO_KEYS]), has_aux=True)(params)
    net = _net(TN.SafeLifePolicyNetwork, params, precision)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["actions"] = tb["actions"].long()
    with TN.learner_precision(net.precision, "cpu"):
        tl, _ = TP.calculate_loss(TP.PPOConfig(), net,
                                  *[tb[k] for k in PPO_KEYS])
        tl.backward()
    loss_rel, grad_norm = BOUNDS[precision]
    assert abs(tl.item() - float(jl)) <= loss_rel * abs(float(jl))
    ref = policy_params_from_flax(jax.tree.map(np.asarray, jg))
    assert _grad_norm_diff(net, ref) <= grad_norm


@pytest.mark.parametrize("precision", ["tensorfloat32", "bfloat16"])
def test_q_loss_and_gradients_within_bound_of_jax(precision):
    model, params, target, batch = _q_case(2)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JD.td_loss(JD.DQNConfig(), model.apply, p, target, {
            k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    net = _net(TN.SafeLifeQNetwork, params, precision)
    tnet = _net(TN.SafeLifeQNetwork, target, precision)
    with TN.learner_precision(net.precision, "cpu"):
        tl, _ = TD.td_loss(TD.DQNConfig(), net, tnet, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        tl.backward()
    loss_rel, grad_norm = BOUNDS[precision]
    assert abs(tl.item() - float(jl)) <= loss_rel * abs(float(jl))
    ref = q_params_from_flax(jax.tree.map(np.asarray, jg))
    assert _grad_norm_diff(net, ref) <= grad_norm


def test_bfloat16_autocasts_the_layers_only():
    """Under bfloat16 every convolution and dense layer computes in
    bfloat16, in the forward and the backward pass; the outputs, the
    parameters, their gradients and Adam's moments stay float32, and the
    process-wide flags come back after each step."""
    _, params, batch = _ppo_case(0, n=20)
    net = _net(TN.SafeLifePolicyNetwork, params, "bfloat16")
    seen = []
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["actions"] = tb["actions"].long()
    with torch.no_grad():
        value, policy = net(tb["obs"])
    assert value.dtype == policy.dtype == torch.float32
    assert seen == [torch.bfloat16] * 6
    cfg = TP.PPOConfig()
    ps = TP.init_ppo_state(cfg, net, device="cpu")
    TP.train_on_batch(cfg, ps, tb, torch.Generator().manual_seed(0))
    for p in net.parameters():
        st = ps.optimizer.state[p]
        assert p.dtype == p.grad.dtype == st["exp_avg"].dtype == \
            st["exp_avg_sq"].dtype == torch.float32
        assert torch.isfinite(p).all()
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags


def _bundle(packed=True):
    cfg = TE.EnvConfig(view_shape=VIEW,
                       output_channels=None if packed else CHANNELS)
    return types.SimpleNamespace(env_cfg=cfg, obs_channels=CHANNELS,
                                 packed_obs=packed)


@pytest.mark.parametrize("name", list(JN.PRECISIONS))
def test_build_model_takes_every_precision_name(name):
    TGC.config.clear()
    try:
        TGC.config["train.precision"] = name
        for algo, cls in (("ppo", TN.SafeLifePolicyNetwork),
                          ("dqn", TN.SafeLifeQNetwork)):
            net, shape, dtype = TT.build_model(_bundle(), algo, device="cpu")
            assert isinstance(net, cls) and net.precision == name
            assert (shape, dtype) == (VIEW, torch.int32)
    finally:
        TGC.config.clear()
        TGC.config._used.clear()
