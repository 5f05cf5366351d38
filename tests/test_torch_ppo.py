"""The port's PPO learner (``training/ppo.py``) against the JAX package's,
on the CPU: GAE, the loss and its gradients, the Adam minibatch updates
with JAX's permutations replayed, the carried-over learner state, and one
whole ``train_iteration`` with JAX's actions replayed.

Tolerances are float32 ones: the two packages sum in other orders (XLA's
and oneDNN's convolutions), so losses agree within 1e-5 relative, each
gradient within 1e-5 of its tensor's largest magnitude, and parameters
after 15 Adam steps within 1e-5 absolute."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu.env import env as JE, state as JST  # noqa: E402
from safelife_tpu.env import wrappers as JW  # noqa: E402
from safelife_tpu.io import levels as JL  # noqa: E402
from safelife_tpu.models import nets as JN  # noqa: E402
from safelife_tpu.training import ppo as JP  # noqa: E402
from safelife_tpu_torch.env import env as TE, state as TST  # noqa: E402
from safelife_tpu_torch.env import wrappers as TW  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.models.convert import (  # noqa: E402
    policy_params_from_flax, ppo_state_from_jax)
from safelife_tpu_torch.training import ppo as TP  # noqa: E402

SMALL_VIEW = (17, 17)  # the smallest view the trunk takes
CHANNELS = TN.TRAINING_CHANNELS


def _jax_model(view, seed=1):
    model = JN.SafeLifePolicyNetwork(unpack_channels=CHANNELS)
    params = model.init(jax.random.PRNGKey(seed),
                        np.zeros((1,) + view, np.int32))
    return model, jax.tree.map(np.asarray, params)


def _torch_model(params, view):
    net = TN.SafeLifePolicyNetwork(view_shape=view, unpack_channels=CHANNELS,
                                   device="cpu")
    net.load_state_dict(policy_params_from_flax(params))
    return net


def _batch(n, view, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.integers(0, 2 ** 28, (n,) + view).astype(np.int32),
        "actions": rng.integers(0, 9, n).astype(np.int32),
        "action_prob": rng.uniform(0.05, 1.0, n).astype(np.float32),
        "values": rng.normal(size=n).astype(np.float32),
        "returns": rng.normal(size=n).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "weight": (rng.random(n) < 0.8).astype(np.float32),
    }


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["actions"] = out["actions"].long()
    return out


def _jax_perms(key, n, epochs):
    """The permutations JAX's train_on_batch draws (ppo.py:257-262)."""
    perms = []
    for _ in range(epochs):
        key, kshuf = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(kshuf, n)))
    return perms


def _close_to_max(got, ref, tol, what):
    """|got - ref| <= tol * max|ref|, elementwise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, "%s: %g > %g * %g" % (what, err, tol, scale)


def _params_close(net, jparams, atol, what):
    ref = policy_params_from_flax(jparams)
    got = net.state_dict()
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   rtol=0, atol=atol,
                                   err_msg="%s: %s" % (what, name))


def test_ppo_config_matches_jax():
    assert dataclasses.asdict(TP.PPOConfig()) == \
        dataclasses.asdict(JP.PPOConfig())


@pytest.mark.parametrize("n", [4, 6, 10, 37, 1280, 81920])
def test_minibatch_bounds_match_jax(n):
    assert TP._minibatch_bounds(n, 4) == JP._minibatch_bounds(n, 4)


def test_compute_gae_matches_jax():
    rng = np.random.default_rng(3)
    t, n = 7, 6
    traj = {
        "rewards": rng.normal(size=(t, n)).astype(np.float32),
        "values": rng.normal(size=(t, n)).astype(np.float32),
        "done": rng.random((t, n)) < 0.25,
    }
    traj["done"][-1, :3] = True  # some lanes end at the last step
    traj["done"][2, 4] = True
    final = rng.normal(size=n).astype(np.float32)
    cfg = JP.PPOConfig()
    jret, jadv = JP.compute_gae(
        cfg, {k: jnp.asarray(v) for k, v in traj.items()}, jnp.asarray(final))
    tret, tadv = TP.compute_gae(
        TP.PPOConfig(), {k: torch.from_numpy(v) for k, v in traj.items()},
        torch.from_numpy(final))
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_calculate_loss_and_gradients_match_jax(weighted):
    model, params = _jax_model(SMALL_VIEW)
    batch = _batch(48, SMALL_VIEW)
    if not weighted:
        batch["weight"] = None
    cfg = JP.PPOConfig()
    keys = ("obs", "actions", "action_prob", "values", "returns",
            "advantages", "weight")

    def jloss(p):
        args = [None if batch[k] is None else jnp.asarray(batch[k])
                for k in keys]
        return JP.calculate_loss(cfg, model.apply, p, *args)

    (jl, jm), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    net = _torch_model(params, SMALL_VIEW)
    tb = {k: None if v is None else torch.from_numpy(v)
          for k, v in batch.items()}
    tb["actions"] = tb["actions"].long()
    with TN.learner_precision("float32", "cpu"):
        tl, tm = TP.calculate_loss(TP.PPOConfig(), net,
                                   *[tb[k] for k in keys])
        tl.backward()
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    ref = policy_params_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in net.named_parameters():
        _close_to_max(p.grad, ref[name].numpy(), 1e-5, "grad " + name)


def test_train_on_batch_matches_jax_and_continues_a_jax_learner():
    """15 Adam steps from a fresh learner, then 15 more from the JAX
    learner carried over by ppo_state_from_jax: parameters and moments
    within 1e-5 of JAX's after each."""
    model, params = _jax_model(SMALL_VIEW)
    n, cfg = 40, JP.PPOConfig()  # 5 equal minibatches of 8
    batch = _batch(n, SMALL_VIEW, seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtrain = jax.jit(JP.train_on_batch, static_argnums=(0, 1))
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    j1 = jtrain(cfg, model.apply, JP.init_ppo_state(cfg, params), jbatch,
                keys[0])
    j2 = jtrain(cfg, model.apply, j1, jbatch, keys[1])
    j1, j2 = (jax.tree.map(np.asarray, s) for s in (j1, j2))

    tcfg = TP.PPOConfig()
    t1 = TP.init_ppo_state(tcfg, _torch_model(params, SMALL_VIEW),
                           device="cpu")
    TP.train_on_batch(tcfg, t1, _torch_batch(batch), None,
                      perms=_jax_perms(keys[0], n, 3))
    t2 = ppo_state_from_jax(j1, TN.SafeLifePolicyNetwork(
        view_shape=SMALL_VIEW, unpack_channels=CHANNELS, device="cpu"))
    TP.train_on_batch(tcfg, t2, _torch_batch(batch), None,
                      perms=_jax_perms(keys[1], n, 3))
    for what, ts, js in (("fresh", t1, j1), ("carried over", t2, j2)):
        _params_close(ts.model, js.params, 1e-5, what)
        adam = js.opt_state[0]
        mu = policy_params_from_flax(adam.mu)
        nu = policy_params_from_flax(adam.nu)
        for name, p in ts.model.named_parameters():
            st = ts.optimizer.state[p]
            assert float(st["step"]) == int(adam.count)
            np.testing.assert_allclose(st["exp_avg"].numpy(),
                                       mu[name].numpy(), rtol=0, atol=1e-5)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                       nu[name].numpy(), rtol=0, atol=1e-5)


def _to_flax_layout(name, x):
    """A state-dict tensor back into the flax layout (HWIO, [in, out])."""
    x = x.detach().numpy()
    if name.endswith("weight"):
        return x.transpose(2, 3, 1, 0) if x.ndim == 4 else x.T
    return x


def _flax_path(name):
    layer = {"cnn.conv0": ("SafeLifeCNN_0", "Conv_0"),
             "cnn.conv1": ("SafeLifeCNN_0", "Conv_1"),
             "cnn.conv2": ("SafeLifeCNN_0", "Conv_2"),
             "dense": ("Dense_0",), "value": ("Dense_1",),
             "logits": ("Dense_2",)}[name.rsplit(".", 1)[0]]
    return ("params",) + layer + (
        "kernel" if name.endswith("weight") else "bias",)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_ppo_state_from_jax_round_trips():
    """Parameters, Adam moments, the Adam step count and num_steps of a
    JAX PPOState come back unchanged through the port's layout."""
    _, params = _jax_model(SMALL_VIEW, seed=3)
    cfg = JP.PPOConfig()
    js = JP.init_ppo_state(cfg, params)
    rng = np.random.default_rng(5)
    adam = js.opt_state[0]
    adam = adam._replace(
        count=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), adam.mu),
        nu=jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32),
                        adam.nu))
    js = js.replace(opt_state=(adam,) + tuple(js.opt_state[1:]),
                    num_steps=jnp.asarray(1234, jnp.int32))
    net = TN.SafeLifePolicyNetwork(view_shape=SMALL_VIEW,
                                   unpack_channels=CHANNELS, device="cpu")
    ts = ppo_state_from_jax(js, net)
    assert ts.num_steps == 1234
    for name, p in net.named_parameters():
        path = _flax_path(name)
        st = ts.optimizer.state[p]
        assert float(st["step"]) == 7
        np.testing.assert_array_equal(_to_flax_layout(name, p),
                                      _get(params, path))
        np.testing.assert_array_equal(_to_flax_layout(name, st["exp_avg"]),
                                      _get(adam.mu, path))
        np.testing.assert_array_equal(
            _to_flax_layout(name, st["exp_avg_sq"]), _get(adam.nu, path))


SLICE_VIEW = (25, 25)
SLICE_LANES, SLICE_STEPS = 2, 5  # 10 samples: 5 minibatches of 2


def test_train_iteration_matches_jax():
    """One whole iteration on a one-level append-still pool, lanes timing
    out at step 3 and resetting, the inaction baseline on: JAX's actions
    and permutations replayed. Trajectory integers exact, values and
    probabilities within 1e-5, parameters within 1e-5 after the update."""
    path = "benchmarks/v1.0/append-still.npz"
    jpool = JST.pack_levels(JL.load_levels(path)[:1])
    tpool = TST.pack_levels(TL.load_levels(path)[:1], device="cpu")
    kw = dict(view_shape=SLICE_VIEW, output_channels=None, time_limit=3)
    jcfg, tcfg = JE.EnvConfig(**kw), TE.EnvConfig(**kw)
    wkw = dict(se_baseline="inaction")
    jw, tw = JW.WrapperConfig(**wkw), TW.WrapperConfig(**wkw)
    jpc = JP.PPOConfig(steps_per_env=SLICE_STEPS)
    tpc = TP.PPOConfig(steps_per_env=SLICE_STEPS)
    model, params = _jax_model(SLICE_VIEW)
    b, coef, mpf = SLICE_LANES, 1.0, 1.0

    key = jax.random.PRNGKey(5)
    krol, ktrain = jax.random.split(key)
    jws, jobs = JW.reset(jcfg, jw, jpool, jax.random.PRNGKey(0), b)
    jtraj, _, jfinal = JP.rollout(jcfg, jw, jpool, model.apply, params, jws,
                                  jobs, krol, SLICE_STEPS, coef, mpf)
    jps, jws2, jobs2, jm = JP.train_iteration(
        jcfg, jw, jpc, model.apply, jpool, JP.init_ppo_state(jpc, params),
        jws, jobs, key, coef, mpf)
    actions = torch.from_numpy(
        np.asarray(jtraj["actions"]).reshape(SLICE_STEPS, b, -1))
    n = SLICE_STEPS * b * tpool.num_agents
    perms = _jax_perms(ktrain, n, jpc.epochs_per_batch)

    net = _torch_model(params, SLICE_VIEW)
    tws, tobs = TW.reset(tcfg, tw, tpool, b, device="cpu")
    gen = torch.Generator().manual_seed(0)
    ttraj, _, tfinal = TP.rollout(tcfg, tw, tpool, net, tws, tobs, gen,
                                  SLICE_STEPS, coef, mpf, actions=actions)
    for k in ("obs", "actions", "rewards", "done", "weight"):
        np.testing.assert_array_equal(ttraj[k].numpy(),
                                      np.asarray(jtraj[k]), err_msg=k)
    for k in ("values", "action_prob"):
        np.testing.assert_allclose(ttraj[k].numpy(), np.asarray(jtraj[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), rtol=0,
                               atol=1e-5)
    done = ttraj["done"].numpy()
    assert done[2].all() and not done[3:].any()  # reset mid-rollout

    tps = TP.init_ppo_state(tpc, net, device="cpu")
    tws, tobs = TW.reset(tcfg, tw, tpool, b, device="cpu")
    tps, tws2, tobs2, tm = TP.train_iteration(
        tcfg, tw, tpc, tpool, tps, tws, tobs, gen, coef, mpf,
        actions=actions, perms=perms, device="cpu")
    assert tps.num_steps == int(jps.num_steps) == SLICE_STEPS * b
    _params_close(tps.model, jax.tree.map(np.asarray, jps.params), 1e-5,
                  "updated parameters")
    np.testing.assert_array_equal(tobs2.numpy(), np.asarray(jobs2))
    np.testing.assert_array_equal(tws2.env.board.numpy(),
                                  np.asarray(jws2.env.board))
    np.testing.assert_array_equal(tws2.baseline_board.numpy(),
                                  np.asarray(jws2.baseline_board))
    scalars = ("loss", "policy_loss", "value_loss", "entropy", "reward_mean",
               "values_mean", "advantages_mean")
    assert set(tm) == set(scalars) | {"episodes", "ep_samples"} == set(jm)
    for k in scalars:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for group in ("episodes", "ep_samples"):
        assert set(tm[group]) == set(jm[group])
        for k in jm[group]:
            np.testing.assert_array_equal(
                tm[group][k].numpy(), np.asarray(jm[group][k]),
                err_msg="%s[%s]" % (group, k))


def test_train_chunk_equals_its_iterations():
    """train_chunk runs train_iteration n times on one generator and
    concatenates the episode records."""
    levels = TL.load_levels("benchmarks/v1.0/append-spawn.npz")[:3]
    cfg = TE.EnvConfig(view_shape=SMALL_VIEW, output_channels=None,
                       time_limit=3)
    wcfg = TW.WrapperConfig(se_baseline="inaction")
    pcfg = TP.PPOConfig(steps_per_env=2)
    _, params = _jax_model(SMALL_VIEW)
    runs = []
    for chunked in (True, False):
        pool = TST.pack_levels(levels, device="cpu")
        ps = TP.init_ppo_state(pcfg, _torch_model(params, SMALL_VIEW),
                               device="cpu")
        ws, obs = TW.reset(cfg, wcfg, pool, 3, device="cpu")
        gen = torch.Generator().manual_seed(4)
        if chunked:
            ps, ws, obs, m = TP.train_chunk(cfg, wcfg, pcfg, pool, ps, ws,
                                            obs, gen, 2, 1.0, device="cpu")
        else:
            ms = []
            for _ in range(2):
                ps, ws, obs, mi = TP.train_iteration(
                    cfg, wcfg, pcfg, pool, ps, ws, obs, gen, 1.0,
                    device="cpu")
                ms.append(mi)
            m = dict(ms[-1])
            for g in ("episodes", "ep_samples"):
                m[g] = {k: torch.cat([x[g][k] for x in ms]) for k in m[g]}
        runs.append((ps, ws, m))
    (pa, wa, ma), (pb, wb, mb) = runs
    assert pa.num_steps == pb.num_steps == 2 * 2 * 3
    for (name, x), y in zip(pa.model.state_dict().items(),
                            pb.model.state_dict().values()):
        assert torch.equal(x, y), name
    assert torch.equal(wa.env.board, wb.env.board)
    assert ma["episodes"]["lane_done"].shape == (2 * 2 * 3,)
    assert ma["ep_samples"]["found"].shape == (2 * 2,)
    for g in ("episodes", "ep_samples"):
        for k in ma[g]:
            assert torch.equal(ma[g][k], mb[g][k]), (g, k)
    assert float(ma["loss"]) == float(mb["loss"])


def test_rollout_weights_mask_padded_agents():
    """A one-agent level padded to two agents: the padded slot's samples
    weigh nothing, as in the JAX package."""
    levels = TL.load_levels("benchmarks/v1.0/append-still.npz")[:2]
    pool = TST.pack_levels(levels, pad_agents=2, device="cpu")
    cfg = TE.EnvConfig(view_shape=SMALL_VIEW, output_channels=None,
                       time_limit=20)
    wcfg = TW.WrapperConfig(single_agent=False)
    _, params = _jax_model(SMALL_VIEW)
    ws, obs = TW.reset(cfg, wcfg, pool, 4, device="cpu")
    traj, _, final = TP.rollout(cfg, wcfg, pool,
                                _torch_model(params, SMALL_VIEW), ws, obs,
                                torch.Generator().manual_seed(0), 3)
    w = traj["weight"].numpy().reshape(3, 4, 2)
    assert (w[:, :, 0] == 1.0).all() and (w[:, :, 1] == 0.0).all()
    assert traj["obs"].shape == (3, 8) + SMALL_VIEW
    assert traj["obs"].dtype == torch.int32 and final.shape == (8,)
