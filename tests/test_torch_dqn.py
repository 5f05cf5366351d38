"""The port's DQN (``models/nets.py::SafeLifeQNetwork``,
``training/dqn.py``, the Q branch of ``training/runner.py`` and
``training/train.py::train_dqn``) against the JAX package's, on the CPU.

Integer results are held bit for bit: the n-step rings, the emissions and
the replay buffer (wrapping, and pushes of more valid entries than it
holds), the env state of a sequence of ``collect_and_optimize`` units
with JAX's actions and sample indices replayed, and the episodes of a Q
network's benchmark played greedily. Float results are float32 ones: the
Q-values, the TD loss and its gradients within 1e-5 (relative, or of the
tensor's largest magnitude), the parameters after the first Adam step
within 1e-5 absolute and after later ones within 1e-2 of the update's
norm (a rounding difference in a gradient near zero is a whole Adam step
of the learning rate)."""

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
from safelife_tpu.training import dqn as JD  # noqa: E402
from safelife_tpu.training import global_config as JGC  # noqa: E402
from safelife_tpu.training import runner as JR  # noqa: E402
from safelife_tpu_torch.env import env as TE, state as TST  # noqa: E402
from safelife_tpu_torch.env import wrappers as TW  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402
from safelife_tpu_torch.loggers import SafeLifeLogger  # noqa: E402
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.models.convert import (  # noqa: E402
    dqn_state_from_jax, q_params_from_flax)
from safelife_tpu_torch.training import dqn as TD  # noqa: E402
from safelife_tpu_torch.training import global_config as TGC  # noqa: E402
from safelife_tpu_torch.training import runner as TR  # noqa: E402
from safelife_tpu_torch.training import train as TT  # noqa: E402
from safelife_tpu_torch.training.checkpoints import (  # noqa: E402
    CheckpointManager)
from safelife_tpu_torch.training.env_factory import (  # noqa: E402
    build_environments)

VIEW = (25, 25)
CHANNELS = TN.TRAINING_CHANNELS
LANES = 8


def _jax_q(unpack=True, seed=1, view=VIEW):
    model = JN.SafeLifeQNetwork(unpack_channels=CHANNELS if unpack else None)
    dummy = (np.zeros((1,) + view, np.int32) if unpack
             else np.zeros((1,) + view + (len(CHANNELS),), np.float32))
    return model, jax.tree.map(np.asarray,
                               model.init(jax.random.PRNGKey(seed), dummy))


def _torch_q(params, unpack=True, view=VIEW):
    kw = ({"unpack_channels": CHANNELS} if unpack
          else {"num_channels": len(CHANNELS)})
    net = TN.SafeLifeQNetwork(view_shape=view, device="cpu", **kw)
    net.load_state_dict(q_params_from_flax(params))
    return net


def _eq(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, "%s: %s vs %s" % (what, got.shape,
                                                     ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _close_to_max(got, ref, tol, what):
    """|got - ref| <= tol * max|ref|, elementwise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, "%s: %g > %g * %g" % (what, err, tol, scale)


def test_dqn_config_matches_jax():
    assert dataclasses.asdict(TD.DQNConfig()) == \
        dataclasses.asdict(JD.DQNConfig())
    overrides = {"dqn.gamma": 0.9, "dqn.replay_initial": 128,
                 "learning_rate": 1e-3,
                 "dqn.epsilon_points": [[0, 1.0], [100, 0.1]]}
    configs = []
    for gc, mod in ((JGC, JD), (TGC, TD)):
        gc.config.clear()
        gc.config.update(overrides)
        configs.append(gc.build_config(mod.DQNConfig, "dqn"))
        gc.config.clear()
    assert dataclasses.asdict(configs[0]) == dataclasses.asdict(configs[1])
    assert configs[1].replay_initial == 128


@pytest.mark.parametrize("unpack", [True, False], ids=["packed", "unpacked"])
def test_q_network_matches_jax(unpack):
    model, params = _jax_q(unpack)
    rng = np.random.default_rng(2)
    if unpack:
        obs = rng.integers(0, 2 ** 28, (12,) + VIEW).astype(np.int32)
    else:
        obs = (rng.random((12,) + VIEW + (len(CHANNELS),)) < 0.3).astype(
            np.float32)
    ref = np.asarray(model.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        got = _torch_q(params, unpack)(torch.from_numpy(obs))
    assert got.shape == (12, 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def _to_flax_layout(x):
    x = x.detach().numpy()
    if x.ndim == 4:
        return x.transpose(2, 3, 1, 0)
    return x.T if x.ndim == 2 else x


def _flax_leaf(tree, name):
    """The flax leaf of a port state-dict name: the dense layers by flax's
    construction order (outer layer first)."""
    layer, kind = name.rsplit(".", 1)
    path = {"cnn.conv0": ("SafeLifeCNN_0", "Conv_0"),
            "cnn.conv1": ("SafeLifeCNN_0", "Conv_1"),
            "cnn.conv2": ("SafeLifeCNN_0", "Conv_2"),
            "adv": ("Dense_0",), "adv_hidden": ("Dense_1",),
            "value": ("Dense_2",), "value_hidden": ("Dense_3",)}[layer]
    tree = tree.get("params", tree)
    for k in path + ("kernel" if kind == "weight" else "bias",):
        tree = tree[k]
    return np.asarray(tree)


def test_q_params_from_flax_round_trips():
    _, params = _jax_q(seed=4)
    sd = q_params_from_flax(params)
    net = TN.SafeLifeQNetwork(unpack_channels=CHANNELS, device="cpu")
    assert set(sd) == set(net.state_dict())
    shapes = {"adv.weight": (9, 256), "adv_hidden.weight": (256, 576),
              "value.weight": (1, 256), "value_hidden.weight": (256, 576)}
    for name, x in sd.items():
        assert tuple(x.shape) == tuple(net.state_dict()[name].shape), name
        assert shapes.get(name, tuple(x.shape)) == tuple(x.shape), name
        np.testing.assert_array_equal(_to_flax_layout(x),
                                      _flax_leaf(params, name), err_msg=name)


def test_dqn_state_from_jax_round_trips():
    """Parameters, target parameters, Adam's moments and count,
    ``num_steps``, the replay and the rings of a JAX DQNState come back
    unchanged through the port's layout."""
    _, params = _jax_q(seed=5)
    _, target = _jax_q(seed=6)
    cfg = JD.DQNConfig(replay_size=32)
    js = JD.init_dqn_state(cfg, params, 3, VIEW, jnp.int32)
    rng = np.random.default_rng(5)
    adam = js.opt_state[0]
    adam = adam._replace(
        count=jnp.asarray(11, jnp.int32),
        mu=jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), adam.mu),
        nu=jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32),
                        adam.nu))
    replay = js.replay.replace(
        obs=rng.integers(0, 2 ** 28, js.replay.obs.shape).astype(np.int32),
        reward=rng.normal(size=32).astype(np.float32),
        idx=jnp.asarray(40, jnp.int32))
    js = js.replace(target_params=target, replay=replay,
                    opt_state=(adam,) + tuple(js.opt_state[1:]),
                    num_steps=jnp.asarray(4321, jnp.int32))
    net = TN.SafeLifeQNetwork(unpack_channels=CHANNELS, device="cpu")
    ts = dqn_state_from_jax(js, net)
    assert ts.num_steps == 4321 and ts.replay.idx == 40
    assert ts.replay.size() == ts.replay.capacity == 32
    _eq(ts.replay.obs, replay.obs, "replay obs")
    _eq(ts.replay.reward, replay.reward, "replay reward")
    _eq(ts.traj.obs, js.traj.obs, "ring obs")
    for name, p in net.named_parameters():
        st = ts.optimizer.state[p]
        assert float(st["step"]) == 11
        np.testing.assert_array_equal(_to_flax_layout(p),
                                      _flax_leaf(params, name))
        np.testing.assert_array_equal(
            _to_flax_layout(ts.target_model.state_dict()[name]),
            _flax_leaf(target, name))
        np.testing.assert_array_equal(_to_flax_layout(st["exp_avg"]),
                                      _flax_leaf(adam.mu, name))
        np.testing.assert_array_equal(_to_flax_layout(st["exp_avg_sq"]),
                                      _flax_leaf(adam.nu, name))
    assert not any(p.requires_grad for p in ts.target_model.parameters())


def test_epsilon_schedule_matches_jax():
    steps = np.array([0, 1, 49_999, 5e4, 5e4 + 1, 123_456, 5e5, 777_777,
                      2_000_000, 4e6, 4e6 + 1, 1e8], np.float32)
    cfg = JD.DQNConfig()
    ref = np.asarray(JD.epsilon_schedule(cfg, jnp.asarray(steps)))
    got = TD.epsilon_schedule(TD.DQNConfig(), torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-7)
    for s in (0, 60_000, 4_000_000, 9_000_000):
        assert abs(float(TD.epsilon_schedule(TD.DQNConfig(), s))
                   - float(JD.epsilon_schedule(cfg, s))) <= 1e-7
    assert float(TD.epsilon_schedule(TD.DQNConfig(), 0)) == 1.0
    assert float(TD.epsilon_schedule(TD.DQNConfig(), 1e9)) == \
        np.float32(0.03)


REPLAY_FIELDS = ("obs", "action", "reward", "next_obs", "done")


def _replay_eq(tbuf, jbuf, what):
    assert tbuf.idx == int(jbuf.idx), what
    for name in REPLAY_FIELDS:
        _eq(getattr(tbuf, name), getattr(jbuf, name),
            "%s: replay %s" % (what, name))


def _traj_eq(ttraj, jtraj, what):
    for name in ("obs", "action", "reward", "filled"):
        _eq(getattr(ttraj, name), getattr(jtraj, name),
            "%s: ring %s" % (what, name))


#: (n, lanes, capacity, steps a push): a buffer that wraps; one into which
#: a push of several steps lands more valid entries than it holds (JAX
#: segments that push at the capacity); and a default-sized n.
RING_CASES = [(3, 6, 16, 4), (5, 6, 24, 3), (5, 4, 512, 1)]


@pytest.mark.parametrize("n,lanes,cap,per_push", RING_CASES)
def test_step_trajectories_and_push_match_jax(n, lanes, cap, per_push):
    """Random rewards, done and validity (lanes in pairs, as a two-agent
    level's flattened slots: the second agent of a pair often padded or
    finished) over 24 steps: rings, emission planes and the replay bit for
    bit after every push."""
    rng = np.random.default_rng(n * 100 + cap)
    obs_shape = (4, 3)
    jcfg = JD.DQNConfig(multi_step=n, gamma=0.97)
    tcfg = TD.DQNConfig(multi_step=n, gamma=0.97)
    jtraj = JD.init_trajectories(lanes, n, obs_shape, jnp.int32)
    ttraj = TD.init_trajectories(lanes, n, obs_shape, torch.int32,
                                 device="cpu")
    jbuf = JD.init_replay(cap, obs_shape, jnp.int32)
    tbuf = TD.init_replay(cap, obs_shape, torch.int32, device="cpu")
    obs = rng.integers(0, 2 ** 28, (lanes,) + obs_shape).astype(np.int32)
    # Under jit, as the JAX package runs it (XLA fuses the discounting).
    jstep = jax.jit(JD.step_trajectories, static_argnums=0)
    jems, tems, pushes, wrapped = [], [], 0, False
    for t in range(24):
        nxt = rng.integers(0, 2 ** 28, (lanes,) + obs_shape).astype(np.int32)
        act = rng.integers(0, 9, lanes).astype(np.int32)
        rew = rng.normal(size=lanes).astype(np.float32)
        done = rng.random(lanes) < 0.2
        valid = rng.random(lanes) < 0.9
        valid[1::2] &= rng.random(lanes // 2) < 0.5
        jtraj, jem = jstep(
            jcfg, jtraj, jnp.asarray(obs), jnp.asarray(act),
            jnp.asarray(rew), jnp.asarray(nxt), jnp.asarray(done),
            jnp.asarray(valid))
        ttraj, tem = TD.step_trajectories(
            tcfg, ttraj, torch.from_numpy(obs), torch.from_numpy(act).long(),
            torch.from_numpy(rew), torch.from_numpy(nxt),
            torch.from_numpy(done), torch.from_numpy(valid))
        what = "n=%d step %d" % (n, t)
        _traj_eq(ttraj, jtraj, what)
        for name in ("action", "reward", "done", "valid"):
            _eq(tem[name], jem[name], "%s: emission %s" % (what, name))
        jems.append(jem)
        tems.append(tem)
        if len(tems) == per_push:
            stacked = jax.tree.map(lambda *x: jnp.stack(x), *jems)
            before = tbuf.idx
            jbuf = JD.push_emissions(jbuf, stacked)
            tbuf = TD.push_emissions(tbuf, tems)
            _replay_eq(tbuf, jbuf, what)
            wrapped |= tbuf.idx > cap
            pushes += int(tbuf.idx - before > cap)
            jems, tems = [], []
        obs = nxt
    if cap < 100:
        assert wrapped
    if cap < 24:
        assert pushes, "no push held more valid entries than the buffer"


def test_push_masked_matches_jax():
    rng = np.random.default_rng(9)
    cap, shape = 8, (3,)
    jbuf = JD.init_replay(cap, shape, jnp.int32)
    tbuf = TD.init_replay(cap, shape, torch.int32, device="cpu")
    for m in (5, 7, 3):
        data = {"obs": rng.integers(0, 100, (m,) + shape).astype(np.int32),
                "action": rng.integers(0, 9, m).astype(np.int32),
                "reward": rng.normal(size=m).astype(np.float32),
                "next_obs": rng.integers(0, 100, (m,) + shape).astype(
                    np.int32),
                "done": rng.random(m) < 0.5, "valid": rng.random(m) < 0.7}
        jbuf = JD.push_masked(jbuf, *(jnp.asarray(data[k]) for k in (
            REPLAY_FIELDS + ("valid",))))
        tbuf = TD.push_masked(tbuf, *(torch.from_numpy(data[k]) for k in (
            REPLAY_FIELDS + ("valid",))))
        _replay_eq(tbuf, jbuf, "push of %d" % m)
    assert tbuf.idx > cap


def _replay_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.integers(0, 2 ** 28, (n,) + VIEW).astype(np.int32),
        "action": rng.integers(0, 9, n).astype(np.int32),
        "reward": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.integers(0, 2 ** 28, (n,) + VIEW).astype(np.int32),
        "done": rng.random(n) < 0.3,
    }


def test_td_loss_and_gradients_match_jax():
    model, params = _jax_q(seed=7)
    _, target = _jax_q(seed=8)
    batch = _replay_batch(24)
    jcfg = JD.DQNConfig()
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JD.td_loss(jcfg, model.apply, p, target,
                             {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    net, tnet = _torch_q(params), _torch_q(target)
    with TN.learner_precision("float32", "cpu"):
        tl, tm = TD.td_loss(TD.DQNConfig(), net, tnet,
                            {k: torch.from_numpy(v) for k, v in batch.items()})
        tl.backward()
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    ref = q_params_from_flax(jax.tree.map(np.asarray, jg))
    for name, p in net.named_parameters():
        _close_to_max(p.grad, ref[name].numpy(), 1e-5, "grad " + name)
    assert all(p.grad is None for p in tnet.parameters())


def test_act_epsilon_greedy():
    q = torch.zeros((20000, 9))
    q[:, 4] = 1.0
    gen = torch.Generator().manual_seed(0)
    net = lambda obs: q  # noqa: E731
    assert (TD.act_epsilon_greedy(net, None, 0.0, gen) == 4).all()
    freq = np.bincount(TD.act_epsilon_greedy(net, None, 1.0, gen).numpy(),
                       minlength=9) / 20000
    np.testing.assert_allclose(freq, 1 / 9, atol=0.015)
    acts = TD.act_epsilon_greedy(net, None, 0.3, gen).numpy()
    assert abs((acts != 4).mean() - 0.3 * 8 / 9) < 0.015


#: The sequence's DQNConfig: a buffer that wraps, warm after a few units,
#: the target synced every 3 units.
SEQ_CFG = dict(batch_size=16, replay_size=64, replay_initial=40,
               target_update_interval=48)
SEQ_STEPS, SEQ_UNITS = 2, 8  # 16 env steps a unit


def _jax_unit(jcfg, jw, dcfg, apply, jpool, jd, jws, jobs, key):
    """One JAX collect_and_optimize unit, and the actions and sample
    indices it drew (collect_and_optimize_impl's keys, dqn.py:283-327)."""
    keys = jax.random.split(key, SEQ_STEPS + 1)
    ws, obs, num, acts = jws, jobs, int(jd.num_steps), []
    for t in range(SEQ_STEPS):
        ka, ke = jax.random.split(keys[t])
        b, a = obs.shape[:2]
        act = JD.act_epsilon_greedy(
            apply, jd.params, obs.reshape((b * a,) + obs.shape[2:]),
            JD.epsilon_schedule(dcfg, num), ka)
        acts.append(np.asarray(act).reshape(b, a))
        ws, obs, *_ = JW.step(jcfg, jw, jpool, ws, act.reshape(b, a), ke)
        num += b
    out = JD.collect_and_optimize(jcfg, jw, dcfg, apply, jpool, jd, jws,
                                  jobs, key, SEQ_STEPS)
    _eq(out[1].env.board, ws.env.board, "replayed JAX actions")
    size = int(out[3]["replay_size"])
    sample = np.array(jax.random.randint(keys[-1], (dcfg.batch_size,), 0,
                                         max(size, 1)))
    return out, np.stack(acts), sample


def _flat_params(sd):
    return torch.cat([sd[k].reshape(-1) for k in sorted(sd)]).double()


def test_collect_and_optimize_sequence_matches_jax():
    """Eight units of 8 lanes x 2 steps on a one-level append-still pool
    (lanes time out at step 7 and reset onto the same level), JAX's
    actions and sample indices replayed: cold units, warm ones, target
    crossings and a replay that wraps. Env state, rings and replay bit for
    bit; the loss metrics within 1e-5 relative until the first update and
    1e-4 after; the parameters and the target within 1e-5 after the first
    warm step, within 1e-2 of the update's norm after."""
    path = "benchmarks/v1.0/append-still.npz"
    jpool = JST.pack_levels(JL.load_levels(path)[:1])
    tpool = TST.pack_levels(TL.load_levels(path)[:1], device="cpu")
    kw = dict(view_shape=VIEW, output_channels=None, time_limit=7)
    jcfg, tcfg = JE.EnvConfig(**kw), TE.EnvConfig(**kw)
    jw, tw = JW.WrapperConfig(), TW.WrapperConfig()
    jdc, tdc = JD.DQNConfig(**SEQ_CFG), TD.DQNConfig(**SEQ_CFG)
    model, params = _jax_q(seed=3)
    jd = JD.init_dqn_state(jdc, params, LANES, VIEW, jnp.int32)
    jws, jobs = JW.reset(jcfg, jw, jpool, jax.random.PRNGKey(0), LANES)
    net = _torch_q(params)
    td = TD.init_dqn_state(tdc, net, LANES, VIEW, torch.int32, device="cpu")
    tws, tobs = TW.reset(tcfg, tw, tpool, LANES, device="cpu")
    p0 = _flat_params(net.state_dict())
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(11)
    seen = {"cold": 0, "warm": 0, "crossed_warm": 0}
    first_warm = True
    for u in range(SEQ_UNITS):
        key, k = jax.random.split(key)
        (jd, jws, jobs, jm), acts, sample = _jax_unit(
            jcfg, jw, jdc, model.apply, jpool, jd, jws, jobs, k)
        td, tws, tobs, tm = TD.collect_and_optimize(
            tcfg, tw, tdc, tpool, td, tws, tobs, gen, SEQ_STEPS,
            actions=torch.from_numpy(acts), sample_idx=sample, device="cpu")
        what = "unit %d" % u
        per_unit = LANES * SEQ_STEPS
        assert td.num_steps == int(jd.num_steps) == (u + 1) * per_unit
        _eq(tws.env.board, jws.env.board, what + ": boards")
        _eq(tobs, jobs, what + ": views")
        _traj_eq(td.traj, jd.traj, what)
        _replay_eq(td.replay, jd.replay, what)
        assert tm["replay_size"] == int(jm["replay_size"])
        assert float(tm["epsilon"]) == float(jm["epsilon"])
        for k in jm["episodes"]:
            _eq(tm["episodes"][k], jm["episodes"][k], "%s: episodes[%s]"
                % (what, k))
        for k in ("loss", "q_model_mean", "q_model_max", "q_target_mean",
                  "q_target_max"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4 if seen["warm"] else 1e-5,
                                       atol=1e-6, err_msg=what + ": " + k)
        warm = tm["replay_size"] >= tdc.replay_initial
        every = tdc.target_update_interval
        crossed = td.num_steps // every > (td.num_steps - per_unit) // every
        seen["warm" if warm else "cold"] += 1
        seen["crossed_warm"] += warm and crossed
        for tmodel, jparams, label in (
                (td.model, jd.params, "params"),
                (td.target_model, jd.target_params, "target")):
            got = tmodel.state_dict()
            ref = q_params_from_flax(jax.tree.map(np.asarray, jparams))
            if first_warm or not warm:
                for name in ref:
                    np.testing.assert_allclose(
                        got[name].numpy(), ref[name].numpy(), rtol=0,
                        atol=1e-5, err_msg="%s: %s %s" % (what, label, name))
            else:
                diff = (_flat_params(got) - _flat_params(ref)).norm()
                moved = (_flat_params(ref) - p0).norm()
                assert diff <= 1e-2 * moved, (what, label, diff, moved)
        if not warm:
            assert torch.equal(_flat_params(td.model.state_dict()), p0)
        if crossed:
            for a, b in zip(td.model.parameters(),
                            td.target_model.parameters()):
                assert torch.equal(a, b)
        first_warm = first_warm and not warm
        # Adam's count advances on warm units only.
        adam = td.optimizer.state
        assert len(adam) == (len(list(net.parameters())) if warm else 0)
        assert all(float(s["step"]) == seen["warm"] for s in adam.values())
    assert seen["cold"] >= 2 and seen["warm"] >= 3
    assert seen["crossed_warm"] >= 1
    assert td.replay.idx > td.replay.capacity


def test_train_chunk_equals_its_units():
    levels = TL.load_levels("benchmarks/v1.0/append-spawn.npz")[:3]
    cfg = TE.EnvConfig(view_shape=VIEW, output_channels=None, time_limit=5)
    wcfg = TW.WrapperConfig(se_baseline="inaction")
    dcfg = TD.DQNConfig(batch_size=8, replay_size=128, replay_initial=8)
    _, params = _jax_q(seed=2)
    runs = []
    for chunked in (True, False):
        pool = TST.pack_levels(levels, device="cpu")
        ds = TD.init_dqn_state(dcfg, _torch_q(params), 3, VIEW, torch.int32,
                               device="cpu")
        ws, obs = TW.reset(cfg, wcfg, pool, 3, device="cpu")
        gen = torch.Generator().manual_seed(4)
        if chunked:
            ds, ws, obs, m = TD.train_chunk(cfg, wcfg, dcfg, pool, ds, ws,
                                            obs, gen, 2, 4, device="cpu")
        else:
            eps = []
            for _ in range(4):
                ds, ws, obs, m = TD.collect_and_optimize(
                    cfg, wcfg, dcfg, pool, ds, ws, obs, gen, 2, device="cpu")
                eps.append(m.pop("episodes"))
            m["episodes"] = {k: torch.cat([e[k].reshape(
                (-1,) + tuple(e[k].shape[2:])) for e in eps])
                for k in eps[0]}
        runs.append((ds, ws, m))
    (da, wa, ma), (db, wb, mb) = runs
    assert da.num_steps == db.num_steps == 4 * 2 * 3
    assert da.replay.idx == db.replay.idx > dcfg.replay_initial
    for (name, x), y in zip(da.model.state_dict().items(),
                            db.model.state_dict().values()):
        assert torch.equal(x, y), name
    assert torch.equal(wa.env.board, wb.env.board)
    assert ma["episodes"]["lane_done"].shape == (4 * 2 * 3,)
    for k in ma["episodes"]:
        assert torch.equal(ma["episodes"][k], mb["episodes"][k]), k
    assert float(ma["loss"]) == float(mb["loss"])


BENCH_ARCHIVE = "benchmarks/v1.0/prune-dynamic.npz"


def test_q_benchmark_matches_jax(monkeypatch, tmp_path):
    """A Q network's benchmark played greedily (``EPSILON_TESTING`` 0 in
    both packages): 8 prune-dynamic episodes on 4 levels in two batches,
    side effects scored; records and summary within 1e-9 of JAX's."""
    monkeypatch.setattr(JR, "EPSILON_TESTING", 0.0)
    monkeypatch.setattr(TR, "EPSILON_TESTING", 0.0)
    model, params = _jax_q(seed=12)
    kw = dict(view_shape=VIEW, output_channels=None, time_limit=30)
    common = dict(num_samples=20, lanes=4)
    jrec, jsum = JR.benchmark(
        model.apply, params, JL.load_levels(BENCH_ARCHIVE)[:4], 8,
        env_cfg=JE.EnvConfig(**kw), key=jax.random.PRNGKey(0), **common)
    trec, tsum = TR.benchmark(
        _torch_q(params).eval(), TL.load_levels(BENCH_ARCHIVE)[:4], 8,
        env_cfg=TE.EnvConfig(**kw), generator=torch.Generator().manual_seed(0),
        device="cpu", **common)
    assert len(trec) == len(jrec) == 8
    for i, (t, j) in enumerate(zip(trec, jrec)):
        assert set(t) == set(j), i
        for k in j:
            if k == "side_effects":
                assert set(t[k]) == set(j[k])
                for c in j[k]:
                    np.testing.assert_allclose(t[k][c], j[k][c], rtol=0,
                                               atol=1e-9)
            elif isinstance(j[k], float):
                assert abs(t[k] - j[k]) <= 1e-9, (i, k)
            else:
                assert t[k] == j[k], (i, k)
    for k in jsum:
        assert abs(tsum[k] - jsum[k]) <= 1e-9, k
    # Not a degenerate policy: the agents moved.
    assert len({r["length"] for r in trec} | {r["reward"] for r in trec}) > 1


def _dqn_bundle(tmp_path):
    TGC.config.clear()
    TGC.config._used.clear()
    SafeLifeLogger.cumulative_stats.clear()
    TGC.config.update({"env_type": "append-still", "dqn.replay_size": 512,
                       "dqn.replay_initial": 64, "dqn.report_interval": 256,
                       "dqn.target_update_interval": 600})
    return build_environments(TGC.config, data_dir=str(tmp_path),
                              num_envs=LANES, pool_size=4, procgen_workers=0,
                              device="cpu")


def test_train_dqn_checkpoints_and_resumes(tmp_path, monkeypatch):
    """``train_dqn`` on the CPU: a chunk of 32 units of 4 steps, reports,
    a terminal checkpoint with the target network; a resume restores the
    learner, the target, Adam, the env state and the pool, and re-warms
    an empty replay."""
    bundle = _dqn_bundle(tmp_path)
    model, ds = TT.train_dqn(bundle, total_steps=1024, batch_size=LANES,
                             seed=2, data_dir=str(tmp_path), device="cpu")
    assert ds.num_steps == 1024 and ds.replay.idx > 64
    assert all(torch.isfinite(p).all() for p in model.parameters())
    ckpt = CheckpointManager(str(tmp_path))
    saved, extra, step = ckpt.restore(device="cpu")
    assert step == 1024 and extra["training_steps"] == 1024
    assert set(saved) == {"params", "target_params", "opt_state",
                          "num_steps", "env_state", "pool"}
    for k, v in ds.target_model.state_dict().items():
        assert torch.equal(saved["target_params"][k], v), k
    assert not all(torch.equal(saved["target_params"][k], v)
                   for k, v in saved["params"].items())

    restored = []
    real = TT._restore_latest

    def spy(ckpt, learner, ws, bundle, device):
        got = real(ckpt, learner, ws, bundle, device)
        restored.append((got, learner.num_steps, learner.replay.idx,
                         {k: v.clone() for k, v in
                          learner.target_model.state_dict().items()},
                         {k: v.clone() for k, v in
                          learner.model.state_dict().items()},
                         [(float(st["step"]), st["exp_avg"].clone())
                          for st in learner.optimizer.state.values()]))
        return got

    monkeypatch.setattr(TT, "_restore_latest", spy)
    bundle = _dqn_bundle(tmp_path)
    model2, ds2 = TT.train_dqn(bundle, total_steps=2048, batch_size=LANES,
                               seed=2, data_dir=str(tmp_path), device="cpu")
    (ws, obs, _, rstep), n0, idx0, target, params, opt = restored[-1]
    assert rstep == n0 == 1024 and idx0 == 0 and obs is not None
    assert torch.equal(ws.env.board, saved["env_state"].env.board)
    for k in saved["params"]:
        assert torch.equal(params[k], saved["params"][k]), k
        assert torch.equal(target[k], saved["target_params"][k]), k
    for (step_, avg), st in zip(opt, saved["opt_state"]["state"].values()):
        assert step_ == float(st["step"]) > 0
        assert torch.equal(avg, st["exp_avg"])
    assert ds2.num_steps == 2048 and ckpt.steps() == [1024, 2048]
    # The buffer refilled from empty: at most one chunk's emissions.
    assert 64 <= ds2.replay.idx <= 1024 * 6
