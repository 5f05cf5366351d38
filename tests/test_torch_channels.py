"""``env.packed_obs: false``: the env unpacks K3's packed views into uint8
channels [B, A, vh, vw, 15] and the learners store and train on them, on
the CPU.

``build_environments`` in this mode gives the JAX package's configuration
and, stepped with the same actions, its uint8 observations bit for bit.
The unpack is exact, so a PPO iteration and a DQN unit give the same
losses and the same stored observations (unpacked) in both modes, as
``tests/test_training.py::test_ppo_iteration_loss_parity`` asserts for
the JAX package."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu.env import env as JE  # noqa: E402
from safelife_tpu.training import env_factory as JF  # noqa: E402
from safelife_tpu.training import global_config as JGC  # noqa: E402
from safelife_tpu_torch.env import env as TE, wrappers as TW  # noqa: E402
from safelife_tpu_torch.env.state import pack_levels  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.training import dqn as TD  # noqa: E402
from safelife_tpu_torch.training import env_factory as TF  # noqa: E402
from safelife_tpu_torch.training import global_config as TGC  # noqa: E402
from safelife_tpu_torch.training import ppo as TP  # noqa: E402
from safelife_tpu_torch.training import train as TT  # noqa: E402

CHANNELS = TN.TRAINING_CHANNELS
LANES = 4


@pytest.fixture(autouse=True)
def fresh_config():
    for cfg in (JGC.config, TGC.config):
        cfg.clear()
        cfg._used.clear()
    yield
    for cfg in (JGC.config, TGC.config):
        cfg.clear()
        cfg._used.clear()


def test_build_environments_channels_match_jax():
    bundles = []
    for cfg, factory, dev in ((JGC.config, JF, {}),
                              (TGC.config, TF, {"device": "cpu"})):
        cfg.update({"env_type": "append-still", "seed": 11,
                    "env.packed_obs": False})
        bundles.append(factory.build_environments(
            cfg, num_envs=LANES, pool_size=LANES, procgen_workers=0, **dev))
    j, t = bundles
    assert not t.packed_obs and not j.packed_obs
    assert tuple(t.env_cfg.output_channels) == \
        tuple(j.env_cfg.output_channels) == CHANNELS
    assert JGC.config.check_for_unused() == TGC.config.check_for_unused()
    # Without auto-reset the lanes stay on their levels, whose reset draws
    # differ between the packages.
    jcfg = dataclasses.replace(j.env_cfg, auto_reset=False)
    tcfg = dataclasses.replace(t.env_cfg, auto_reset=False)
    jpool, tpool = j.pool_manager.pool, t.pool_manager.pool
    js, jobs = JE.reset(jcfg, jpool, jax.random.PRNGKey(0), LANES)
    ts, tobs = TE.reset(tcfg, tpool, LANES)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(3)
    for step in range(21):
        assert tobs.dtype == torch.uint8
        assert tuple(tobs.shape) == (LANES, 1, 25, 25, len(CHANNELS))
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs),
                                      err_msg="step %d" % step)
        acts = rng.integers(0, 9, (LANES, 1)).astype(np.int32)
        js, jobs, _, _, _ = JE.step(jcfg, jpool, js, jnp.asarray(acts),
                                    jax.random.PRNGKey(step))
        ts, tobs, _, _, _ = TE.step(tcfg, tpool, ts, torch.from_numpy(acts),
                                    gen)
    t.pool_manager.close()


def _modes():
    """(env config, network) of each observation mode, the networks on
    the same parameters."""
    torch.manual_seed(5)
    packed = TN.SafeLifePolicyNetwork(unpack_channels=CHANNELS,
                                      device="cpu")
    chans = TN.SafeLifePolicyNetwork(num_channels=len(CHANNELS),
                                     device="cpu")
    chans.load_state_dict(packed.state_dict())
    return {"packed": (TE.EnvConfig(view_shape=(25, 25),
                                    output_channels=None, time_limit=20),
                       packed),
            "channels": (TE.EnvConfig(view_shape=(25, 25),
                                      output_channels=CHANNELS,
                                      time_limit=20), chans)}


def _pool():
    return pack_levels(TL.load_levels("benchmarks/v1.0/append-still.npz")[:4],
                       device="cpu")


def test_ppo_iteration_loss_equal_in_both_modes():
    pool, wcfg = _pool(), TW.WrapperConfig()
    cfg = TP.PPOConfig(steps_per_env=4)
    out = {}
    for mode, (env_cfg, net) in _modes().items():
        ps = TP.init_ppo_state(cfg, net, device="cpu")
        gen = torch.Generator().manual_seed(3)
        ws, obs = TW.reset(env_cfg, wcfg, pool, LANES, device="cpu")
        traj, _, _ = TP.rollout(env_cfg, wcfg, pool, net, ws, obs, gen, 4)
        ws, obs = TW.reset(env_cfg, wcfg, pool, LANES, device="cpu")
        gen = torch.Generator().manual_seed(3)
        ps, ws, obs, metrics = TP.train_iteration(
            env_cfg, wcfg, cfg, pool, ps, ws, obs, gen, device="cpu")
        out[mode] = (traj["obs"], metrics, net.state_dict())
    (pobs, pm, pp), (cobs, cm, cp) = out["packed"], out["channels"]
    assert cobs.dtype == torch.uint8 and pobs.dtype == torch.int32
    assert tuple(cobs.shape) == (4, LANES, 25, 25, len(CHANNELS))
    assert torch.equal(TN.unpack_obs(pobs, CHANNELS).to(torch.uint8), cobs)
    for k in ("loss", "policy_loss", "value_loss", "entropy"):
        assert torch.equal(pm[k], cm[k]), k
    for k in pp:
        assert torch.equal(pp[k], cp[k]), k


def test_dqn_replay_stores_channels():
    """build_model's channels form with DQN's uint8 replay: the same
    entries as the packed mode's, unpacked, and the same loss."""
    pool, wcfg = _pool(), TW.WrapperConfig()
    cfg = TD.DQNConfig(replay_size=64, replay_initial=8, batch_size=6)
    actions = torch.from_numpy(np.random.default_rng(4).integers(
        0, 9, (6, LANES, 1)))
    sample_idx = np.arange(6)
    out = {}
    for packed in (True, False):
        TGC.config.clear()
        TGC.config._used.clear()
        env_cfg = TE.EnvConfig(view_shape=(25, 25), time_limit=20,
                               output_channels=None if packed else CHANNELS)
        bundle = TF.EnvBundle(env_cfg, wcfg, None, None, None, None, [], [],
                              {}, obs_channels=CHANNELS)
        torch.manual_seed(9)
        net, shape, dtype = TT.build_model(bundle, "dqn", device="cpu")
        ds = TD.init_dqn_state(cfg, net, LANES, shape, dtype, device="cpu")
        ws, obs = TW.reset(env_cfg, wcfg, pool, LANES, device="cpu")
        ds, ws, obs, metrics = TD.collect_and_optimize(
            env_cfg, wcfg, cfg, pool, ds, ws, obs, None, 6, actions=actions,
            sample_idx=sample_idx, device="cpu")
        out[packed] = (ds.replay, metrics["loss"])
    (prep, ploss), (crep, closs) = out[True], out[False]
    assert crep.obs.dtype == crep.next_obs.dtype == torch.uint8
    assert tuple(crep.obs.shape[1:]) == (25, 25, len(CHANNELS))
    assert prep.idx == crep.idx > 0
    for k in ("obs", "next_obs"):
        got = getattr(crep, k)
        ref = TN.unpack_obs(getattr(prep, k), CHANNELS).to(torch.uint8)
        assert torch.equal(got, ref), k
    assert torch.equal(ploss, closs)
