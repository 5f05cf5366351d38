"""The port's episode runner against ``run_episodes_impl`` of the JAX
package, on the CPU, with a peaked policy: a network whose final bias puts
probability ~1 on one action, so that both samplers pick the same action
whatever their random streams. Episode reward, length, success and final
board must agree exactly; on levels without spawners the side effects of a
benchmark within 1e-9, its logs and recorded episode equal, and the
training-time side-effect telemetry too."""

import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu import loggers as JLOG  # noqa: E402
from safelife_tpu.env import env as JE, state as JST  # noqa: E402
from safelife_tpu.io import levels as JL  # noqa: E402
from safelife_tpu.models import nets as JN  # noqa: E402
from safelife_tpu.training import env_factory as JF  # noqa: E402
from safelife_tpu.training import runner as JR, train as JT  # noqa: E402
from safelife_tpu_torch import loggers as TLOG  # noqa: E402
from safelife_tpu_torch.env import env as TE, state as TST  # noqa: E402
from safelife_tpu_torch.env import wrappers as TW  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.models.convert import (  # noqa: E402
    policy_params_from_flax)
from safelife_tpu_torch.training import env_factory as TF  # noqa: E402
from safelife_tpu_torch.training import ppo as TP  # noqa: E402
from safelife_tpu_torch.training import runner as TR  # noqa: E402
from safelife_tpu_torch.training import train as TTR  # noqa: E402

ARCHIVE = "benchmarks/v1.0/prune-dynamic.npz"
VIEW = (25, 25)


def peaked_params(action, seed=0):
    """JAX policy parameters whose logits bias puts p ~ 1 on ``action``."""
    _, params = JN.init_policy_params(jax.random.PRNGKey(seed), VIEW,
                                      len(TN.TRAINING_CHANNELS))
    params = jax.tree.map(np.asarray, params)
    bias = np.zeros(9, np.float32)
    bias[action] = 60.0
    params["params"]["Dense_2"]["bias"] = bias
    return params


@pytest.mark.parametrize("action", [1, 6])
def test_run_episodes_matches_jax(action):
    params = peaked_params(action)
    b, max_steps = 8, 40
    kw = dict(view_shape=VIEW, output_channels=None, time_limit=30)
    jpool = JST.pack_levels(JL.load_levels(ARCHIVE)[:8])
    tpool = TST.pack_levels(TL.load_levels(ARCHIVE)[:8], device="cpu")
    idx = np.array([0, 1, 2, 3, 4, 5, 6, 7])

    jmodel = JN.SafeLifePolicyNetwork(unpack_channels=TN.TRAINING_CHANNELS)
    jout = JR.run_episodes_jit(
        JE.EnvConfig(**kw), jpool, jmodel.apply, params,
        jnp.asarray(idx, jnp.int32), jax.random.PRNGKey(0), max_steps)

    net = TN.SafeLifePolicyNetwork(view_shape=VIEW,
                                   unpack_channels=TN.TRAINING_CHANNELS,
                                   device="cpu")
    net.load_state_dict(policy_params_from_flax(params))
    gen = torch.Generator().manual_seed(0)
    tout = TR.run_episodes(TE.EnvConfig(**kw), tpool, net.eval(),
                           torch.from_numpy(idx), gen, max_steps)
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    # Episodes ended inside the run (the time limit is below max_steps).
    assert (tout["final_steps"].numpy() <= 30).all()


def test_policy_sample_is_peaked():
    params = peaked_params(3)
    net = TN.SafeLifePolicyNetwork(view_shape=VIEW,
                                   unpack_channels=TN.TRAINING_CHANNELS,
                                   device="cpu")
    net.load_state_dict(policy_params_from_flax(params))
    obs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2 ** 28, (4, 2) + VIEW).astype(np.int32))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        acts = TR._policy_sample(net, obs, gen)
    assert acts.shape == (4, 2) and acts.dtype == torch.int32
    assert (acts == 3).all()


def test_sampler_follows_probabilities():
    """Gumbel-max over log(p) draws each action with its probability."""
    class Fixed(torch.nn.Module):
        def forward(self, obs):
            p = torch.tensor([0.5, 0.3, 0.2] + [0.0] * 6)
            return torch.zeros(obs.shape[0]), p.expand(obs.shape[0], 9)

    gen = torch.Generator().manual_seed(2)
    acts = TR._policy_sample(Fixed(), torch.zeros((20000, 1, 1)), gen)
    freq = np.bincount(acts.numpy().ravel(), minlength=9) / 20000
    np.testing.assert_allclose(freq[:3], [0.5, 0.3, 0.2], atol=0.015)
    assert freq[3:].sum() == 0


def test_benchmark_summary():
    levels = TL.load_levels(ARCHIVE)[:3]
    net = TN.SafeLifePolicyNetwork(view_shape=VIEW,
                                   unpack_channels=TN.TRAINING_CHANNELS,
                                   device="cpu")
    cfg = TE.EnvConfig(view_shape=VIEW, output_channels=None, time_limit=10)
    gen = torch.Generator().manual_seed(0)
    records, summary = TR.benchmark(net, levels, 4, env_cfg=cfg,
                                    generator=gen, calc_side_effects=False,
                                    device="cpu")
    assert len(records) == 4 and summary["episodes"] == 4
    assert records[3]["level_name"] == levels[0].name
    assert all(r["length"] <= 10 for r in records)
    assert all("side_effects" not in r for r in records)
    assert np.isfinite(summary["score"]) and summary["side_effects"] == 0.0
    meta = TR.level_metadata(levels, TST.pack_levels(levels,
                                                     device="cpu"))
    jmeta = JR.level_metadata(JL.load_levels(ARCHIVE)[:3])
    assert meta == jmeta
    # Side effects are scored by default.
    records, summary = TR.benchmark(net, levels, 2, env_cfg=cfg,
                                    num_samples=5, device="cpu")
    assert all("life-green" in r["side_effects"] for r in records)
    assert summary == TR.summarize_records(records)
    assert summary == JR.summarize_records(records)


SE_WEIGHTS = {"life-green": 1.0, "spawner-yellow": 2.0}


def _jax_and_port_policies(action):
    params = peaked_params(action)
    net = TN.SafeLifePolicyNetwork(view_shape=VIEW,
                                   unpack_channels=TN.TRAINING_CHANNELS,
                                   device="cpu")
    net.load_state_dict(policy_params_from_flax(params))
    return params, net.eval()


@pytest.mark.parametrize("action", [2, 4])
def test_benchmark_with_side_effects_matches_jax(action, tmp_path):
    """The slice as a whole: 8 prune-dynamic episodes in two batches of 4,
    the peaked policy, side effects weighted, records logged and one video
    episode recorded. Records (side effects included), the summary, the
    logs and the run's summary within 1e-9 of JAX's; the saved history
    equal."""
    params, net = _jax_and_port_policies(action)
    kw = dict(view_shape=VIEW, output_channels=None, time_limit=30)
    common = dict(num_samples=50, side_effect_weights=SE_WEIGHTS, lanes=4,
                  record_videos=True)
    jlog = JLOG.SafeLifeLogger(str(tmp_path / "jax"),
                               episode_type="benchmark",
                               summary_writer=False)
    jmodel = JN.SafeLifePolicyNetwork(unpack_channels=TN.TRAINING_CHANNELS)
    jrec, jsum = JR.benchmark(
        jmodel.apply, params, JL.load_levels(ARCHIVE)[:8], 8,
        env_cfg=JE.EnvConfig(**kw), key=jax.random.PRNGKey(0),
        data_logger=jlog, **common)
    tlog = TLOG.SafeLifeLogger(str(tmp_path / "port"),
                               episode_type="benchmark",
                               summary_writer=False)
    trec, tsum = TR.benchmark(
        net, TL.load_levels(ARCHIVE)[:8], 8, env_cfg=TE.EnvConfig(**kw),
        generator=torch.Generator().manual_seed(0), data_logger=tlog,
        device="cpu", **common)

    def close(got, ref, what):
        if isinstance(ref, dict):
            assert set(got) == set(ref), what
            for k in ref:
                close(got[k], ref[k], "%s.%s" % (what, k))
        elif isinstance(ref, list) and isinstance(ref[0], dict):
            assert len(got) == len(ref), what
            for i, (g, r) in enumerate(zip(got, ref)):
                close(g, r, "%s[%d]" % (what, i))
        elif isinstance(ref, (float, list)):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9,
                                       err_msg=what)
        else:
            assert got == ref, what

    assert len(trec) == len(jrec) == 8
    for i, (t, j) in enumerate(zip(trec, jrec)):
        close(t, j, "record %d" % i)
    close(tsum, jsum, "summary")
    assert sum(r["side_effects"]["total"][0] > 0 for r in trec) >= 1

    logs = []
    for d in ("jax", "port"):
        with open(tmp_path / d / "benchmark-data.json") as f:
            logs.append([{k: v for k, v in e.items() if k != "time"}
                         for e in json.load(f)])
    assert len(logs[1]) == 9  # 8 episodes and the video's
    close(logs[1], logs[0], "log")
    video = "benchmark-%s-video.npz" % trec[0]["level_name"]
    with np.load(tmp_path / "jax" / video) as j, \
            np.load(tmp_path / "port" / video) as t:
        for k in ("board", "goals"):
            assert t[k].dtype == np.uint16
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # Either package summarises one log alike; the two logs' summaries
    # agree as their side-effect scores do (the port's exact EMD is a
    # network simplex, the JAX package's an LP: equal to rounding).
    port_run = TLOG.summarize_run(str(tmp_path / "port"))
    assert port_run == JLOG.summarize_run(str(tmp_path / "port"))
    close(port_run, JLOG.summarize_run(str(tmp_path / "jax")), "run")


def _train_chunk_samples(exhaustive):
    """Episode samples of a port train_chunk on append-still (no
    spawners; lanes time out every 6 steps)."""
    levels = TL.load_levels("benchmarks/v1.0/append-still.npz")[:3]
    pool = TST.pack_levels(levels, device="cpu")
    cfg = TE.EnvConfig(view_shape=(17, 17), output_channels=None,
                       time_limit=6)
    wcfg = TW.WrapperConfig(exhaustive_se=exhaustive)
    net = TN.SafeLifePolicyNetwork(view_shape=(17, 17),
                                   unpack_channels=TN.TRAINING_CHANNELS,
                                   device="cpu")
    ps = TP.init_ppo_state(TP.PPOConfig(steps_per_env=4), net, device="cpu")
    ws, obs = TW.reset(cfg, wcfg, pool, 3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    _, _, _, m = TP.train_chunk(cfg, wcfg, TP.PPOConfig(steps_per_env=4),
                                pool, ps, ws, obs, gen, 2, device="cpu")
    return cfg, m["ep_samples"]


def test_training_side_effect_telemetry_matches_jax():
    """``_sampled_side_effects`` and ``_exhaustive_side_effects`` (and its
    summary) on a port ``train_chunk``'s samples equal JAX's."""
    bundle = types.SimpleNamespace(side_effect_weights=SE_WEIGHTS)
    cfg, samples = _train_chunk_samples(exhaustive=False)
    assert samples["found"].any() and not samples["found"].all()
    got = TTR._sampled_side_effects(samples, bundle,
                                   torch.Generator().manual_seed(0))
    ref = JT._sampled_side_effects({k: v.numpy() for k, v in samples.items()},
                                   bundle, jax.random.PRNGKey(0))
    assert set(got) == set(ref) and "side_effects_sampled" in got
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-9, k
    none = dict(samples, found=torch.zeros_like(samples["found"]))
    assert TTR._sampled_side_effects(none, bundle, None) is None

    cfg, samples = _train_chunk_samples(exhaustive=True)
    flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
            for k, v in samples.items()}
    got = TTR._exhaustive_side_effects(flat, bundle, cfg,
                                      torch.Generator().manual_seed(0))
    ref = JT._exhaustive_side_effects({k: v.numpy() for k, v in flat.items()},
                                      bundle, JE.EnvConfig(time_limit=6),
                                      jax.random.PRNGKey(0))
    assert set(got) == set(ref) and len(got) == int(flat["found"].sum()) > 1
    for lane in ref:
        assert set(got[lane]) == set(ref[lane])
        for k in ref[lane]:
            np.testing.assert_allclose(got[lane][k], ref[lane][k], rtol=0,
                                       atol=1e-9)
    assert TTR._summarize_se_map(got) == JT._summarize_se_map(ref)
    assert TTR._summarize_se_map({}) is None


def test_run_benchmark_and_validation_log_their_runs(tmp_path):
    """``run_benchmark`` writes ``benchmark-data.json`` whose summary
    (either package's ``summarize_run``) is the one returned;
    ``run_validation`` logs its episodes and one recorded episode. The
    bundle's constants and schedule are the JAX package's."""
    params, net = _jax_and_port_policies(4)
    levels = TL.load_levels(ARCHIVE)
    tlog = TLOG.SafeLifeLogger(None, episode_type="training")
    bundle = TF.EnvBundle(
        env_cfg=TE.EnvConfig(view_shape=VIEW, output_channels=None,
                             time_limit=12),
        wrapper_cfg=TW.WrapperConfig(), pool_manager=None,
        training_logger=tlog,
        se_penalty_schedule=TF.LinearSchedule(tlog, [1e6, 2e6], [0, 1.0]),
        exit_difficulty_schedule=None, validation_levels=levels[10:11],
        benchmark_levels=levels[:2],
        side_effect_weights=dict(TF.SIDE_EFFECT_WEIGHTS),
        obs_channels=TF.TRAINING_CHANNELS)
    assert bundle.packed_obs
    assert TF.SIDE_EFFECT_WEIGHTS == JF.SIDE_EFFECT_WEIGHTS
    assert TF.TRAINING_CHANNELS == JF.TRAINING_CHANNELS
    jsched = JF.LinearSchedule(tlog, [1e6, 2e6], [0, 1.0])
    for steps in (0, 1.5e6, 3e6):
        tlog.cumulative_stats["training_steps"] = steps
        assert bundle.se_penalty_schedule() == jsched()
    tlog.cumulative_stats["training_steps"] = 0

    d = str(tmp_path)
    summary = TTR.run_benchmark(net, bundle, d,
                                torch.Generator().manual_seed(1),
                                num_episodes=3, device="cpu")
    path = os.path.join(d, "benchmark-data.json")
    for read in (TLOG.summarize_run(d)["benchmark-data.json"],
                 JLOG.summarize_run_file(path)):
        assert set(read) <= set(summary)
        for k in read:
            assert abs(read[k] - summary[k]) <= 1e-9, k
    vsum = TTR.run_validation(net, bundle, d,
                              torch.Generator().manual_seed(2), device="cpu")
    assert vsum["episodes"] == 1
    with open(os.path.join(d, "validation-log.json")) as f:
        assert len(json.load(f)) == 2
    assert os.path.exists(os.path.join(
        d, "validation-s0-%s-video.npz" % levels[10].name))
