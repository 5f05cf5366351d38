"""The port's episode runner against ``run_episodes_impl`` of the JAX
package, on the CPU, with a peaked policy: a network whose final bias puts
probability ~1 on one action, so that both samplers pick the same action
whatever their random streams. Episode reward, length, success and final
board must agree exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu.env import env as JE, state as JST  # noqa: E402
from safelife_tpu.io import levels as JL  # noqa: E402
from safelife_tpu.models import nets as JN  # noqa: E402
from safelife_tpu.training import runner as JR  # noqa: E402
from safelife_tpu_torch.env import env as TE, state as TST  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.models.convert import (  # noqa: E402
    policy_params_from_flax)
from safelife_tpu_torch.training import runner as TR  # noqa: E402

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
                                    generator=gen, device="cpu")
    assert len(records) == 4 and summary["episodes"] == 4
    assert records[3]["level_name"] == levels[0].name
    assert all(r["length"] <= 10 for r in records)
    assert np.isfinite(summary["score"])
    meta = TR.level_metadata(levels, TST.pack_levels(levels,
                                                     device="cpu"))
    jmeta = JR.level_metadata(JL.load_levels(ARCHIVE)[:3])
    assert meta == jmeta
    with pytest.raises(NotImplementedError):
        TR.benchmark(net, levels, 1, env_cfg=cfg, calc_side_effects=True,
                     device="cpu")
