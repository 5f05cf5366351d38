"""The port's policy network against the JAX package's, with the JAX
parameters converted by ``policy_params_from_flax``: values and
probabilities within atol = rtol = 1e-5 (float32 sums taken in another
order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu.models import nets as JN  # noqa: E402
from safelife_tpu.training.env_factory import (  # noqa: E402
    TRAINING_CHANNELS as JAX_CHANNELS)
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.models.convert import (  # noqa: E402
    policy_params_from_flax)

TOL = dict(atol=1e-5, rtol=1e-5)


def _params(seed, view, channels):
    _, params = JN.init_policy_params(jax.random.PRNGKey(seed), view,
                                      len(channels))
    return jax.tree.map(np.asarray, params)


def _torch_net(params, view, **kw):
    net = TN.SafeLifePolicyNetwork(view_shape=view, device="cpu", **kw)
    net.load_state_dict(policy_params_from_flax(params))
    return net.eval()


def test_training_channels_match():
    assert TN.TRAINING_CHANNELS == tuple(JAX_CHANNELS)


@pytest.mark.parametrize("view", [(25, 25), (17, 21)])
def test_packed_obs_matches_jax(view):
    channels = TN.TRAINING_CHANNELS
    params = _params(0, view, channels)
    rng = np.random.default_rng(1)
    # Packed words with bits up to 27, as the env emits them.
    obs = rng.integers(0, 2 ** 28, (6,) + view).astype(np.int32)
    jmodel = JN.SafeLifePolicyNetwork(unpack_channels=channels)
    jv, jp = jmodel.apply(params, jnp.asarray(obs))
    net = _torch_net(params, view, unpack_channels=channels)
    with torch.no_grad():
        tv, tp = net(torch.from_numpy(obs))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    assert tp.shape == (6, 9) and tv.shape == (6,)


def test_channel_obs_matches_jax():
    view, n_ch = (25, 25), 15
    params = _params(3, view, range(n_ch))
    rng = np.random.default_rng(4)
    obs = (rng.random((5,) + view + (n_ch,)) < 0.3).astype(np.float32)
    jv, jp = JN.SafeLifePolicyNetwork().apply(params, jnp.asarray(obs))
    net = _torch_net(params, view, num_channels=n_ch)
    with torch.no_grad():
        tv, tp = net(torch.from_numpy(obs))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_unpack_obs_keeps_high_bits():
    obs = np.array([[1 << 27 | 1 << 25 | 1]], np.int32)
    ref = np.asarray(JN.unpack_obs(jnp.asarray(obs), (0, 25, 26, 27)))
    got = TN.unpack_obs(torch.from_numpy(obs), (0, 25, 26, 27)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, 0], [1, 1, 0, 1])


def test_forward_restores_tf32_flags():
    net = TN.SafeLifePolicyNetwork(view_shape=(25, 25), num_channels=2,
                                   device="cpu")
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with torch.no_grad():
        net(torch.zeros((1, 25, 25, 2)))
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
