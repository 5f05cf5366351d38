"""``train.torch_init: false`` in the port (``models/nets.py::flax_init_``)
against the JAX package's flax init (``torch_init=False``) at the same
shapes, on the CPU. The random streams differ, so this is a distribution
test, layer by layer: zero biases, weights inside the truncation at two
scales, and each layer's standard deviation within 5% of JAX's on layers
of 4096 weights or more and within 15% on the smaller heads. The same seed
gives the same parameters twice."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from safelife_tpu.models import nets as JN  # noqa: E402
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.models.convert import (  # noqa: E402
    policy_params_from_flax, q_params_from_flax)

VIEW = (25, 25)
NETS = {
    "policy": (JN.SafeLifePolicyNetwork, TN.SafeLifePolicyNetwork,
               policy_params_from_flax),
    "q": (JN.SafeLifeQNetwork, TN.SafeLifeQNetwork, q_params_from_flax),
}
LARGE = 4096


def _jax_params(kind, seed=0):
    """JAX's flax-init parameters in the port's names and layout."""
    jcls, _, convert = NETS[kind]
    model = jcls(unpack_channels=TN.TRAINING_CHANNELS, torch_init=False)
    params = model.init(jax.random.PRNGKey(seed), np.zeros((1,) + VIEW,
                                                           np.int32))
    return {k: v.numpy() for k, v in
            convert(jax.tree.map(np.asarray, params)).items()}


def _port_params(kind, seed=0):
    _, tcls, _ = NETS[kind]
    net = tcls(view_shape=VIEW, unpack_channels=TN.TRAINING_CHANNELS,
               device="cpu")
    torch.manual_seed(seed)
    TN.flax_init_(net)
    return {k: v.detach().numpy().copy()
            for k, v in net.state_dict().items()}


@pytest.mark.parametrize("kind", sorted(NETS))
def test_flax_init_matches_jax_in_distribution(kind):
    ref, got = _jax_params(kind), _port_params(kind)
    assert sorted(ref) == sorted(got)
    for name in sorted(got):
        w, jw = got[name], ref[name]
        assert w.shape == jw.shape, name
        if name.endswith("bias"):
            assert not w.any() and not jw.any(), name
            continue
        fan_in = w[0].size
        scale = fan_in ** -0.5 / 0.87962566103423978
        assert np.abs(w).max() <= 2 * scale * (1 + 1e-6), name
        assert np.abs(jw).max() <= 2 * scale * (1 + 1e-6), name
        tol = 0.05 if w.size >= LARGE else 0.15
        assert w.std() == pytest.approx(jw.std(), rel=tol), name
        assert abs(w.mean()) < 4 * jw.std() / np.sqrt(w.size), name


@pytest.mark.parametrize("kind", sorted(NETS))
def test_flax_init_seeded(kind):
    """The same seed gives equal parameters; another seed other ones;
    every weight is drawn anew, so none keeps torch's own init."""
    a, b, c = (_port_params(kind, s) for s in (5, 5, 6))
    _, tcls, _ = NETS[kind]
    torch.manual_seed(5)
    torch_own = {k: v.detach().numpy() for k, v in tcls(
        view_shape=VIEW, unpack_channels=TN.TRAINING_CHANNELS,
        device="cpu").state_dict().items()}
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        if not name.endswith("bias"):
            assert not np.array_equal(a[name], c[name]), name
            assert not np.array_equal(a[name], torch_own[name]), name
