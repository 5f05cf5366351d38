"""The port's policy network against the JAX package's, with the JAX
parameters converted by ``policy_params_from_flax``: values and
probabilities within atol = rtol = 1e-5 (float32 sums taken in another
order)."""

import contextlib
import warnings

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
from safelife_tpu_torch.parallel import mesh as TM  # noqa: E402
from safelife_tpu_torch.training import ppo as TP  # noqa: E402

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


def _cudnn_flags():
    c = torch.backends.cudnn
    return (c.enabled, c.benchmark, c.benchmark_limit, c.deterministic,
            c.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("name", list(TN.PRECISIONS))
def test_learner_precision_searches_and_keeps_each_modes_tf32(name):
    """Every mode runs cuDNN's measured search at a fixed width from
    ``SEARCH_MIN_WIDTH`` on, under cuDNN's default limit of candidates;
    TF32 stays on only under "tensorfloat32", and autocast only under
    "bfloat16"."""
    mode = TN.PRECISIONS[name]
    limit = torch.backends.cudnn.benchmark_limit
    with TN.learner_precision(name, "cpu", TN.SEARCH_MIN_WIDTH):
        tf32 = mode == "tensorfloat32"
        assert _cudnn_flags() == (True, True, limit, False, tf32, tf32)
        assert torch.is_autocast_enabled("cpu") == (mode == "bfloat16")


@pytest.mark.parametrize("outer,width,search", [
    (None, None, False),
    (None, "min", True),
    (None, "below", False),
    ("min", "min", True),
    (None, 10 ** 6, True),
    ("none", "min", False),
    ("below", 10 ** 6, False),
])
def test_learner_precision_searches_only_at_fixed_widths(outer, width,
                                                         search):
    """The search runs at a known width of ``SEARCH_MIN_WIDTH`` or more,
    and not inside a context that does not search (``outer``: None for no
    enclosing context, "none" for one of no fixed width)."""
    widths = {"min": TN.SEARCH_MIN_WIDTH, "below": TN.SEARCH_MIN_WIDTH - 1,
              "none": None}

    def ctx(w):
        return TN.learner_precision("float32", "cpu", widths.get(w, w))

    before = _cudnn_flags()
    with ctx(outer) if outer is not None else contextlib.nullcontext():
        enclosing = torch.backends.cudnn.benchmark
        with ctx(width):
            assert torch.backends.cudnn.benchmark == search
        assert torch.backends.cudnn.benchmark == enclosing
    assert _cudnn_flags() == before


@pytest.mark.parametrize("mode", ["float32", "tensorfloat32", "bfloat16"])
def test_learner_step_restores_every_cudnn_flag(mode, monkeypatch):
    """A forward, ``backward()`` and Adam step under the learner's context
    see the search on in every layer and the step; afterwards each cuDNN
    flag (and cuBLAS's TF32) is back to what it was, whatever it was."""
    monkeypatch.setattr(TN, "SEARCH_MIN_WIDTH", 4)
    net = TN.SafeLifePolicyNetwork(view_shape=(25, 25), num_channels=2,
                                   device="cpu", precision=mode)
    opt = torch.optim.Adam(net.parameters())
    seen = []
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.register_forward_pre_hook(
                lambda *_: seen.append(torch.backends.cudnn.benchmark))
            m.register_full_backward_pre_hook(
                lambda *_: seen.append(torch.backends.cudnn.benchmark))
    opt.register_step_pre_hook(
        lambda *_: seen.append(torch.backends.cudnn.benchmark))
    prev_matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.backends.cudnn.flags(enabled=False, benchmark=False,
                                        benchmark_limit=3,
                                        deterministic=True, allow_tf32=True):
            before = _cudnn_flags()
            with TN.learner_precision(net.precision, "cpu", 4), \
                    warnings.catch_warnings():
                # conv0's input needs no gradient: its hook fires on outputs.
                warnings.filterwarnings("ignore", message="Full backward hook")
                value, policy = net(torch.rand((4, 25, 25, 2)))
                (value.sum() + policy[:, 0].sum()).backward()
                opt.step()
            assert _cudnn_flags() == before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_matmul
    # 6 layers forward and backward, the step.
    assert all(seen) and len(seen) == 6 + 6 + 1


def test_conv_searches_count_new_trunk_keys(monkeypatch):
    """One count per (device, input shape, mode, grad mode) the process has
    not run the trunk at under the search: a second network at a key
    already seen adds none, as cuDNN's cache of its picks is the
    process's, and a call too narrow to search adds none."""
    monkeypatch.setattr(TN, "SEARCH_MIN_WIDTH", 2)

    def net():
        return TN.SafeLifePolicyNetwork(view_shape=(17, 19), num_channels=3,
                                        device="cpu")

    def obs(n):
        return torch.zeros((n, 17, 19, 3))

    a = net()
    start = TN.conv_searches()
    with torch.no_grad():
        a(obs(2))
        a(obs(2))
        a(obs(5))
        a(obs(1))
    assert TN.conv_searches() - start == 2
    a(obs(2))
    assert TN.conv_searches() - start == 3
    with torch.no_grad():
        net()(obs(2))
    assert TN.conv_searches() - start == 3


def _ppo_batch(n, g):
    return {"obs": torch.rand((n, 17, 19, 3), generator=g),
            "actions": torch.randint(0, 9, (n,), generator=g),
            "action_prob": torch.full((n,), 1 / 9),
            "values": torch.randn((n,), generator=g),
            "returns": torch.randn((n,), generator=g),
            "advantages": torch.randn((n,), generator=g),
            "weight": torch.ones(n)}


@pytest.mark.parametrize("sharded", [False, True])
def test_sharded_learner_keeps_the_heuristic_pick(sharded, monkeypatch):
    """A rank's share of each global minibatch changes width from one to
    the next: its learner runs no convolution under the search and counts
    none, where the whole batch's minibatches, all of one width, search.
    One process stands for the ranks (the sums over ranks are its own)."""
    monkeypatch.setattr(TN, "SEARCH_MIN_WIDTH", 1)
    monkeypatch.setattr(TM, "all_reduce_sum", lambda x: x.detach().clone())
    monkeypatch.setattr(TM, "allreduce_grads", lambda model: model)
    g = torch.Generator().manual_seed(3)
    net = TN.SafeLifePolicyNetwork(view_shape=(17, 19), num_channels=3,
                                   device="cpu")
    state = TP.init_ppo_state(TP.PPOConfig(), net, device="cpu")
    total = 96
    index = torch.arange(0, total, 2) if sharded else torch.arange(total)
    shard = TP.SampleShard(index, total) if sharded else None
    seen = []
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_pre_hook(
                lambda *_: seen.append(torch.backends.cudnn.benchmark))
    start = TN.conv_searches()
    TP.train_on_batch(TP.PPOConfig(), state, _ppo_batch(len(index), g), g,
                      shard=shard)
    assert seen and all(x == (not sharded) for x in seen)
    assert (TN.conv_searches() > start) == (not sharded)
