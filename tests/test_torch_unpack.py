"""K4 (``ops/unpack.py``): packed views -> the trunk's float32 planes.

On the CPU its plain version, and the policy and Q networks that take
packed views through it, are held bit for bit to the chain they replace:
``unpack_obs(views, channels).permute(0, 3, 2, 1).contiguous()`` and the
trunk fed that chain. On the card (tests marked ``card``; they skip
without one) the kernel is held to the plain version, and a network's
forward to the old chain, bit for bit. The file imports torch and the
port only, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_unpack.py
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safelife_tpu_torch import ops  # noqa: E402
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.ops import unpack as U  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEW = (25, 25)


def _config_channels():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "ppo-prune-spawn.json")) as f:
        return tuple(json.load(f)["policy"]["channels"])


#: The training channels, the benchmark configuration's 15, the top byte
#: with bit 0, and every bit.
CHANNEL_SETS = {
    "training": TN.TRAINING_CHANNELS,
    "config": _config_channels(),
    "high": (0, 24, 25, 26, 27, 28, 29, 30, 31),
    "all": tuple(range(32)),
}


def _views(n, view=VIEW, seed=0):
    """Random int32 words over all 32 bits: negative words included."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2 ** 31, 2 ** 31, (n,) + tuple(view),
                         dtype=np.int64)
    return torch.from_numpy(words.astype(np.int32))


def _old_chain(views, channels):
    return TN.unpack_obs(views, channels).permute(0, 3, 2, 1).contiguous()


def _old_forward(net, obs):
    """The network's forward as it was before K4: ``unpack_obs``, the
    trunk's input a permuted view of it, which cuDNN copies."""
    net.unpack = lambda o: TN.unpack_obs(
        o, net.unpack_channels).permute(0, 3, 2, 1)
    try:
        return _outputs(net(obs))
    finally:
        del net.unpack


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _assert_equal_bits(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.is_contiguous()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("n", [1, 25, 37])
@pytest.mark.parametrize("channels", list(CHANNEL_SETS))
def test_plain_equals_old_chain(n, channels):
    ch = CHANNEL_SETS[channels]
    views = _views(n, seed=n)
    ref = _old_chain(views, ch)
    assert ref.shape == (n, len(ch), VIEW[1], VIEW[0])
    for got in (U.unpack_planes_plain(views, ch),
                ops.unpack_planes(views, ch)):
        _assert_equal_bits(got, ref)
    assert set(torch.unique(ref).tolist()) == {0.0, 1.0}


def test_planes_swap_the_view_axes():
    """out[n, c, j, i] is bit channels[c] of views[n, i, j], on a view that
    is not square."""
    views = _views(3, view=(5, 7), seed=4)
    ch = (0, 17, 31)
    out = ops.unpack_planes(views, ch)
    assert out.shape == (3, 3, 7, 5)
    for c, bit in enumerate(ch):
        want = ((views >> bit) & 1).to(torch.float32).transpose(1, 2)
        assert torch.equal(out[:, c], want)


@pytest.mark.parametrize("cls", [TN.SafeLifePolicyNetwork,
                                 TN.SafeLifeQNetwork])
def test_networks_on_packed_views_equal_old_chain(cls):
    torch.manual_seed(5)
    net = cls(view_shape=VIEW, unpack_channels=TN.TRAINING_CHANNELS,
              device="cpu")
    obs = _views(9, seed=6)
    results = []
    for fn in (net, lambda o: _old_forward(net, o)):
        net.zero_grad(set_to_none=True)
        out = _outputs(fn(obs))
        sum(o.pow(2).sum() for o in out).backward()
        results.append(([o.detach() for o in out],
                        [p.grad.clone() for p in net.parameters()]))
    (out, grads), (ref_out, ref_grads) = results
    for got, ref in zip(out + grads, ref_out + ref_grads):
        _assert_equal_bits(got.contiguous(), ref.contiguous())


def test_network_input_layouts():
    """Packed views reach the trunk as contiguous planes; NHWC channels as
    the same planes, swapped as a strided view."""
    net = TN.SafeLifePolicyNetwork(view_shape=VIEW,
                                   unpack_channels=TN.TRAINING_CHANNELS,
                                   device="cpu")
    views = _views(4, seed=7)
    planes = net.unpack(views)
    assert planes.is_contiguous() and planes.dtype == torch.float32
    channels = TN.unpack_obs(views, TN.TRAINING_CHANNELS).to(torch.uint8)
    nhwc = TN.SafeLifePolicyNetwork(
        view_shape=VIEW, num_channels=len(TN.TRAINING_CHANNELS),
        device="cpu").unpack(channels)
    assert not nhwc.is_contiguous()
    assert torch.equal(nhwc, planes)


@pytest.mark.parametrize("views,channels,match", [
    (torch.zeros((2,) + VIEW, dtype=torch.int64), (0,), "int32"),
    (torch.zeros((2,) + VIEW, dtype=torch.float32), (0,), "int32"),
    (torch.zeros((2, 1) + VIEW, dtype=torch.int32), (0,), "int32"),
    (torch.zeros((2,) + VIEW, dtype=torch.int32).transpose(1, 2), (0,),
     "not contiguous"),
    (torch.zeros((2,) + VIEW, dtype=torch.int32, device="meta"), (0,),
     "unsupported device"),
    (torch.zeros((2,) + VIEW, dtype=torch.int32), (), "channels"),
    (torch.zeros((2,) + VIEW, dtype=torch.int32), (32,), "channels"),
    (torch.zeros((2,) + VIEW, dtype=torch.int32), (-1,), "channels"),
    (torch.zeros((2,) + VIEW, dtype=torch.int32), tuple(range(33)),
     "channels"),
], ids=["int64", "float32", "rank4", "strided", "meta", "none", "bit32",
        "negative", "33"])
def test_wrapper_raises(views, channels, match):
    with pytest.raises(ValueError, match=match):
        ops.unpack_planes(views, channels)


@pytest.mark.parametrize("view", [VIEW, (7, 9), (240, 240)])
def test_launch_fits(view):
    """A block takes one sample: whole warps, a thread for each shift,
    and the sample's words within the card's shared memory."""
    assert U.THREADS % 32 == 0 and U.MAX_CHANNELS <= U.THREADS <= 1024
    assert U.unpack_smem_bytes(*view) <= U.MAX_SMEM_BYTES
    assert U.unpack_smem_bytes(241, 241) > U.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 25, 4097, 16384])
@pytest.mark.parametrize("channels", ["training", "high", "all"])
def test_kernel_equals_plain_on_card(card, n, channels):
    ch = CHANNEL_SETS[channels]
    views = _views(n, seed=n).to(card)
    before = ops.launch_counts()["unpack_planes"]
    got = ops.unpack_planes(views, ch)
    assert ops.launch_counts()["unpack_planes"] == before + 1
    ref = U.unpack_planes_plain(views, ch)
    torch.cuda.synchronize()
    _assert_equal_bits(got, ref)


@pytest.mark.card
@pytest.mark.parametrize("cls", [TN.SafeLifePolicyNetwork,
                                 TN.SafeLifeQNetwork])
def test_network_forward_on_card_equals_old_chain(card, cls):
    """One K4 launch a forward, and the outputs of 16,384 samples (the
    rollout's width, under cuDNN's search) bit for bit the old chain's."""
    torch.manual_seed(0)
    net = cls(view_shape=VIEW, unpack_channels=TN.TRAINING_CHANNELS,
              device=card)
    obs = _views(16384, seed=8).to(card)
    with torch.no_grad():
        ref = _old_forward(net, obs)
        before = ops.launch_counts()["unpack_planes"]
        got = _outputs(net(obs))
        assert ops.launch_counts()["unpack_planes"] == before + 1
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        _assert_equal_bits(g.contiguous(), r.contiguous())
