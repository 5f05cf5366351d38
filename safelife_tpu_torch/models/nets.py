"""The policy and Q networks, architecture parity with the reference
(``training/models.py:9-108``): a 3-conv VALID-padded CNN trunk
(5x5/s2 -> 32, 3x3/s2 -> 64, 3x3/s1 -> 64, ReLU) feeding a policy+value
head (dense 512) or dueling Q heads (dense 256 each).

Port of ``safelife_tpu/models/nets.py``: ``PRECISIONS`` (``:28-41``),
``unpack_obs`` (``:74-81``, in :mod:`..ops.unpack` beside K4's plain
version, which calls it),
``SafeLifeCNN`` (``:84-101``), ``cnn_output_features`` (``:104-113``),
``SafeLifePolicyNetwork`` (``:116-146``) and ``SafeLifeQNetwork``
(``:149-171``, two dense-256 dueling heads). The layers keep torch's own
init, the JAX package's default (``train.torch_init``, ``:44-71``);
:func:`flax_init_` gives them flax's instead.

Inputs keep the JAX package's layout: NHWC float observations
[N, vh, vw, C], or packed int32 views [N, vh, vw] when ``unpack_channels``
is set. As there (``nets.py:94``), the spatial axes are swapped before the
convolutions to match the reference's (c, w, h) geometry, and the feature
map is flattened in (h, w, c) order so that flax parameters load
unchanged (:mod:`.convert`). Packed views reach the trunk through K4
(:func:`..ops.unpack_planes`), which writes the swapped float32 planes,
channels first, in one pass; NHWC inputs are cast and their axes swapped
as a strided view, which cuDNN copies. The convolutions and dense layers
are plain ``nn.Conv2d``/``nn.Linear``: the JAX package leaves them to XLA
too.

Each network runs in its ``precision`` (:data:`PRECISIONS`, the JAX
package's names): strict float32 by default, TF32 for cuBLAS and cuDNN, or
bfloat16 autocast around the convolutions and dense layers, with the
outputs cast back to float32 before the softmax and the dueling sum. The
modes mean the same on the CPU, where TF32 does not exist and the flags
change nothing.

On CUDA a network call, forward, ``backward()`` and optimizer step, over
at least :data:`SEARCH_MIN_WIDTH` samples runs under cuDNN's measured
algorithm search (``cudnn.benchmark``): the first call at a convolution
shape times cuDNN's candidate algorithms for it and the process keeps the
fastest, so a 4,096-sample forward and a 16,384-sample weight gradient
each run their own pick. Narrower calls, and calls whose width changes
from one to the next (a rank's share of a sharded minibatch), keep
cuDNN's heuristic pick, as a search there costs more than it finds. Under
strict float32 the candidates are full-float32 engines only, so a pick
changes the order of the sums and nothing else. cuDNN keeps the first plan
the process runs at a shape, searched or not, so a convolution run outside
:func:`learner_precision` first would pin the heuristic's pick there.
:func:`conv_searches` counts the trunk calls that search at a new (device,
input shape, mode, grad mode).
"""

import contextlib

import torch
from torch import nn

from .. import ops
from ..core import cells as C
from ..ops.unpack import unpack_obs  # noqa: F401
from ..utils.device import resolve_device

#: The training observation channel set (parity: the JAX package's
#: ``training/env_factory.py:29-35``, reference ``env_factory.py:311-327``).
TRAINING_CHANNELS = (
    C.ALIVE_BIT, C.AGENT_BIT, C.PUSHABLE_BIT, C.DESTRUCTIBLE_BIT,
    C.FROZEN_BIT, C.SPAWNING_BIT, C.EXIT_BIT,
    C.COLOR_BIT + 0, C.COLOR_BIT + 1, C.COLOR_BIT + 2,
    C.COLOR_BIT + 16, C.COLOR_BIT + 17, C.COLOR_BIT + 18,
    C.ORIENTATION_BIT + 0, C.ORIENTATION_BIT + 1,
)

HIDDEN_WIDTH = 512
Q_HIDDEN_WIDTH = 256
NUM_ACTIONS = 9

#: The standard deviation of a unit normal truncated at +-2, by which
#: flax's ``lecun_normal`` divides its scale so that the truncated draw
#: keeps the variance 1 / fan_in (``jax.nn.initializers.variance_scaling``).
_TRUNCATED_NORMAL_STD = 0.87962566103423978


#: The JAX package's precision names (``safelife_tpu/models/nets.py:28-41``)
#: -> the port's learner mode. "float32" is the training default: the
#: reference trains in strict float32, and PPO's clipped-ratio loss rides on
#: small advantage signals.
PRECISIONS = {
    "float32": "float32",
    "highest": "float32",
    "tensorfloat32": "tensorfloat32",
    "high": "tensorfloat32",
    "bfloat16": "bfloat16",
    "default": "bfloat16",
}


def precision_mode(precision):
    """The mode of a precision name; an unknown name raises."""
    if precision not in PRECISIONS:
        raise ValueError("unknown precision %r (one of %s)"
                         % (precision, ", ".join(PRECISIONS)))
    return PRECISIONS[precision]


#: The narrowest call, in samples, that runs cuDNN's measured search (see
#: the module docstring). On an H100 (``chip_sweep.py convs``) the
#: search's forward picks ran 9-62% slower than the heuristic's at 25 to
#: 256 samples, and changed from one process to the next; from 512 samples
#: on, the forward and both gradients of the three convolutions ran 22-48%
#: faster.
SEARCH_MIN_WIDTH = 512

#: The (device type, input shape, mode, grad mode) of every trunk call so
#: far that ran under the search: a call at a new key is where cuDNN
#: searches (module docstring).
_TRUNK_KEYS = set()

#: Whether each enclosing :func:`learner_precision` searches, innermost
#: last: a context nested in one that does not search does not either.
_SEARCHING = []


def conv_searches():
    """Trunk calls under the search at a key the process had not seen (see
    :data:`_TRUNK_KEYS`): on CUDA, the calls whose convolutions cuDNN
    searched for, the backward of a call with grad enabled included."""
    return len(_TRUNK_KEYS)


@contextlib.contextmanager
def learner_precision(precision, device_type="cuda", width=None):
    """The network math of ``precision`` on ``device_type``: TF32 off for
    cuBLAS and cuDNN (which allows it for float32 convolutions by
    default), except under "tensorfloat32", which turns it on for both;
    "bfloat16" adds ``torch.autocast`` to bfloat16. ``width`` is the
    samples of the convolutions run inside, or None where it changes from
    call to call: at :data:`SEARCH_MIN_WIDTH` or more cuDNN picks each
    convolution's algorithm by its measured search, once a shape for the
    process, among the engines the mode allows, unless an enclosing
    context does not search; else by its heuristic. The flags are
    process-wide and read when an operation runs, so a learner runs its
    loss forward, ``backward()`` and optimizer step inside this context;
    every flag is restored on exit."""
    mode = precision_mode(precision)
    tf32 = mode == "tensorfloat32"
    search = (width is not None and width >= SEARCH_MIN_WIDTH
              and all(_SEARCHING))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    _SEARCHING.append(search)
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=search,
                                        allow_tf32=tf32), \
                torch.autocast(device_type, dtype=torch.bfloat16,
                               enabled=mode == "bfloat16"):
            yield
    finally:
        _SEARCHING.pop()
        torch.backends.cuda.matmul.allow_tf32 = prev


def flax_init_(net):
    """Re-draw every layer of ``net`` with flax's default init, what the
    JAX package's networks get under ``train.torch_init: false``
    (``safelife_tpu/models/nets.py:66-71``): ``lecun_normal`` weights, a
    normal of scale sqrt(1 / fan_in) / 0.8796 truncated at two of its
    scales, and zero biases. ``fan_in`` is kh * kw * in for a
    convolution (weights [out, in, kh, kw]) and ``in`` for a dense layer.
    The draws come from torch's default generator on the layers' device.
    Returns ``net``."""
    with torch.no_grad():
        for layer in net.modules():
            if isinstance(layer, (nn.Conv2d, nn.Linear)):
                fan_in = layer.weight[0].numel()
                std = fan_in ** -0.5 / _TRUNCATED_NORMAL_STD
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std,
                                      2 * std)
                nn.init.zeros_(layer.bias)
    return net


def cnn_output_features(input_shape):
    """Feature count after the trunk for an (h, w, c) input."""
    h, w, _ = input_shape
    h = ((h - 4 + 1) // 2 - 2 + 1) // 2 - 2
    w = ((w - 4 + 1) // 2 - 2 + 1) // 2 - 2
    return 64 * h * w


class SafeLifeCNN(nn.Module):
    """Shared convolutional trunk. float32 planes [N, C, vw, vh] (the
    input's spatial axes swapped, channels first) → [N, features]."""

    def __init__(self, num_channels, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.conv0 = nn.Conv2d(num_channels, 32, 5, stride=2, device=dev)
        self.conv1 = nn.Conv2d(32, 64, 3, stride=2, device=dev)
        self.conv2 = nn.Conv2d(64, 64, 3, stride=1, device=dev)

    def forward(self, x):
        x = torch.relu(self.conv0(x))
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        return x.permute(0, 2, 3, 1).flatten(1)  # flax's NHWC flatten


class _PackedViewNetwork(nn.Module):
    """The CNN trunk on observations that are NHWC floats or uint8
    channels or, with ``unpack_channels``, packed int32 views unpacked at
    the input; the layers run in ``precision``."""

    def __init__(self, view_shape, num_channels, unpack_channels, device,
                 precision):
        super().__init__()
        precision_mode(precision)
        self.precision = precision
        if unpack_channels is not None:
            unpack_channels = tuple(unpack_channels)
            num_channels = len(unpack_channels)
        if num_channels is None:
            raise ValueError("give num_channels or unpack_channels")
        self.unpack_channels = unpack_channels
        self.cnn = SafeLifeCNN(num_channels, device=device)
        self.features = cnn_output_features(
            tuple(view_shape) + (num_channels,))

    def trunk(self, x):
        """Trunk features [N, features] of :meth:`unpack`'s planes; call
        inside :func:`learner_precision` of ``self.precision``."""
        if torch.backends.cudnn.benchmark:
            _TRUNK_KEYS.add((x.device.type, tuple(x.shape),
                             PRECISIONS[self.precision],
                             torch.is_grad_enabled()))
        return self.cnn(x)

    def unpack(self, obs):
        """The trunk's input, float32 [N, C, vw, vh]: packed views through
        K4, contiguous; NHWC floats or uint8 channels cast, with their axes
        swapped (h, w, c) -> (c, w, h) as in the JAX package."""
        if self.unpack_channels is not None:
            return ops.unpack_planes(obs, self.unpack_channels)
        return obs.to(torch.float32).permute(0, 3, 2, 1)


class SafeLifePolicyNetwork(_PackedViewNetwork):
    """Actor-critic network: obs -> (value [N], policy probabilities [N, 9]),
    one hidden dense layer of 512 as the JAX package's defaults.

    Parity: reference ``SafeLifePolicyNetwork`` (models.py:79-108); returns
    softmax probabilities, as the reference's PPO loss is written in terms
    of probability ratios.
    """

    def __init__(self, view_shape=(25, 25), num_channels=None,
                 unpack_channels=None, device="cuda", precision="float32"):
        dev = resolve_device(device)
        super().__init__(view_shape, num_channels, unpack_channels, dev,
                         precision)
        self.dense = nn.Linear(self.features, HIDDEN_WIDTH, device=dev)
        self.value = nn.Linear(HIDDEN_WIDTH, 1, device=dev)
        self.logits = nn.Linear(HIDDEN_WIDTH, NUM_ACTIONS, device=dev)

    def forward(self, obs):
        x = self.unpack(obs)
        with learner_precision(self.precision, x.device.type, x.shape[0]):
            x = torch.relu(self.dense(self.trunk(x)))
            value = self.value(x)[..., 0]
            logits = self.logits(x)
        return value.float(), torch.softmax(logits.float(), dim=-1)


class SafeLifeQNetwork(_PackedViewNetwork):
    """Dueling Q network: obs -> Q-values [N, 9], each head one hidden
    dense layer of 256. Parity: reference ``SafeLifeQNetwork``
    (models.py:46-76), the mean advantage subtracted."""

    def __init__(self, view_shape=(25, 25), num_channels=None,
                 unpack_channels=None, device="cuda", precision="float32"):
        dev = resolve_device(device)
        super().__init__(view_shape, num_channels, unpack_channels, dev,
                         precision)
        self.adv_hidden = nn.Linear(self.features, Q_HIDDEN_WIDTH, device=dev)
        self.adv = nn.Linear(Q_HIDDEN_WIDTH, NUM_ACTIONS, device=dev)
        self.value_hidden = nn.Linear(self.features, Q_HIDDEN_WIDTH,
                                      device=dev)
        self.value = nn.Linear(Q_HIDDEN_WIDTH, 1, device=dev)

    def forward(self, obs):
        x = self.unpack(obs)
        with learner_precision(self.precision, x.device.type, x.shape[0]):
            x = self.trunk(x)
            adv = self.adv(torch.relu(self.adv_hidden(x)))
            val = self.value(torch.relu(self.value_hidden(x)))
        adv, val = adv.float(), val.float()
        return val + adv - adv.mean(-1, keepdim=True)
