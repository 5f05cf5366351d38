"""The policy and Q networks, architecture parity with the reference
(``training/models.py:9-108``): a 3-conv VALID-padded CNN trunk
(5x5/s2 -> 32, 3x3/s2 -> 64, 3x3/s1 -> 64, ReLU) feeding a policy+value
head (dense 512) or dueling Q heads (dense 256 each).

Port of ``safelife_tpu/models/nets.py``: ``PRECISIONS`` (``:28-41``),
``unpack_obs`` (``:74-81``),
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
unchanged (:mod:`.convert`). The convolutions and dense layers are plain
``nn.Conv2d``/``nn.Linear``: the JAX package leaves them to XLA too.

Each network runs in its ``precision`` (:data:`PRECISIONS`, the JAX
package's names): strict float32 by default, TF32 for cuBLAS and cuDNN, or
bfloat16 autocast around the convolutions and dense layers, with the
outputs cast back to float32 before the softmax and the dueling sum. The
modes mean the same on the CPU, where TF32 does not exist and the flags
change nothing.
"""

import contextlib

import torch
from torch import nn

from ..core import cells as C
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


@contextlib.contextmanager
def learner_precision(precision, device_type="cuda"):
    """The network math of ``precision`` on ``device_type``: TF32 off for
    cuBLAS and cuDNN (which allows it for float32 convolutions by
    default), except under "tensorfloat32", which turns it on for both;
    "bfloat16" adds ``torch.autocast`` to bfloat16. The flags are
    process-wide and read when an operation runs, so a learner runs its
    loss forward, ``backward()`` and optimizer step inside this context."""
    mode = precision_mode(precision)
    tf32 = mode == "tensorfloat32"
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32), \
                torch.autocast(device_type, dtype=torch.bfloat16,
                               enabled=mode == "bfloat16"):
            yield
    finally:
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


def unpack_obs(obs, channels):
    """Packed int32 views [..., vh, vw] -> float32 [..., vh, vw, C]. The
    shift and mask run on the int32 word: bits above 24 do not survive a
    float32 cast."""
    shifts = torch.tensor(channels, dtype=torch.int32, device=obs.device)
    return ((obs[..., None] >> shifts) & 1).to(torch.float32)


def cnn_output_features(input_shape):
    """Feature count after the trunk for an (h, w, c) input."""
    h, w, _ = input_shape
    h = ((h - 4 + 1) // 2 - 2 + 1) // 2 - 2
    w = ((w - 4 + 1) // 2 - 2 + 1) // 2 - 2
    return 64 * h * w


class SafeLifeCNN(nn.Module):
    """Shared convolutional trunk. NHWC float input → [N, features]."""

    def __init__(self, num_channels, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.conv0 = nn.Conv2d(num_channels, 32, 5, stride=2, device=dev)
        self.conv1 = nn.Conv2d(32, 64, 3, stride=2, device=dev)
        self.conv2 = nn.Conv2d(64, 64, 3, stride=1, device=dev)

    def forward(self, x):
        # (h, w, c) -> (w, h, c) as in the JAX package, then NCHW.
        x = x.permute(0, 3, 2, 1)
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

    def trunk(self, obs):
        """Trunk features [N, features]; call inside
        :func:`learner_precision` of ``self.precision``."""
        return self.cnn(obs.to(torch.float32))

    def unpack(self, obs):
        if self.unpack_channels is not None:
            obs = unpack_obs(obs, self.unpack_channels)
        return obs


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
        obs = self.unpack(obs)
        with learner_precision(self.precision, obs.device.type):
            x = torch.relu(self.dense(self.trunk(obs)))
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
        obs = self.unpack(obs)
        with learner_precision(self.precision, obs.device.type):
            x = self.trunk(obs)
            adv = self.adv(torch.relu(self.adv_hidden(x)))
            val = self.value(torch.relu(self.value_hidden(x)))
        adv, val = adv.float(), val.float()
        return val + adv - adv.mean(-1, keepdim=True)
