"""The policy network, architecture parity with the reference
(``training/models.py:9-108``): a 3-conv VALID-padded CNN trunk
(5x5/s2 -> 32, 3x3/s2 -> 64, 3x3/s1 -> 64, ReLU) feeding a policy+value
head (dense 512).

Port of ``safelife_tpu/models/nets.py``: ``unpack_obs`` (``:74-81``),
``SafeLifeCNN`` (``:84-101``), ``cnn_output_features`` (``:104-113``) and
``SafeLifePolicyNetwork`` (``:116-146``). The Q network is not ported yet.

Inputs keep the JAX package's layout: NHWC float observations
[N, vh, vw, C], or packed int32 views [N, vh, vw] when ``unpack_channels``
is set. As there (``nets.py:94``), the spatial axes are swapped before the
convolutions to match the reference's (c, w, h) geometry, and the feature
map is flattened in (h, w, c) order so that flax parameters load
unchanged (:mod:`.convert`). The convolutions and dense layers are plain
``nn.Conv2d``/``nn.Linear``: the JAX package leaves them to XLA too.
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
NUM_ACTIONS = 9


@contextlib.contextmanager
def strict_float32():
    """Strict float32 for the network's products and convolutions, as the
    JAX package's "float32" training default: TF32 off for cuBLAS and for
    cuDNN (which allows it for float32 convolutions by default). Both flags
    are process-wide and read when an operation runs, so a learner runs its
    loss forward, ``backward()`` and optimizer step inside this context."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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


class SafeLifePolicyNetwork(nn.Module):
    """Actor-critic network: obs -> (value [N], policy probabilities [N, 9]),
    one hidden dense layer of 512 as the JAX package's defaults.

    Parity: reference ``SafeLifePolicyNetwork`` (models.py:79-108); returns
    softmax probabilities, as the reference's PPO loss is written in terms
    of probability ratios.
    """

    def __init__(self, view_shape=(25, 25), num_channels=None,
                 unpack_channels=None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if unpack_channels is not None:
            unpack_channels = tuple(unpack_channels)
            num_channels = len(unpack_channels)
        if num_channels is None:
            raise ValueError("give num_channels or unpack_channels")
        self.unpack_channels = unpack_channels
        self.cnn = SafeLifeCNN(num_channels, device=dev)
        features = cnn_output_features(tuple(view_shape) + (num_channels,))
        self.dense = nn.Linear(features, HIDDEN_WIDTH, device=dev)
        self.value = nn.Linear(HIDDEN_WIDTH, 1, device=dev)
        self.logits = nn.Linear(HIDDEN_WIDTH, NUM_ACTIONS, device=dev)

    def forward(self, obs):
        if self.unpack_channels is not None:
            obs = unpack_obs(obs, self.unpack_channels)
        with strict_float32():
            x = torch.relu(self.dense(self.cnn(obs.to(torch.float32))))
            value = self.value(x)[..., 0]
            policy = torch.softmax(self.logits(x), dim=-1)
        return value, policy
