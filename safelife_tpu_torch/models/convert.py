"""Load the JAX package's policy parameters into the torch network.

Takes the flax parameter tree of ``SafeLifePolicyNetwork`` as
``safelife_tpu/models/nets.py:174`` (``init_policy_params``) builds it,
with numpy arrays as leaves — ``SafeLifeCNN_0/Conv_{0,1,2}`` and
``Dense_{0,1,2}`` (hidden, value, logits) — and maps it onto
:class:`~safelife_tpu_torch.models.nets.SafeLifePolicyNetwork`:

* conv kernels HWIO → OIHW;
* dense kernels [in, out] → [out, in].

The torch trunk flattens its feature map in flax's NHWC order, so the first
dense layer needs no row permutation.
"""

import numpy as np
import torch


def _conv(p):
    return {"weight": np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)),
            "bias": np.asarray(p["bias"])}


def _dense(p):
    return {"weight": np.asarray(p["kernel"]).T, "bias": np.asarray(p["bias"])}


def policy_params_from_flax(tree):
    """State dict for ``SafeLifePolicyNetwork`` from a flax parameter tree
    (with or without the top ``"params"``)."""
    params = tree.get("params", tree)
    cnn = params["SafeLifeCNN_0"]
    parts = {
        "cnn.conv0": _conv(cnn["Conv_0"]),
        "cnn.conv1": _conv(cnn["Conv_1"]),
        "cnn.conv2": _conv(cnn["Conv_2"]),
        "dense": _dense(params["Dense_0"]),
        "value": _dense(params["Dense_1"]),
        "logits": _dense(params["Dense_2"]),
    }
    return {"%s.%s" % (name, k): torch.tensor(v, dtype=torch.float32)
            for name, p in parts.items() for k, v in p.items()}
