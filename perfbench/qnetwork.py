"""The dueling Q network of the DQN cells: its parameters' shapes, the
benchmark's weights drawn from the seed, the port's network holding them,
and its model FLOPs (``perfbench/peaks.py``'s counting rules, for the
policy network, applied to the Q network).

Nothing here imports the JAX package.
"""

import numpy as np
import torch

from . import peaks, program


def shapes(net, view):
    """{parameter name: shape} of the configuration's Q network ``net``
    (its ``q_network``) on views of ``view``."""
    out = {}
    h, w = view
    c = len(net["channels"])
    for layer in net["convs"]:
        k = layer["kernel"]
        out[layer["name"] + ".weight"] = (layer["out"], c, k, k)
        out[layer["name"] + ".bias"] = (layer["out"],)
        h = peaks.conv_out(h, k, layer["stride"])
        w = peaks.conv_out(w, k, layer["stride"])
        c = layer["out"]
    hidden = net["hidden"]
    for first, last, width in (("adv_hidden", "adv", net["actions"]),
                               ("value_hidden", "value", 1)):
        out[net[first] + ".weight"] = (hidden, h * w * c)
        out[net[first] + ".bias"] = (hidden,)
        out[net[last] + ".weight"] = (width, hidden)
        out[net[last] + ".bias"] = (width,)
    return out


def weights(net, view, seed, device):
    """The benchmark's weights of the Q network, made on ``device`` from
    ``seed`` in one draw as ``program.policy_weights`` makes the policy's:
    flax's ``lecun_normal`` (a normal of scale sqrt(1 / fan_in) / 0.8796,
    truncated at two of its scales, by the inverse CDF of one uniform a
    weight) and zero biases, float32."""
    sizes = {k: int(np.prod(s)) for k, s in shapes(net, view).items()
             if k.endswith(".weight")}
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes.values()), generator=gen, device=device,
                   dtype=torch.float32)
    lo = 0.5 * (1 + torch.erf(torch.tensor(-2.0 / 2 ** 0.5)))
    z = 2 ** 0.5 * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1)
    z = z.clamp(-2.0, 2.0)
    out, off = {}, 0
    for name, shape in shapes(net, view).items():
        if name in sizes:
            std = int(np.prod(shape[1:])) ** -0.5 \
                / program._TRUNCATED_NORMAL_STD
            out[name] = (z[off:off + sizes[name]] * std).reshape(shape)
            off += sizes[name]
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32,
                                    device=device)
    return out


def model(nets, cfg, params, device, precision):
    """The port's ``SafeLifeQNetwork`` on packed views, holding
    ``params``."""
    net = cfg["q_network"]
    m = nets.SafeLifeQNetwork(
        view_shape=tuple(cfg["view_shape"]),
        unpack_channels=tuple(net["channels"]), device=device,
        precision=precision)
    state = m.state_dict()
    if set(state) != set(params):
        raise RuntimeError("the port's Q network holds %s, the configuration "
                           "%s" % (sorted(state), sorted(params)))
    m.load_state_dict(params)
    return m


def macs(net, view):
    """(multiply-adds of one sample's forward, those of the first
    convolution) of the Q network ``net`` on views of ``view``."""
    h, w = view
    c = len(net["channels"])
    total = first = 0
    for i, layer in enumerate(net["convs"]):
        k, s = layer["kernel"], layer["stride"]
        h, w = peaks.conv_out(h, k, s), peaks.conv_out(w, k, s)
        total += h * w * layer["out"] * k * k * c
        c = layer["out"]
        if i == 0:
            first = total
    hidden = net["hidden"]
    total += 2 * h * w * c * hidden + hidden * (net["actions"] + 1)
    return total, first


def unit_flops(net, view, lanes, batch):
    """FLOPs of one DQN unit: the acting forward of ``lanes`` views, the
    learner's forward and backward of ``batch`` samples (the backward
    twice the forward, the first convolution without an input gradient,
    as ``peaks.ppo_iteration_flops`` counts) and the target network's
    forward of ``batch`` next views."""
    m, first = macs(net, view)
    fwd = 2 * m
    return lanes * fwd + batch * (3 * fwd - 2 * first) + batch * fwd
