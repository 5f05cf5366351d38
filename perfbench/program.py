"""The program under test, the PyTorch and CUDA port ``safelife_tpu_torch``,
as the checkout holds it, and the objects a cell builds from it: the level
pool, the policy network with the benchmark's weights, the env and
training configurations.

Nothing here imports the JAX package; the levels are read as data.
"""

import dataclasses
import importlib
import os
import types

import numpy as np
import torch

PACKAGE = "safelife_tpu_torch"
_TRUNCATED_NORMAL_STD = 0.87962566103423978


def port(root):
    """The port's modules, imported from ``root``; raises if the package
    that imports is not the checkout's (or is missing)."""
    pkg = importlib.import_module(PACKAGE)
    where = os.path.realpath(os.path.dirname(os.path.abspath(pkg.__file__)))
    if where != os.path.realpath(os.path.join(root, PACKAGE)):
        raise RuntimeError("%s imports from %s, not from the checkout %s"
                           % (PACKAGE, where, root))

    def m(name):
        return importlib.import_module(PACKAGE + "." + name)

    return types.SimpleNamespace(
        ops=m("ops"), build=m("ops._build"), env=m("env.env"),
        wrappers=m("env.wrappers"), state=m("env.state"),
        levels=m("io.levels"), nets=m("models.nets"), ppo=m("training.ppo"),
        runner=m("training.runner"), side_effects=m("side_effects"))


def levels_path(root, cfg):
    return os.path.join(root, *cfg["levels"].split("/"))


def policy_shapes(net, view):
    """{parameter name: shape} of the configuration's policy network."""
    shapes = {}
    h, w = view
    c = len(net["channels"])
    for layer in net["convs"]:
        k = layer["kernel"]
        shapes[layer["name"] + ".weight"] = (layer["out"], c, k, k)
        shapes[layer["name"] + ".bias"] = (layer["out"],)
        h = (h - k) // layer["stride"] + 1
        w = (w - k) // layer["stride"] + 1
        c = layer["out"]
    hidden = net["dense"]["out"]
    shapes[net["dense"]["name"] + ".weight"] = (hidden, h * w * c)
    shapes[net["dense"]["name"] + ".bias"] = (hidden,)
    shapes[net["value"] + ".weight"] = (1, hidden)
    shapes[net["value"] + ".bias"] = (1,)
    shapes[net["logits"] + ".weight"] = (net["actions"], hidden)
    shapes[net["logits"] + ".bias"] = (net["actions"],)
    return shapes


def policy_weights(net, view, seed, device):
    """The benchmark's weights of the policy network, made on ``device``
    from ``seed`` in one draw: flax's ``lecun_normal`` (a normal of scale
    sqrt(1 / fan_in) / 0.8796, truncated at two of its scales, by the
    inverse CDF of one uniform a weight) and zero biases, float32."""
    shapes = policy_shapes(net, view)
    sizes = {k: int(np.prod(s)) for k, s in shapes.items()
             if k.endswith(".weight")}
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes.values()), generator=gen, device=device,
                   dtype=torch.float32)
    lo = 0.5 * (1 + torch.erf(torch.tensor(-2.0 / 2 ** 0.5)))
    z = 2 ** 0.5 * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1)
    z = z.clamp(-2.0, 2.0)
    out, off = {}, 0
    for name, shape in shapes.items():
        if name in sizes:
            fan_in = int(np.prod(shape[1:]))
            std = fan_in ** -0.5 / _TRUNCATED_NORMAL_STD
            out[name] = (z[off:off + sizes[name]] * std).reshape(shape)
            off += sizes[name]
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32,
                                    device=device)
    return out


def policy(p, cfg, weights, device, precision):
    """The port's policy network on packed views, holding ``weights``."""
    net = cfg["policy"]
    model = p.nets.SafeLifePolicyNetwork(
        view_shape=tuple(cfg["view_shape"]),
        unpack_channels=tuple(net["channels"]), device=device,
        precision=precision)
    state = model.state_dict()
    if set(state) != set(weights):
        raise RuntimeError("the port's policy holds %s, the configuration "
                           "%s" % (sorted(state), sorted(weights)))
    model.load_state_dict(weights)
    return model


def env_config(p, cfg):
    """The port's ``EnvConfig``: packed views of the configured shape."""
    if not cfg["packed_views"]:
        raise ValueError("only packed views are configured")
    return p.env.EnvConfig(view_shape=tuple(cfg["view_shape"]),
                           output_channels=None,
                           time_limit=cfg["time_limit"])


def wrapper_config(p, cfg):
    fields = {f.name for f in dataclasses.fields(p.wrappers.WrapperConfig)}
    extra = set(cfg["wrapper"]) - fields
    if extra:
        raise ValueError("the port's WrapperConfig lacks %s" % sorted(extra))
    return p.wrappers.WrapperConfig(**cfg["wrapper"])


def host(x):
    """A host copy of a tensor (or of the tensors of a dict, a tuple or a
    dataclass)."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(host(v) for v in x)
    if dataclasses.is_dataclass(x):
        return {f.name: host(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x
