"""The registry of canonical environments, and a gym-like batched env.

Port of ``safelife_tpu/registry.py:1-96``: ``ENV_REGISTRY``, ``register``,
the eight canonical names of the reference ``SafeLifeEnv.register``
(``safelife_env.py:231-246``), ``BatchedSafeLifeEnv`` and ``make``.

``make(name)`` returns a :class:`BatchedSafeLifeEnv`, a thin stateful
wrapper over the batched functions of :mod:`.env.env` for users who want
the familiar ``reset()``/``step()``: its level pool, state and
``torch.Generator`` (in place of JAX's PRNG key) live on ``device``, so
every ``step`` runs kernels K1 and K3 there, and K2 where goals evolve.
"""

import dataclasses

import numpy as np
import torch

from .env import env as E
from .env.state import pack_levels
from .io.iterator import SafeLifeLevelIterator
from .utils.device import resolve_device

#: name -> level paths + env-config overrides
ENV_REGISTRY = {}


def register(name, levels, **env_kwargs):
    ENV_REGISTRY[name] = {"levels": levels, "env_kwargs": env_kwargs}


for _name in ["append-still", "prune-still",
              "append-still-easy", "prune-still-easy",
              "append-spawn", "prune-spawn",
              "navigation", "challenge"]:
    register("safelife-%s-v1" % _name, ["random/" + _name])


class BatchedSafeLifeEnv:
    """Stateful wrapper over the functional batched env.

    Holds a level pool on ``device`` (``pool_size`` levels from the spec's
    paths), the current :class:`~.env.state.EnvState` and a
    ``torch.Generator`` there, seeded from ``seed``; ``step`` applies one
    lockstep update across the batch. Single-env use is ``batch_size=1``
    (tensors keep the leading batch axis).
    """

    def __init__(self, cfg, levels, batch_size=1, seed=None, pool_size=16,
                 device="cuda"):
        dev = resolve_device(device)
        self.cfg = cfg
        it = SafeLifeLevelIterator(*levels, seed=seed)
        self.pool = pack_levels([next(it) for _ in range(pool_size)],
                                device=dev)
        self.batch_size = batch_size
        self.generator = torch.Generator(device=dev).manual_seed(
            seed if isinstance(seed, int) else 0)
        self.state = None

    @property
    def device(self):
        return self.pool.device

    @property
    def num_agents(self):
        return self.pool.num_agents

    def reset(self):
        """Lane i starts on pool level ``i mod pool_size``. Returns the
        observations."""
        self.state, obs = E.reset(self.cfg, self.pool, self.batch_size)
        return obs

    def step(self, actions):
        """One step of every lane. ``actions``: int [B] or [B, A], NumPy or
        a torch tensor (one already on the device is used as it is).
        Returns (obs, reward, done, info), tensors on the device."""
        if self.state is None:
            raise RuntimeError("call reset() before step()")
        if not isinstance(actions, torch.Tensor):
            actions = torch.from_numpy(np.asarray(actions, np.int32))
        actions = actions.to(self.device, torch.int32)
        if actions.dim() == 1:
            actions = actions[:, None]
        self.state, obs, reward, done, info = E.step(
            self.cfg, self.pool, self.state, actions, self.generator)
        return obs, reward, done, info

    def render(self, lane=0):
        """ANSI text of one lane's board over its goals (copied to the
        host)."""
        from .render.text import render_board

        return render_board(self.state.board[lane].cpu().numpy(),
                            self.state.goals[lane].cpu().numpy())


def make(name, batch_size=1, seed=None, device="cuda", **env_overrides):
    """Instantiate a registered environment by canonical name on
    ``device``."""
    if name not in ENV_REGISTRY:
        raise KeyError(
            "unknown environment '%s'; registered: %s"
            % (name, sorted(ENV_REGISTRY)))
    spec = ENV_REGISTRY[name]
    cfg = E.EnvConfig(view_shape=(25, 25), **spec["env_kwargs"])
    if env_overrides:
        cfg = dataclasses.replace(cfg, **env_overrides)
    return BatchedSafeLifeEnv(cfg, spec["levels"], batch_size=batch_size,
                              seed=seed, device=device)
