"""Pieces of the training-run setup.

Port of part of ``safelife_tpu/training/env_factory.py``:
``TRAINING_CHANNELS`` (``:29-35``, kept in :mod:`..models.nets`),
``SIDE_EFFECT_WEIGHTS`` (``:37``), ``LinearSchedule`` (``:42-53``) and the
``EnvBundle`` dataclass (``:294-314``). ``build_environments``, the task
registry and the level iterators need the level generator, which is not
ported yet.
"""

import dataclasses

import numpy as np

from ..env import env as E, wrappers as W
from ..io.iterator import LevelPoolManager
from ..loggers import SafeLifeLogger
from ..models.nets import TRAINING_CHANNELS  # noqa: F401

#: The side-effect weights of every task (reference ``env_factory.py``):
#: the weighted ``total`` that the benchmark's score reads.
SIDE_EFFECT_WEIGHTS = {"life-green": 1.0, "spawner-yellow": 2.0}


class LinearSchedule:
    """Piecewise-linear schedule over the logger's cumulative training
    steps (reference ``env_factory.py:29-48``)."""

    def __init__(self, logger, t, y):
        self.logger = logger
        self.t = np.asarray(t, float)
        self.y = np.asarray(y, float)

    def __call__(self):
        step = self.logger.cumulative_stats.get("training_steps", 0)
        return float(np.interp(step, self.t, self.y))


@dataclasses.dataclass
class EnvBundle:
    """Everything the training loop needs for one run."""

    env_cfg: E.EnvConfig
    wrapper_cfg: W.WrapperConfig
    pool_manager: LevelPoolManager
    training_logger: SafeLifeLogger
    se_penalty_schedule: LinearSchedule
    exit_difficulty_schedule: LinearSchedule
    validation_levels: list
    benchmark_levels: list
    side_effect_weights: dict
    #: The binary channel set the policy sees. With
    #: ``env_cfg.output_channels`` None (packed views) the network unpacks
    #: these channels at its input.
    obs_channels: tuple = None

    @property
    def packed_obs(self):
        return self.env_cfg.output_channels is None
