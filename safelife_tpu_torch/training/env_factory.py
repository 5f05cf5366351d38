"""Environment construction for training runs.

Port of ``safelife_tpu/training/env_factory.py``: ``TRAINING_CHANNELS``
(``:29-35``, kept in :mod:`..models.nets`), ``SIDE_EFFECT_WEIGHTS``
(``:37``), ``VALIDATION_SEED`` (``:39``), ``LinearSchedule``
(``:42-53``), ``SwitchingLevelIterator`` (``:56-67``),
``CurricularLevelIterator`` (``:70-163``), ``task_types`` (``:167-286``),
``MULTIAGENT_PAD`` (``:291``), ``EnvBundle`` (``:294-314``) and
``build_environments`` (``:317-467``).

The reference's ``training/env_factory.py``: the task registry (same task
names), linear schedules driven by the logger's cumulative training steps,
curriculum and coin-flip switching level iterators, validation levels on a
pinned seed, and the benchmark levels. The factory returns an
:class:`EnvBundle` of configs, the level pool on the run's device,
schedules and the training logger.
"""

import dataclasses
import logging
import os
from collections import defaultdict

import numpy as np

from ..env import env as E, wrappers as W
from ..io.iterator import LevelPoolManager, SafeLifeLevelIterator
from ..io.levels import LEVEL_DIRECTORY, load_levels
from ..loggers import SafeLifeLogger
from ..models.nets import TRAINING_CHANNELS
from ..parallel.mesh import per_host_seed
from ..utils.device import resolve_device
from ..utils.rng import coinflip, get_rng

logger = logging.getLogger(__name__)

#: The side-effect weights of every task (reference ``env_factory.py``):
#: the weighted ``total`` that the benchmark's score reads.
SIDE_EFFECT_WEIGHTS = {"life-green": 1.0, "spawner-yellow": 2.0}

VALIDATION_SEED = 732230218323780641


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


class SwitchingLevelIterator(SafeLifeLevelIterator):
    """Coin-flip between two level types with a scheduled probability
    (parity: env_factory.py:155-174)."""

    def __init__(self, level1, level2, p_switch, **kwargs):
        super().__init__(level1, level2, **kwargs)
        self.p_switch = p_switch

    def get_next_parameters(self):
        if coinflip(self.p_switch()):
            return self.file_data[1]
        return self.file_data[0]


class CurricularLevelIterator(SafeLifeLevelIterator):
    """Softmax curriculum over per-level progress slopes
    (parity: env_factory.py:51-152)."""

    progression_lottery_ticket = 0.9
    eval_lookback = 10
    eval_nth_best = 3
    lookback = 100
    curriculum_distribution = "progress_estimate"  # or "uniform"

    def __init__(self, *levels, logger=None, curriculum_params={}, **kwargs):
        super().__init__(*levels, repeat_levels=True, **kwargs)
        self.logger = logger
        self.max_stage = len(levels) - 1
        self.perf_records = defaultdict(lambda: [0.0])
        self.best = defaultdict(lambda: 0.0)
        self._best_improved = None
        self._last_data_seen = None
        for k, v in curriculum_params.items():
            setattr(self, k, v)

    @staticmethod
    def _stage_key(name):
        """Normalize a level identity to its spec stem: episode records
        carry names like ``asym1-e5`` (basename + seed suffix), while
        ``file_data`` entries carry the full yaml path — both reduce to
        ``asym1``."""
        import re

        stem = os.path.basename(str(name))
        for ext in (".yaml", ".json", ".npz"):
            stem = stem.replace(ext, "")
        return re.sub(r"-e\d+$", "", stem)

    def update_result_records(self):
        results = getattr(self.logger, "last_data", None)
        if results is None or results is self._last_data_seen:
            return
        self._last_data_seen = results
        reward = np.array(results.get("reward", 0.0))
        possible = np.array(results.get("reward_possible", 1.0))
        filename = results.get("level_name")
        if reward.size > 0 and filename:
            key = self._stage_key(filename)
            perf = float(np.average(reward / np.maximum(possible, 1e-9)))
            if not np.isfinite(perf):
                perf = 0.0
            self.perf_records[key].append(perf)
            if perf > self.best[key]:
                self.best[key] = perf
                self._best_improved = (key, perf)

    def pop_best_improvement(self):
        """(stage_key, perf) when an episode just set a new best — the
        training loop uses this to record a best-episode video (parity:
        env_factory.py:148-152)."""
        out, self._best_improved = self._best_improved, None
        return out

    def get_next_parameters(self):
        from scipy.special import softmax

        self.update_result_records()
        progress = 0.2 * np.ones(self.max_stage + 1) / self.lookback
        for i, entry in enumerate(self.file_data):
            recs = self.perf_records[self._stage_key(entry[0])]
            if len(recs) >= self.lookback:
                m, _ = np.polyfit(np.arange(self.lookback),
                                  recs[-self.lookback:], 1)
                progress[i] = 10 * m
        scale = np.min(np.abs(progress))
        progress = progress.clip(0, None) / max(scale, 1e-12)
        progress[~np.isfinite(progress)] = 0.0
        if self.curriculum_distribution == "progress_estimate":
            probabilities = softmax(progress)
        else:
            probabilities = np.ones(self.max_stage + 1) / \
                (self.max_stage + 1)
        if self.logger is not None:
            # Per-stage curriculum telemetry (parity: env_factory.py
            # :135-144).
            record = {}
            for i, entry in enumerate(self.file_data):
                key = self._stage_key(entry[0])
                recent = self.perf_records[key][-self.lookback:]
                record["normalised_progress_lvl%d" % i] = progress[i]
                record["probability_lvl%d" % i] = probabilities[i]
                record["best_perf_lvl%d" % i] = self.best[key]
                record["recent%d_perf_lvl%d" % (self.lookback, i)] = \
                    float(np.average(recent)) if recent else 0.0
            self.logger.log_scalars(record, tag="curriculum")
        choice = get_rng().choice(self.max_stage + 1, p=probabilities)
        return self.file_data[choice]


#: Task registry (parity: env_factory.py:177-258).
task_types = {
    'append-still': {
        'iter_class': SafeLifeLevelIterator,
        'train_levels': ['random/append-still-easy'],
        'validation_levels': ['random/append-still'],
        'benchmark_levels': 'benchmarks/v1.0/append-still.npz',
    },
    'prune-still': {
        'iter_class': SafeLifeLevelIterator,
        'train_levels': ['random/prune-still'],
        'validation_levels': ['random/prune-still'],
        'benchmark_levels': 'benchmarks/v1.0/prune-still.npz',
    },
    'append-spawn': {
        'iter_class': SwitchingLevelIterator,
        'train_levels': ['random/append-still-easy', 'random/append-spawn'],
        'validation_levels': ['random/append-spawn'],
        'benchmark_levels': 'benchmarks/v1.0/append-spawn.npz',
    },
    'prune-spawn': {
        'iter_class': SwitchingLevelIterator,
        'train_levels': ['random/prune-still', 'random/prune-spawn'],
        'validation_levels': ['random/prune-spawn'],
        'benchmark_levels': 'benchmarks/v1.0/prune-spawn.npz',
    },
    'curriculum-append-spawn': {
        'iter_class': CurricularLevelIterator,
        'train_levels': ['random/append-still-easy', 'random/append-spawn'],
        'validation_levels': ['random/append-spawn'],
        'benchmark_levels': 'benchmarks/v1.0/append-spawn.npz',
    },
    'navigate': {
        'iter_class': SafeLifeLevelIterator,
        # The reference points at a pregenerated 'training/navigation'
        # set it never shipped (another dangling registry entry); live
        # generation from the same spec is affordable here because the
        # pool refreshes asynchronously off the training path.
        'train_levels': ['random/navigation'],
        'validation_levels': ['random/navigation'],
        'benchmark_levels': 'benchmarks/v1.0/navigation.npz',
    },

    # The remaining three v1.0 benchmark suites have no training task in
    # the reference registry (env_factory.py:177-258 stops at the six
    # above); these entries follow its easy->target switching pattern so
    # every frozen v1.0 archive is trainable and benchmarkable here.
    'append-dynamic': {
        'iter_class': SwitchingLevelIterator,
        'train_levels': ['random/append-still-easy',
                         'random/append-dynamic'],
        'validation_levels': ['random/append-dynamic'],
        'benchmark_levels': 'benchmarks/v1.0/append-dynamic.npz',
    },
    'prune-dynamic': {
        'iter_class': SwitchingLevelIterator,
        'train_levels': ['random/prune-still', 'random/prune-dynamic'],
        'validation_levels': ['random/prune-dynamic'],
        'benchmark_levels': 'benchmarks/v1.0/prune-dynamic.npz',
    },
    'prune-still-hard': {
        'iter_class': SwitchingLevelIterator,
        'train_levels': ['random/prune-still',
                         'random/prune-still-hard'],
        'validation_levels': ['random/prune-still-hard'],
        'benchmark_levels': 'benchmarks/v1.0/prune-still-hard.npz',
    },

    # Multi-agent tasks (parity: env_factory.py:219-258). No frozen
    # benchmark archives exist for these; validation levels double as the
    # evaluation suite, as in the reference.
    'asym1': {
        'iter_class': CurricularLevelIterator,
        'train_levels': ['random/multi-agent/asym1'],
        'validation_levels': ['random/multi-agent/asym1'],
        'multiagent': True,
        'benchmark_levels': 'benchmarks/multi-agent-v1/asym1.npz',
    },
    'curriculum-asym1': {
        'iter_class': CurricularLevelIterator,
        'train_levels': [
            'random/multi-agent/asym1',
            'random/multi-agent/asym1-pretrain-cyanonly',
            'random/multi-agent/asym1-pretrain-redonly'],
        'validation_levels': ['random/multi-agent/asym1'],
        'multiagent': True,
        'benchmark_levels': 'benchmarks/multi-agent-v1/asym1.npz',
    },
    'multi-build-coop': {
        'iter_class': SafeLifeLevelIterator,
        'train_levels': ['random/multi-agent/build-coop'],
        'validation_levels': ['random/multi-agent/build-coop'],
        'multiagent': True,
        'benchmark_levels': 'benchmarks/multi-agent-v1/multi-build-coop.npz',
    },
    'multi-build-compete': {
        'iter_class': SafeLifeLevelIterator,
        'train_levels': ['random/multi-agent/build-compete'],
        'validation_levels': ['random/multi-agent/build-compete'],
        'multiagent': True,
        'benchmark_levels': 'benchmarks/multi-agent-v1/multi-build-compete.npz',
    },
    'multi-build-parallel': {
        'iter_class': SafeLifeLevelIterator,
        'train_levels': ['random/multi-agent/build-parallel'],
        'validation_levels': ['random/multi-agent/build-parallel'],
        'multiagent': True,
        'benchmark_levels': 'benchmarks/multi-agent-v1/multi-build-parallel.npz',
    },
    'multi-prune': {
        'iter_class': SafeLifeLevelIterator,
        # The reference names 'random/multi-agent/prune-still' here but
        # never shipped that file; ours is generated by
        # scripts/regen_multiagent_specs.py so the task actually runs.
        'train_levels': ['random/prune-still',
                         'random/multi-agent/prune-still'],
        'validation_levels': ['random/multi-agent/prune-still'],
        'multiagent': True,
        'benchmark_levels': 'benchmarks/multi-agent-v1/multi-prune.npz',
    },
}

#: Agent-slot padding for multi-agent pools: every multi-agent spec
#: rosters at most two agents; mixed 1/2-agent level streams (e.g.
#: curriculum-asym1) pad to this.
MULTIAGENT_PAD = 2


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


def build_environments(config, data_dir=None, num_envs=64, pool_size=None,
                       procgen_workers=4, device="cuda"):
    """Build the training bundle of a task, its level pool on ``device``
    (reference ``env_factory.py:290-410``). In a multi-process run each
    rank generates ``pool_size`` levels of its own stream and the pool is
    all of them (:class:`..io.iterator.LevelPoolManager`).

    ``pool_size`` defaults to ``max(32, min(256, 2 * num_envs))``: refresh
    only rotates slots no live lane references, so the pool must exceed
    the lane count for levels to turn over; beyond 256 slots the start-up
    generation costs more than turnover is worth, and ``env.pool_size``
    overrides it.

    The start-up pool fixes which dynamics the run can see: its
    ``all_goals_static`` and ``spawner_free`` flags stay as built, and
    ``refresh`` drops later levels that break them.
    """
    dev = resolve_device(device)
    task = config.setdefault('env_type', 'append-still')
    if pool_size is None:
        pool_size = max(32, min(256, 2 * num_envs))
    pool_size = int(config.setdefault('env.pool_size', pool_size))
    if task not in task_types:
        raise ValueError("'%s' is not a recognized task" % task)
    task_data = task_types[task]
    # 0 generates levels synchronously in this process.
    procgen_workers = int(config.setdefault(
        'env.procgen_workers', procgen_workers))

    seed = np.random.SeedSequence(config.setdefault('seed', None))
    training_seed, benchmark_seed = seed.spawn(2)
    # Each rank's own training stream (the JAX package's
    # ``per_host_seed``); the pool manager gathers every rank's pool.
    training_seed = per_host_seed(training_seed)

    view_size = config.setdefault('env.view_size', 25)
    # Packed views (the default): the network unpacks TRAINING_CHANNELS at
    # its input. Otherwise the env unpacks them after K3 into uint8
    # channels, which the PPO trajectory and DQN's replay then store.
    packed_obs = config.setdefault('env.packed_obs', True)
    env_cfg = E.EnvConfig(
        view_shape=(view_size, view_size),
        output_channels=None if packed_obs else TRAINING_CHANNELS,
        time_limit=1000,
    )
    multiagent = bool(task_data.get('multiagent'))
    wrapper_cfg = W.WrapperConfig(
        se_baseline=config.setdefault('side_effect.baseline',
                                      'starting-state'),
        ignore_reward_cells=config.setdefault(
            'side_effect.ignore_reward_cells', False),
        single_agent=not multiagent,
        # ContinuingEnv mode (reference env_wrappers.py:101-118).
        continuing=config.setdefault('env.continuing', False),
        # Score every finished training episode's side effects (the
        # reference's exhaustive behavior, safelife_env.py:183-193)
        # instead of sampling one per report.
        exhaustive_se=config.setdefault(
            'side_effect.exhaustive_logging', False),
    )

    training_logger = SafeLifeLogger(
        data_dir and os.path.join(data_dir, ''), episode_type='training')

    iter_class = task_data.get('iter_class', SafeLifeLevelIterator)
    iter_args = {'seed': training_seed, 'num_workers': procgen_workers}
    # Opt-in device-batched level generation (procgen/batched.py): N
    # levels anneal as N lockstep chains on the run's device, with no
    # forked workers.
    device_procgen = int(config.setdefault('env.device_procgen', 0))
    if device_procgen:
        iter_args.update(device_batch=device_procgen, num_workers=0,
                         device=dev)
    if iter_class is CurricularLevelIterator:
        iter_args['logger'] = training_logger
        iter_args['curriculum_params'] = {
            'curriculum_distribution': config.setdefault(
                'env.curriculum', 'progress_estimate')}
        iter_args.pop('num_workers')  # curriculum picks levels synchronously
    elif iter_class is SwitchingLevelIterator:
        sched = config.setdefault('env.task_switch',
                                  {'t': [1e5, 1.5e6], 'y': [0.1, 1.0]})
        iter_args['p_switch'] = LinearSchedule(training_logger, **sched)
        iter_args.pop('num_workers')  # switching picks levels synchronously

    training_iter = iter_class(*task_data['train_levels'], **iter_args)
    pool_manager = LevelPoolManager(
        training_iter, pool_size=pool_size,
        pad_agents=MULTIAGENT_PAD if multiagent else None, device=dev)

    se_penalty = config.setdefault('side_effect.penalty', 0.0)
    se_schedule = dict(config.setdefault(
        'side_effect.schedule', {'t': [1e6, 2e6], 'y': [0, 1.0]}))
    se_schedule['y'] = (np.array(se_schedule['y']) * se_penalty).tolist()
    exit_schedule = config.setdefault(
        'env.exit_difficulty', {'t': [5e5, 2e6], 'y': [0.001, 1.0]})

    validation_levels = []
    if task_data.get('validation_levels'):
        n_val = config.setdefault('validation.num_levels', 5)
        val_seed = config.setdefault('validation.env_seed', VALIDATION_SEED)
        val_iter = SafeLifeLevelIterator(
            *task_data['validation_levels'], seed=val_seed,
            num_workers=0, repeat_levels=True, distinct_levels=n_val)
        validation_levels = [next(val_iter) for _ in range(n_val)]

    benchmark_levels = []
    bench_file = task_data.get('benchmark_levels')
    if bench_file:
        # The shipped copy of the reference's frozen v1.0 archives, unless
        # SAFELIFE_BENCHMARK_DIR holds the file.
        env_dir = os.environ.get("SAFELIFE_BENCHMARK_DIR")
        candidates = [
            env_dir and os.path.join(env_dir, bench_file),
            os.path.join(LEVEL_DIRECTORY, bench_file),
        ]
        for path in candidates:
            if path and os.path.exists(path):
                benchmark_levels = load_levels(path)
                break
        else:
            try:
                benchmark_levels = load_levels(bench_file)
            except FileNotFoundError:
                logger.warning(
                    "benchmark levels '%s' not found; generating 20 fresh "
                    "validation-style levels instead", bench_file)
                gen = SafeLifeLevelIterator(
                    *task_data['validation_levels'], seed=benchmark_seed,
                    num_workers=0)
                benchmark_levels = [next(gen) for _ in range(20)]

    return EnvBundle(
        env_cfg=env_cfg,
        wrapper_cfg=wrapper_cfg,
        pool_manager=pool_manager,
        training_logger=training_logger,
        se_penalty_schedule=LinearSchedule(training_logger, **se_schedule),
        exit_difficulty_schedule=LinearSchedule(training_logger,
                                                **exit_schedule),
        validation_levels=validation_levels,
        benchmark_levels=benchmark_levels,
        side_effect_weights=dict(SIDE_EFFECT_WEIGHTS),
        obs_channels=TRAINING_CHANNELS,
    )
