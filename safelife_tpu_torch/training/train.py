"""Training-loop orchestration (the reference's ``start-training.py``).

Port of ``safelife_tpu/training/train.py``:
``build_model`` (``:28-56``), ``load_for_eval`` (``:59-73``),
``_sampled_side_effects`` (``:76-103``), ``_exhaustive_side_effects``
(``:106-139``), ``_summarize_se_map`` (``:142-151``),
``_maybe_record_best_episode`` (``:161-181``), ``_restore_latest``
(``:184-262``), ``train_ppo`` (``:265-446``; its report is :func:`_report`
here), ``train_dqn`` (``:449-573``; its report is :func:`_report_dqn`),
``run_validation`` (``:576-585``) and ``run_benchmark`` (``:588-604``).

Around the PPO iteration (:mod:`.ppo`) or the DQN collect-and-optimize
unit (:mod:`.dqn`), both with kernels K1-K3 on CUDA, the loop runs
host-side control: schedules, reports (PPO's with side-effect telemetry),
PPO's validation, checkpoints (every 100k steps, the last 3 kept),
level-pool refreshes that never touch a slot a live lane is on. Where the
JAX package takes (``model``, ``params``, ``key``), these take the
network, which holds its parameters, and a ``torch.Generator`` on the
run's device.

Multi-process runs (``torchrun``, :mod:`..parallel.mesh`) train one
global program: ``batch_size`` is the global lane count, which must divide
over the ranks; each rank steps its own lanes, the learner is replicated,
and the run equals the one-process run with the same batch. The finished
episodes are gathered and logged by rank 0 alone; rank 0 alone writes the
checkpoints (the global env state, gathered, and the global pool), the
reports' scalars and runs the validation, while the others wait. Work
that rank 0 alone draws random numbers for is followed by its generator's
state on every rank (``sync_generator``). Every rank logs each report's
``pcheck``, which must agree bitwise.
"""

import dataclasses
import logging
import time

import numpy as np
import torch

from ..env import env as E, wrappers as W
from ..loggers import EpisodeCollector, SafeLifeLogger, summarize_run
from ..models.nets import (SafeLifePolicyNetwork, SafeLifeQNetwork,
                           flax_init_)
from ..parallel import mesh as M
from ..side_effects import side_effect_score, weighted_side_effect_total
from ..utils.device import resolve_device
from . import dqn, ppo, runner
from .checkpoints import CheckpointManager
from .global_config import build_config, config

logger = logging.getLogger(__name__)

#: Occupancy steps of the training-time side-effect telemetry.
TELEMETRY_SAMPLES = 1000


def build_model(bundle, algo="ppo", device="cuda"):
    """(network, obs shape, obs dtype) of ``algo`` for the bundle's
    observation mode, on ``device``: PPO's policy network or DQN's Q
    network. With packed views (``bundle.packed_obs``) the network unpacks
    ``bundle.obs_channels`` at its input from int32 [vh, vw]; otherwise it
    takes the env's uint8 channels [vh, vw, C].

    The network runs in ``train.precision`` (``models/nets.py::
    PRECISIONS``; an unknown name raises) with torch's own layer init, or
    flax's under ``train.torch_init: false`` (``nets.flax_init_``). Its
    draws come from torch's default generators, which the trainers seed.
    """
    nets = {"ppo": SafeLifePolicyNetwork, "dqn": SafeLifeQNetwork}
    if algo not in nets:
        raise ValueError("unknown algo %r" % algo)
    precision = config.setdefault("train.precision", "float32")
    torch_init = config.setdefault("train.torch_init", True)
    view = tuple(bundle.env_cfg.view_shape)
    if bundle.packed_obs:
        model = nets[algo](view_shape=view,
                           unpack_channels=bundle.obs_channels,
                           device=device, precision=precision)
        shape, dtype = view, torch.int32
    else:
        n_ch = len(bundle.env_cfg.output_channels)
        model = nets[algo](view_shape=view, num_channels=n_ch,
                           device=device, precision=precision)
        shape, dtype = view + (n_ch,), torch.uint8
    if not torch_init:
        flax_init_(model)
    return model, shape, dtype


def load_for_eval(algo, bundle, data_dir, device="cuda"):
    """The network with the latest checkpoint's parameters, for benchmark
    runs (reference ``start-training.py:276-285``)."""
    if not data_dir:
        raise ValueError("benchmark run type needs a data_dir with "
                         "checkpoints")
    model = build_model(bundle, algo, device=device)[0]
    state, _, step = CheckpointManager(data_dir).restore(device=device)
    if state is None:
        raise FileNotFoundError("no checkpoints under %s" % data_dir)
    model.load_state_dict(state["params"])
    logger.info("benchmarking checkpoint at step %s", step)
    return model


def _sampled_side_effects(ep_samples, bundle, generator):
    """Side effects of the last finished episode sampled in a chunk, for the
    training logger: the weighted total's fraction and one
    ``side_effects.<type>`` fraction (emd over the inaction total) per cell
    type, as the reference logs per episode (``safelife_logger.py:
    286-312``). None when no episode finished. The occupancy runs on the
    samples' device with seed words from ``generator``.
    """
    found = ep_samples["found"].cpu().numpy()
    hits = np.nonzero(found)[0]
    if not len(hits):
        return None
    i = int(hits[-1])
    se = side_effect_score(
        ep_samples["init_board"][i].cpu().numpy(),
        ep_samples["final_board"][i].cpu().numpy(),
        int(ep_samples["num_steps"][i]),
        float(ep_samples["spawn_prob"][i]), num_samples=TELEMETRY_SAMPLES,
        strkeys=True, generator=generator,
        device=ep_samples["init_board"].device)
    total = weighted_side_effect_total(se, bundle.side_effect_weights)
    out = {"side_effects_sampled":
           float(total[0]) / max(float(total[1]), 1.0)}
    for name, (emd, inaction_total) in se.items():
        out["side_effects." + name] = \
            float(emd) / max(float(inaction_total), 1.0)
    return out


def _exhaustive_side_effects(ep_samples, bundle, env_cfg, generator):
    """Side effects of EVERY finished episode captured in a chunk
    (``ep_samples`` rows flattened as the episode records are), as
    {row: side-effect dict}. The occupancy of all of them runs as one
    device batch; the EMD is host work per episode.
    """
    found = ep_samples["found"].cpu().numpy()
    hits = np.nonzero(found)[0]
    if not len(hits):
        return {}
    rows = torch.as_tensor(hits, device=ep_samples["found"].device)
    init_b, fin_b, steps, sp = (ep_samples[k].index_select(0, rows) for k in (
        "init_board", "final_board", "num_steps", "spawn_prob"))
    inaction, action = runner.batched_occupancy(
        init_b, fin_b, steps, sp, generator, num_samples=TELEMETRY_SAMPLES,
        max_pre_steps=env_cfg.time_limit)
    inaction, action, init_b, fin_b, steps, sp = (
        x.cpu().numpy() for x in (inaction, action, init_b, fin_b, steps, sp))
    return {
        int(lane): runner.episode_side_effects(
            init_b[j], fin_b[j], int(steps[j]), float(sp[j]), inaction[j],
            action[j], TELEMETRY_SAMPLES,
            side_effect_weights=bundle.side_effect_weights)
        for j, lane in enumerate(hits)}


def _summarize_se_map(se_map):
    """Mean weighted side-effect fraction over a chunk's episodes."""
    if not se_map:
        return None
    fracs = []
    for se in se_map.values():
        emd, inaction_total = se.get("total", (0.0, 0.0))
        fracs.append(float(emd) / max(float(inaction_total), 1.0))
    return {"side_effects_mean": float(np.mean(fracs)),
            "side_effects_episodes": float(len(fracs))}


def _maybe_record_best_episode(bundle, model, env_cfg, pool, generator):
    """When the curriculum records a new best of a stage, log one episode
    of that stage with the current policy, its history included (reference
    ``CurricularLevelIterator.record_video``, ``env_factory.py:148-152``)."""
    it = bundle.pool_manager.iterator
    pop = getattr(it, "pop_best_improvement", None)
    if pop is None:
        return
    best = pop()
    if best is None or bundle.training_logger.logdir is None:
        return
    stage, perf = best
    idx = next(
        (i for i, lv in enumerate(bundle.pool_manager._host_levels)
         if it._stage_key(lv.name or "") == stage), 0)
    history, vstats = runner.record_episode_history(
        env_cfg, pool, model, idx, generator, env_cfg.time_limit)
    bundle.training_logger.log_episode(
        {"level_name": "best-%s-%.3f" % (stage, perf), **vstats},
        history=history)


def _leaf_shapes(obj):
    """Sorted (shape, dtype) of every tensor of a (nested) dataclass."""
    if dataclasses.is_dataclass(obj):
        return sorted(x for f in dataclasses.fields(obj)
                      for x in _leaf_shapes(getattr(obj, f.name)))
    if isinstance(obj, torch.Tensor):
        return [(tuple(obj.shape), str(obj.dtype))]
    return []


def _checkpoint_state(learner, ws, pool):
    """What a training checkpoint holds: the learner (parameters, DQN's
    target parameters, Adam state, ``num_steps``), the env state and the
    level pool its lanes index into. DQN's replay and n-step rings are
    left out: they refill within one optimize interval, and a resumed run
    re-warms the buffer before it optimizes again."""
    state = {"params": learner.model.state_dict(),
             "opt_state": learner.optimizer.state_dict(),
             "num_steps": learner.num_steps, "env_state": ws, "pool": pool}
    if hasattr(learner, "target_model"):
        state["target_params"] = learner.target_model.state_dict()
    return state


def _slice_lanes(obj, lanes):
    """Lanes ``lanes.start``..``lanes.stop`` of every tensor of a state
    dataclass."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _slice_lanes(getattr(obj, f.name), lanes)
            for f in dataclasses.fields(obj)})
    return obj[lanes.start:lanes.stop]


def _restore_latest(ckpt, pstate, ws, bundle, device):
    """Restore the latest checkpoint into a training loop (PPO or DQN).

    The learner (parameters, DQN's target parameters, Adam state,
    ``num_steps``) is restored in place. The env state and the level pool
    its lanes index into are restored together when the saved env state
    has this run's shapes; otherwise (batch size or wrapper changed) the
    run resumes the learner only, with fresh episodes and levels. In a
    multi-process run the saved env state is the global batch, of which
    each rank takes its lanes.

    Returns ``(ws, obs, extra, step)``: ``obs`` is None unless the env
    state was restored, ``step`` None when there is no checkpoint.
    """
    state, extra, step = ckpt.restore(device=device)
    if state is None:
        return ws, None, None, None
    pstate.model.load_state_dict(state["params"])
    if hasattr(pstate, "target_model"):
        pstate.target_model.load_state_dict(state["target_params"])
    if "opt_state" in state:
        opt = state["opt_state"]
        # Adam keeps its step counts on the host (not capturable).
        for s in opt["state"].values():
            s["step"] = s["step"].cpu()
        pstate.optimizer.load_state_dict(opt)
    pstate.num_steps = int(state["num_steps"])
    obs = None
    saved = state.get("env_state")
    lanes = _rank_lanes(ws.env.board.shape[0] * M.process_count())
    if saved is not None and lanes is not None:
        whole = [((lanes.total,) + s[1:], d) for s, d in _leaf_shapes(ws)]
        if _leaf_shapes(saved) == sorted(whole):
            saved = _slice_lanes(saved, lanes)
    if saved is not None and _leaf_shapes(saved) != _leaf_shapes(ws):
        logger.warning(
            "checkpoint env state does not match this run's shapes "
            "(batch size or wrapper config changed); resuming learner "
            "state only with fresh episodes and levels")
    elif saved is not None:
        if "pool" in state:
            pool = bundle.pool_manager.restore_pool(state["pool"])
        else:
            pool = bundle.pool_manager.pool
            logger.warning(
                "checkpoint has env state but no level pool; resumed "
                "mid-episode lanes score against freshly generated levels")
        ws = saved
        obs = E._batch_obs(bundle.env_cfg, pool, ws.env)
    logger.info("restored checkpoint at step %s", step)
    return ws, obs, extra, step


def _pcheck(model):
    """The float64 L1 norm of the parameters: one host copy of every
    parameter, the float64 sum on the host."""
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return float(np.abs(flat.cpu().numpy().astype(np.float64)).sum())


def _rank_lanes(batch_size):
    """The rank's lanes of a multi-process run, None in one process;
    raises unless ``batch_size`` divides over the ranks."""
    if M.training_group() is None:
        return None
    return M.lane_range(batch_size)


def _gather_samples(ep_samples):
    """The side-effect sample of each step ([T, ...] on each rank) that a
    one-process run takes: the first rank's whose sample ``found`` an
    episode, else rank 0's."""
    parts = {k: torch.stack(M.all_gather(v))
             for k, v in ep_samples.items()}
    first = torch.argmax(parts["found"].to(torch.int32), 0)
    rows = torch.arange(first.shape[0], device=first.device)
    return {k: v[first, rows] for k, v in parts.items()}


def _episode_records(records, lanes):
    """A chunk's episode records ([U*T*b, ...] on each rank, steps
    outermost) as host arrays of the global batch's ([U*T*B, ...]), in
    the one-process order."""
    if lanes is not None:
        records = {k: v.reshape((-1, lanes.size) + tuple(v.shape[1:]))
                   for k, v in records.items()}
        records = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in
                   M.gather_episodes(records, 1).items()}
    return {k: v.cpu().numpy() for k, v in records.items()}


def _save_checkpoint(ckpt, step, learner, ws, pool, extra, lanes,
                     force=False):
    """Save a checkpoint when one is due (or ``force``): in a multi-process
    run every rank gathers the env state and rank 0 alone writes the
    global state, then every rank waits for it."""
    if not (force or ckpt.due(step)):
        return
    if lanes is not None:
        ws = M.gather_episodes(ws, 0)
    if M.is_logging_host():
        ckpt.save(step, _checkpoint_state(learner, ws, pool), extra)
    M.barrier()


def _report(bundle, pstate, metrics, ep_samples, se_map, generator, rate):
    """One report: the log line with the parameters' ``pcheck`` on every
    rank, and on rank 0 the scalars with side-effect telemetry to the
    training logger."""
    n = pstate.num_steps
    m = {k: float(v) for k, v in metrics.items()}
    logger.info(
        "n=%d: loss=%.3g entropy=%.3f reward=%.4f (%.0f steps/s) "
        "pcheck=%.17g",
        n, m["loss"], m["entropy"], m["reward_mean"], rate,
        _pcheck(pstate.model))
    if not M.is_logging_host():
        return
    if bundle.wrapper_cfg.exhaustive_se:
        se = _summarize_se_map(se_map)
    else:
        se = _sampled_side_effects(ep_samples, bundle, generator)
    if se is not None:
        m.update(se)
    bundle.training_logger.log_scalars(m, n, "ppo")
    _maybe_record_best_episode(bundle, pstate.model, bundle.env_cfg,
                               bundle.pool_manager.pool, generator)


def train_ppo(bundle, total_steps=6e6, batch_size=64, seed=0,
              data_dir=None, report_interval=None, test_interval=5e5,
              checkpoint_interval=100_000, pool_refresh=4,
              iters_per_chunk=8, device="cuda"):
    """Train PPO to ``total_steps`` env steps on ``device``, where the
    bundle's pool lives. Returns (model, ppo_state).

    A chunk is ``iters_per_chunk`` iterations of ``batch_size`` lanes x
    ``steps_per_env`` steps; after each, the finished episodes are logged,
    the pool refreshed (``pool_refresh`` levels at most, never a slot a
    live lane is on), a checkpoint saved when due, and at the report and
    test intervals a report and a validation run. With ``data_dir`` the
    run resumes from its latest checkpoint and saves at the end.
    """
    dev = resolve_device(device)
    lanes = _rank_lanes(batch_size)
    ppo_cfg = build_config(ppo.PPOConfig, "ppo")
    if report_interval is None:
        report_interval = ppo_cfg.report_interval
    env_cfg, wcfg = bundle.env_cfg, bundle.wrapper_cfg
    generator = torch.Generator(device=dev).manual_seed(seed)
    # The initial parameters draw from the default generators, seeded here
    # and restored after.
    with torch.random.fork_rng(
            devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        model = build_model(bundle, "ppo", device=dev)[0]
    pstate = ppo.init_ppo_state(ppo_cfg, model, device=dev)

    pool = bundle.pool_manager.pool
    ws, obs = W.reset(env_cfg, wcfg, pool, batch_size,
                      min_perf_fraction=bundle.exit_difficulty_schedule(),
                      device=dev, lanes=lanes)
    ckpt = data_dir and CheckpointManager(
        data_dir, interval=checkpoint_interval)
    if ckpt:
        # A full resume takes the env batch (mid-episode boards) and the
        # pool its lanes index into, so every lane scores against its own
        # level.
        ws, robs, extra, _ = _restore_latest(ckpt, pstate, ws, bundle, dev)
        if robs is not None:
            obs = robs
            pool = bundle.pool_manager.pool
        if extra:
            bundle.training_logger.cumulative_stats.update(extra)

    collector = EpisodeCollector(
        bundle.training_logger,
        level_meta=bundle.pool_manager.level_meta())
    logging_host = M.is_logging_host()
    se_map = {}
    steps_per_iter = ppo_cfg.steps_per_env * batch_size
    next_report = report_interval
    next_test = test_interval
    t0 = time.time()

    while pstate.num_steps < total_steps:
        pool = bundle.pool_manager.pool
        pstate, ws, obs, metrics = ppo.train_chunk(
            env_cfg, wcfg, ppo_cfg, pool, pstate, ws, obs, generator,
            iters_per_chunk,
            se_penalty_coef=bundle.se_penalty_schedule(),
            min_perf_fraction=bundle.exit_difficulty_schedule(),
            device=dev, lanes=lanes)
        episodes = _episode_records(metrics.pop("episodes"), lanes)
        ep_samples = metrics.pop("ep_samples")
        if wcfg.exhaustive_se:
            # Every lane's records: rows flattened as the episode records
            # are, so a row index names the same episode in both.
            if lanes is not None:
                ep_samples = M.gather_episodes(ep_samples, 1)
            ep_samples = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                          for k, v in ep_samples.items()}
            if logging_host:
                se_map = _exhaustive_side_effects(ep_samples, bundle,
                                                  env_cfg, generator)
                collector.side_effects_fn = \
                    lambda lane, info: se_map.get(int(lane))
        elif lanes is not None:
            ep_samples = _gather_samples(ep_samples)
        # The other ranks keep the curricula's view of the episodes
        # without logging them.
        collector.observe(episodes,
                          batch_steps=steps_per_iter * iters_per_chunk,
                          record_only=not logging_host)
        n = pstate.num_steps
        bundle.training_logger.cumulative_stats["training_steps"] = n

        # Live lanes pin the slots they are on: one [B] readback a chunk.
        bundle.pool_manager.refresh(
            pool_refresh, in_use=np.unique(ws.env.level_idx.cpu().numpy()))

        if ckpt:
            # ``pool`` is the pool this chunk's lanes stepped on (before
            # the refresh): a resume pairs them again.
            _save_checkpoint(ckpt, n, pstate, ws, pool,
                             dict(bundle.training_logger.cumulative_stats),
                             lanes)

        if n >= next_report:
            next_report = (n // report_interval + 1) * report_interval
            _report(bundle, pstate, metrics, ep_samples, se_map, generator,
                    n / max(time.time() - t0, 1e-9))

        if bundle.validation_levels and n >= next_test:
            next_test = (n // test_interval + 1) * test_interval
            if logging_host:
                run_validation(model, bundle, data_dir, generator,
                               device=dev)
            M.barrier()
        if lanes is not None:
            M.sync_generator(generator)

    if ckpt:
        _save_checkpoint(ckpt, pstate.num_steps, pstate, ws, pool,
                         dict(bundle.training_logger.cumulative_stats),
                         lanes, force=True)
    return model, pstate


def _report_dqn(bundle, dstate, metrics):
    """One DQN report: the log line with the parameters' ``pcheck``, and
    the scalars to the training logger."""
    n = dstate.num_steps
    m = {k: float(v) for k, v in metrics.items()}
    logger.info("n=%d: loss=%.3g eps=%.3f q=%.3g pcheck=%.17g", n,
                m["loss"], m["epsilon"], m["q_model_mean"],
                _pcheck(dstate.model))
    if M.is_logging_host():
        bundle.training_logger.log_scalars(m, n, "dqn")


def train_dqn(bundle, total_steps=6e6, batch_size=32, seed=0,
              data_dir=None, report_interval=None,
              checkpoint_interval=100_000, device="cuda"):
    """Train DQN to ``total_steps`` env steps on ``device``, where the
    bundle's pool lives. Returns (model, dqn_state).

    A unit is ``optimize_interval // batch_size`` (at least 1) steps of
    ``batch_size`` lanes, then one optimizer step once the replay is
    warm; a chunk is 32 units. After each chunk the finished episodes are
    logged, the pool refreshed (2 levels at most, never a slot a live lane
    is on), a checkpoint saved when due (no replay: a resume re-warms it)
    and at the report interval a report made. The env step applies no
    side-effect penalty or exit-difficulty schedule, as in the JAX
    package. With ``data_dir`` the run resumes from its latest checkpoint
    and saves at the end.
    """
    dev = resolve_device(device)
    lanes = _rank_lanes(batch_size)
    cfg = build_config(dqn.DQNConfig, "dqn")
    if report_interval is None:
        report_interval = cfg.report_interval
    env_cfg, wcfg = bundle.env_cfg, bundle.wrapper_cfg
    generator = torch.Generator(device=dev).manual_seed(seed)
    with torch.random.fork_rng(
            devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        model, obs_shape, obs_dtype = build_model(bundle, "dqn", device=dev)
    pool = bundle.pool_manager.pool
    # One n-step ring per flattened lane x agent slot, in the env's
    # observation form.
    local = batch_size if lanes is None else lanes.size
    dstate = dqn.init_dqn_state(
        cfg, model, local * pool.num_agents, obs_shape, obs_dtype,
        device=dev)
    ws, obs = W.reset(env_cfg, wcfg, pool, batch_size, device=dev,
                      lanes=lanes)
    ckpt = data_dir and CheckpointManager(
        data_dir, interval=checkpoint_interval)
    if ckpt:
        ws, robs, extra, _ = _restore_latest(ckpt, dstate, ws, bundle, dev)
        if robs is not None:
            obs = robs
            pool = bundle.pool_manager.pool
        if extra:
            bundle.training_logger.cumulative_stats.update(extra)

    collector = EpisodeCollector(
        bundle.training_logger,
        level_meta=bundle.pool_manager.level_meta())
    chunk = max(cfg.optimize_interval // batch_size, 1)
    iters_per_chunk = 32
    next_report = report_interval
    while dstate.num_steps < total_steps:
        pool = bundle.pool_manager.pool
        dstate, ws, obs, metrics = dqn.train_chunk(
            env_cfg, wcfg, cfg, pool, dstate, ws, obs, generator, chunk,
            iters_per_chunk, device=dev, lanes=lanes)
        episodes = _episode_records(metrics.pop("episodes"), lanes)
        collector.observe(episodes,
                          batch_steps=chunk * batch_size * iters_per_chunk,
                          record_only=not M.is_logging_host())
        n = dstate.num_steps
        bundle.training_logger.cumulative_stats["training_steps"] = n
        bundle.pool_manager.refresh(
            2, in_use=np.unique(ws.env.level_idx.cpu().numpy()))
        if ckpt:
            # The chunk's own (pre-refresh) pool: the saved env state's
            # lanes resume against the levels they are mid-episode on.
            _save_checkpoint(ckpt, n, dstate, ws, pool,
                             dict(bundle.training_logger.cumulative_stats),
                             lanes)
        if n >= next_report:
            next_report = (n // report_interval + 1) * report_interval
            _report_dqn(bundle, dstate, metrics)
    if ckpt:
        _save_checkpoint(ckpt, dstate.num_steps, dstate, ws, pool,
                         dict(bundle.training_logger.cumulative_stats),
                         lanes, force=True)
    return model, dstate


def run_validation(model, bundle, data_dir, generator, device="cuda"):
    """One episode on each validation level, side effects included, logged
    to ``validation-log.json`` in ``data_dir`` (with a recorded episode when
    there is a ``data_dir``). Returns the summary."""
    resolve_device(device)
    vlogger = SafeLifeLogger(data_dir, episode_type="validation")
    _, summary = runner.benchmark(
        model, bundle.validation_levels,
        num_episodes=len(bundle.validation_levels),
        env_cfg=bundle.env_cfg, generator=generator,
        side_effect_weights=bundle.side_effect_weights,
        data_logger=vlogger, record_videos=bool(data_dir), device=device)
    logger.info("validation: %s", summary)
    return summary


def run_benchmark(model, bundle, data_dir, generator, num_episodes=1000,
                  device="cuda"):
    """The final benchmark sweep (reference ``start-training.py:276-285``):
    ``num_episodes`` episodes over the benchmark levels, logged to
    ``benchmark-data.json`` in ``data_dir``. Tasks with no frozen benchmark
    archive are evaluated on their validation levels. Returns the summary.
    """
    resolve_device(device)
    levels = bundle.benchmark_levels or bundle.validation_levels
    blogger = SafeLifeLogger(data_dir, episode_type="benchmark")
    _, summary = runner.benchmark(
        model, levels, num_episodes=num_episodes, env_cfg=bundle.env_cfg,
        generator=generator,
        side_effect_weights=bundle.side_effect_weights,
        data_logger=blogger, device=device)
    logger.info("benchmark: %s", summary)
    if data_dir:
        summarize_run(data_dir)
    return summary
