"""Side-effect telemetry, validation and the final benchmark of a run.

Port of part of ``safelife_tpu/training/train.py``:
``_sampled_side_effects`` (``:76-103``), ``_exhaustive_side_effects``
(``:106-139``), ``_summarize_se_map`` (``:142-151``), ``run_validation``
(``:576-585``) and ``run_benchmark`` (``:588-604``). The training loop
(``train_ppo``), its resume logic and the CLI need the level generator,
which is not ported yet.

Where the JAX package takes (``model``, ``params``, ``key``), these take
the network, which holds its parameters, and a ``torch.Generator``.
"""

import logging

import numpy as np
import torch

from ..loggers import SafeLifeLogger, summarize_run
from ..side_effects import side_effect_score, weighted_side_effect_total
from ..utils.device import resolve_device
from . import runner

logger = logging.getLogger(__name__)

#: Occupancy steps of the training-time side-effect telemetry.
TELEMETRY_SAMPLES = 1000


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
