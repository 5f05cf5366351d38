"""Cross-level batched level generation on the run's device.

Port of ``safelife_tpu/procgen/batched.py``: ``_DEFAULTS`` (``:50-52``),
``_pack_group`` (``:55-87``), ``_anneal_group`` (``:107-124``) and
``gen_games_batched`` (``:127-168``).

N levels generate in lockstep. Each level runs as a generator
(:func:`.generate.gen_game_requests`) that yields its anneal requests;
one round collects the requests of every level still in flight, groups
them by (board shape, period), answers each group with one call of the
device annealer (:mod:`.anneal_device`, one chain a request) and resumes
the generators. The host work between rounds (regions, fences,
decoration) stays per-level NumPy, each level on its own NumPy stream, so
it does not depend on the batch's composition; the chains draw from one
``torch.Generator``. The levels match the host generator's in
distribution, not draw for draw.

The JAX package pads each group's lanes to a bucket of 8/32/128/512 so
that XLA compiles few shapes (``batched.py:90-104``). Torch compiles
nothing per shape, so the port anneals each group at its own size.
"""

import numpy as np
import torch

from ..utils.rng import set_rng
from . import anneal_device as AD
from .generate import gen_game_requests

_DEFAULTS = dict(max_iter=40.0, min_fill=0.2, temperature=0.5,
                 osc_bonus=0.3, alive=(0.0, 0.0), wall=(100.0, 100.0),
                 tree=(100.0, 100.0))


def _pack_group(requests):
    """Stack one round's (board, flags, seeds, params) requests into the
    annealer's arrays, with ``gen_pattern``'s parameter defaults."""
    boards = np.stack([np.asarray(b, np.int32) for b, _, _, _ in requests])
    flags = np.stack([np.asarray(f, np.int32) for _, f, _, _ in requests])
    # gen_pattern's seed default: any nonzero mask flag marks a seed cell.
    seeds = np.stack([(np.asarray(f if s is None else s) != 0)
                      for _, f, s, _ in requests])

    def col(name):
        return np.array([float(p.get(name, _DEFAULTS[name]))
                         for _, _, _, p in requests], np.float32)

    max_fill = np.array([
        float(p.get("max_fill", 2.0 * float(p.get("min_fill",
                                                  _DEFAULTS["min_fill"]))))
        for _, _, _, p in requests], np.float32)
    pen = np.stack([
        np.concatenate([[0.0, 0.0],
                        np.asarray(p.get("wall", _DEFAULTS["wall"]),
                                   np.float32),
                        np.asarray(p.get("alive", _DEFAULTS["alive"]),
                                   np.float32),
                        np.asarray(p.get("tree", _DEFAULTS["tree"]),
                                   np.float32)])
        for _, _, _, p in requests]).astype(np.float32)
    params = dict(min_fill=col("min_fill"), max_fill=max_fill,
                  max_iter=col("max_iter"), temperature=col("temperature"),
                  osc_bonus=col("osc_bonus"), penalties=pen)
    return boards, flags, seeds, params


def _anneal_group(requests, period, generator, device):
    """Answer one round's same-shape, same-period requests with one call
    of the device annealer on ``device``. Returns the annealed boards,
    each in the dtype of its request's board."""
    boards, flags, seeds, params = _pack_group(requests)
    params = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    params["period"] = period
    out, _ = AD.anneal_with_retries_batched(
        torch.from_numpy(boards).to(device),
        torch.from_numpy(flags).to(device),
        torch.from_numpy(seeds).to(device), params, generator)
    out = out.cpu().numpy()
    return [o.astype(np.asarray(b).dtype)
            for o, (b, _, _, _) in zip(out, requests)]


def gen_games_batched(param_dicts, rngs, generator):
    """Generate ``len(param_dicts)`` levels, annealing on the device of
    ``generator``.

    param_dicts: one ``gen_game`` parameter dict a level (a parsed
    ``random/*.yaml``). rngs: one ``np.random.Generator`` a level, for its
    host segments (regions, the parameter DSL, decoration). generator:
    the ``torch.Generator`` of the annealing chains, on the device they
    run on.

    Returns a list of :class:`~safelife_tpu_torch.io.levels.Level`.
    """
    n = len(param_dicts)
    gens = [None] * n
    results = [None] * n
    pending = {}
    for i in range(n):
        with set_rng(rngs[i]):
            g = gen_game_requests(**param_dicts[i])
            try:
                pending[i] = next(g)
                gens[i] = g
            except StopIteration as stop:
                results[i] = stop.value

    while pending:
        groups = {}
        for i, (board, _, _, params) in pending.items():
            key = (board.shape, int(params.get("period", 1)))
            groups.setdefault(key, []).append(i)
        new_pending = {}
        for (_, period), idxs in sorted(groups.items()):
            answers = _anneal_group([pending[i] for i in idxs], period,
                                    generator, generator.device)
            for i, ans in zip(idxs, answers):
                with set_rng(rngs[i]):
                    try:
                        new_pending[i] = gens[i].send(ans)
                    except StopIteration as stop:
                        results[i] = stop.value
        pending = new_pending
    return results
