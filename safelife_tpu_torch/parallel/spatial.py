"""One board split row-wise over the ranks: the halo-exchange CA advance.

Port of ``safelife_tpu/parallel/spatial.py``. Rank r of R holds rows
``[r HL, (r+1) HL)`` of an H x W board (``HL = H / R``). Each step the
ranks exchange a one-row halo: every rank all-gathers its first and last
row (a [2, W] tensor) and takes the last row of the rank before it and the
first row of the rank after it, around the ring, so the toroidal wrap
falls out of the ring. That is JAX's ``ppermute`` pair as one all-gather,
which ``gloo`` and ``nccl`` both take for CUDA tensors (``gloo`` has no
send or receive for them). The rank then advances the [HL + 2, W] slab.

* :func:`advance_sharded_given_spawns` applies the plain CA of
  :mod:`..core.advance` (``pack_counters``, ``stats_from_aggregates``,
  ``apply_rule``) to the slab with JAX's ``_nb_sum_slab`` and
  ``_nb_or_slab``, under the caller's spawn coins: plain torch, as JAX's is
  plain XLA.
* :func:`advance_sharded` runs kernel K2 on the slab. K2 wraps rows
  toroidally, but rows 1..HL of the slab read only rows 0..HL+1, so they
  are exact; the first and last rows are dropped. With ``cell_offset =
  (r HL - 1) W`` the slab's rows draw the spawn coins of the same cells of
  the whole board, so the sharded stochastic step equals K2's step of the
  whole board bit for bit (JAX's sharded stream, a shard-local fold of the
  key, matches no unsharded step). Slabs above ``ops.physics.MAX_CELLS``
  take K2's global-memory form.

The ranks are those of the default process group; one process is a ring
of one, whose halos are its own last and first rows.
"""

import torch
import torch.distributed as dist

from .. import ops
from ..core import advance as ADV
from . import mesh as M


def _nb_sum_slab(x):
    """3x3 neighbourhood sum over a halo slab [HL+2, W] -> [HL, W]: the
    horizontal wrap is local, the vertical neighbours come from the halo
    rows."""
    r = x + torch.roll(x, 1, dims=-1) + torch.roll(x, -1, dims=-1)
    return r[..., :-2, :] + r[..., 1:-1, :] + r[..., 2:, :]


def _nb_or_slab(x):
    r = x | torch.roll(x, 1, dims=-1) | torch.roll(x, -1, dims=-1)
    return r[..., :-2, :] | r[..., 1:-1, :] | r[..., 2:, :]


def _rank_world():
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _slab(rows):
    """[HL+2, W]: the rank's rows between the previous rank's last row and
    the next rank's first row (toroidal over the ring)."""
    rank, world = _rank_world()
    if world == 1:
        top, bottom = rows[-1:], rows[:1]
    else:
        edges = M.all_gather(torch.stack([rows[0], rows[-1]]))
        top = edges[(rank - 1) % world][1:]
        bottom = edges[(rank + 1) % world][:1]
    return torch.cat([top, rows, bottom])


def advance_sharded_given_spawns(rows, spawn_lt):
    """One CA step of the rank's rows int32 [HL, W] of a row-sharded board
    under the spawn coins bool [HL, W] of the same rows."""
    packed, orv = ADV.pack_counters(_slab(rows))
    stats = ADV.stats_from_aggregates(_nb_sum_slab(packed), _nb_or_slab(orv))
    return ADV.apply_rule(rows, stats, spawn_lt)


def advance_sharded(rows, seed, spawn_prob, stochastic=True):
    """One CA step (K2) of the rank's rows int32 [HL, W] of a row-sharded
    board, spawn coins under the seed words int32 [2] at ``spawn_prob``
    (float). Equals rows ``[r HL, (r+1) HL)`` of ``ops.advance`` of the
    whole board under the same seed words."""
    rank, _ = _rank_world()
    hl, w = rows.shape
    slab = _slab(rows)
    prob = torch.full((1,), float(spawn_prob), dtype=torch.float32,
                      device=rows.device)
    out = ops.advance(slab.reshape(1, -1).contiguous(), prob, seed,
                      h=hl + 2, w=w, stochastic=stochastic,
                      cell_offset=(rank * hl - 1) * w)
    return out.reshape(hl + 2, w)[1:-1]


def advance_sharded_nstep(rows, seeds, spawn_prob, stochastic=True):
    """``len(seeds)`` sharded K2 steps, step i under the seed words
    ``seeds[i]`` (int32 [n, 2]): one halo exchange and one launch a
    step."""
    for seed in seeds:
        rows = advance_sharded(rows, seed, spawn_prob, stochastic)
    return rows
