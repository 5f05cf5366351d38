"""The cellular-automaton physics step on batched int32 tensors.

Port of ``safelife_tpu/core/advance.py:53-240`` (``pack_counters``,
``stats_from_aggregates``, ``neighborhood_stats``, ``apply_rule``,
``advance_board_given_spawns``, ``spawn_eligible``, fast ``advance_board``,
``advance_board_deterministic`` and ``advance_board_nstep``),
``:243-264`` (``advance_board_oracle``, on the reference's own NumPy
generator: :mod:`.pcg64`) and ``:267-290`` (``life_occupancy``). Up to
``advance_board`` this is the plain CA: the plain version of the K2
kernel's body (``ops/csrc/ca.cuh``) and what the CPU path runs.
``advance_board_nstep`` and ``life_occupancy`` take one K2 launch
(``ops.advance``) a step, under seed words drawn once by the caller.

The rule (reference ``advance_board.c:94-124``) in terms of the toroidal
3x3 neighbourhood, self included: ``count`` alive cells; the OR of the
PRESERVING/INHIBITING/SPAWNING flags; consensus colours and
destructibility where at least two alive cells carry them (the destructible
bit is copied onto bit 8 first, so alive EXIT cells count toward
destructibility, as the C kernel does); spawner colours OR'd into the
consensus colours.
"""

import torch

from . import cells as C


def _nb_sum(x):
    """Sum of the 3x3 neighbourhood (self included) with toroidal wrap."""
    r = x + torch.roll(x, 1, dims=-1) + torch.roll(x, -1, dims=-1)
    return r + torch.roll(r, 1, dims=-2) + torch.roll(r, -1, dims=-2)


def _nb_or(x):
    """Bitwise OR over the 3x3 neighbourhood (self included), wrapped."""
    r = x | torch.roll(x, 1, dims=-1) | torch.roll(x, -1, dims=-1)
    return r | torch.roll(r, 1, dims=-2) | torch.roll(r, -1, dims=-2)


def pack_counters(board):
    """(packed, orv): five 5-bit counters (alive, destructible-or-exit,
    r, g, b, each only for alive cells) in one int32 for a single
    neighbourhood sum, and the flags plus spawner colours for the OR."""
    m = board | ((board & C.DESTRUCTIBLE) << 5)
    alive = m & 1
    packed = (
        alive
        | (((m >> 8) & alive) << 5)
        | (((m >> 9) & alive) << 10)
        | (((m >> 10) & alive) << 15)
        | (((m >> 11) & alive) << 20)
    )
    spawner = (m >> C.SPAWNING_BIT) & 1
    orv = (m & (C.PRESERVING | C.INHIBITING | C.SPAWNING)) \
        | ((m & C.COLORS) * spawner)
    return packed, orv


def _flag(cond, value):
    return cond.to(torch.int32) * value


def stats_from_aggregates(s, orred):
    """Unpack neighbourhood (sum, OR) aggregates into the rule's inputs."""
    count = s & 31
    consensus_colors = (
        _flag(((s >> 10) & 31) >= 2, C.COLOR_R)
        | _flag(((s >> 15) & 31) >= 2, C.COLOR_G)
        | _flag(((s >> 20) & 31) >= 2, C.COLOR_B)
        | (orred & C.COLORS)
    )
    consensus_destructible = _flag(((s >> 5) & 31) >= 2, C.DESTRUCTIBLE)
    flags = orred & (C.PRESERVING | C.INHIBITING | C.SPAWNING)
    return count, flags, consensus_colors, consensus_destructible


def neighborhood_stats(board):
    """(count, flags, consensus_colors, consensus_destructible) per cell."""
    packed, orv = pack_counters(board)
    return stats_from_aggregates(_nb_sum(packed), _nb_or(orv))


def apply_rule(board, stats, spawn_lt):
    """The SafeLife update rule given neighbourhood stats and the per-cell
    spawn coin flips ``spawn_lt`` (bool, consulted only where eligible)."""
    count, flags, cons_colors, cons_destr = stats
    alive = (board & C.ALIVE) != 0
    frozen = (board & C.FROZEN) != 0
    preserved = (flags & C.PRESERVING) != 0
    inhibited = (flags & C.INHIBITING) != 0
    spawn_nbr = (flags & C.SPAWNING) != 0

    survives = frozen | preserved | (count == 3) | (count == 4)
    live_out = torch.where(survives, board, torch.zeros_like(board))

    newborn = C.ALIVE | cons_colors | cons_destr
    spawned = C.ALIVE | C.DESTRUCTIBLE | cons_colors
    dead_out = torch.where(
        frozen | inhibited, board,
        torch.where(count == 3, newborn,
                    torch.where(spawn_nbr & spawn_lt, spawned, board)))
    return torch.where(alive, live_out, dead_out)


def advance_board_given_spawns(board, spawn_lt):
    """One physics step with externally supplied spawn coin flips."""
    return apply_rule(board, neighborhood_stats(board), spawn_lt)


def advance_board_deterministic(board):
    """One physics step assuming no spawner fires (exact for spawner-free
    boards, where no draw is consumed)."""
    return advance_board_given_spawns(
        board, torch.zeros(board.shape, dtype=torch.bool,
                           device=board.device))


def spawn_eligible(board, stats=None):
    """Cells for which the reference kernel consumes one random draw: dead,
    not frozen, no inhibiting neighbour, count != 3, a spawning neighbour
    (``advance_board.c:96-124``). ``stats`` are the board's
    :func:`neighborhood_stats`, computed here when not given."""
    count, flags, _, _ = stats or neighborhood_stats(board)
    alive = (board & C.ALIVE) != 0
    frozen = (board & C.FROZEN) != 0
    inhibited = (flags & C.INHIBITING) != 0
    spawn_nbr = (flags & C.SPAWNING) != 0
    return (~alive) & (~frozen) & (~inhibited) & (count != 3) & spawn_nbr


def advance_board(board, spawn_prob, generator):
    """One physics step in fast mode: an independent float32 uniform per
    cell from ``generator``, compared with the float32 ``spawn_prob``
    (scalar or one per leading batch entry). The kernels draw their
    uniforms from Philox instead (``ops.physics``)."""
    u = torch.rand(board.shape, generator=generator, dtype=torch.float32,
                   device=board.device)
    thresh = torch.as_tensor(spawn_prob, dtype=torch.float32,
                             device=board.device)
    if thresh.ndim > 0:
        thresh = thresh[..., None, None]
    return advance_board_given_spawns(board, u < thresh)


def _flat_batch(board, spawn_prob):
    """(boards int32 [B, H*W], spawn_prob float32 [B], h, w) for
    ``ops.advance`` from boards [..., H, W] and a spawn probability that
    broadcasts to their leading dims."""
    h, w = board.shape[-2:]
    flat = board.reshape(-1, h * w).contiguous()
    sp = torch.as_tensor(spawn_prob, dtype=torch.float32, device=board.device)
    sp = sp.expand(board.shape[:-2]).reshape(-1).contiguous()
    return flat, sp, h, w


def advance_board_nstep(board, spawn_prob, seeds, stochastic=True):
    """Advance ``len(seeds)`` physics steps, returning the final board
    (reference ``advance_board.c:128-149``). Step ``t`` is one
    ``ops.advance`` (K2 on CUDA, its plain version on the CPU) under the
    seed words ``seeds[t]``.

    board int32 [..., H, W]; spawn_prob a float or float32 broadcastable to
    the leading dims; seeds int32 [n_steps, 2] on the board's device. With
    ``stochastic=False`` spawners never fire (exact on spawner-free boards).
    """
    from .. import ops

    flat, sp, h, w = _flat_batch(board, spawn_prob)
    for seed in seeds:
        flat = ops.advance(flat, sp, seed, h=h, w=w, stochastic=stochastic)
    return flat.reshape(board.shape)


def advance_board_oracle(board, rng, spawn_prob):
    """One physics step in oracle mode: the spawn draws come from the
    NumPy generator ``rng`` (PCG64) in raster order, so the step equals
    the reference C kernel's under the same generator state, and leaves
    ``rng`` where the C kernel leaves it.

    board int32 [H, W], a single board (the oracle is sequential, as in
    the JAX package) on any device; spawn_prob a float. Returns the new
    board; one host sync (the eligible count).
    """
    from .pcg64 import raster_spawn_draws

    stats = neighborhood_stats(board)
    spawns = raster_spawn_draws(spawn_eligible(board, stats), rng,
                                spawn_prob)
    return apply_rule(board, stats, spawns)


#: ``cell & _FREE_LIFE_KEY`` is ``ALIVE | color << COLOR_BIT`` exactly when
#: the cell is free life (alive, not agent, exit or frozen) of that colour.
_FREE_LIFE_KEY = C.ALIVE | C.AGENT | C.EXIT | C.FROZEN | C.COLORS


def life_occupancy(board, spawn_prob, seeds, stochastic=True):
    """Advance ``len(seeds)`` steps as :func:`advance_board_nstep`,
    counting for every cell and colour how many of the advanced boards had
    free life of that colour there: alive and not agent, exit or frozen
    (reference ``life_occupancy`` + ``accumulate_cell_types``,
    ``advance_board.c:153-189``).

    Returns int32 [..., H, W, 8].
    """
    from .. import ops

    flat, sp, h, w = _flat_batch(board, spawn_prob)
    targets = C.ALIVE | (torch.arange(8, dtype=torch.int32,
                                      device=board.device) << C.COLOR_BIT)
    acc = torch.zeros(flat.shape + (8,), dtype=torch.int32,
                      device=board.device)
    for seed in seeds:
        flat = ops.advance(flat, sp, seed, h=h, w=w, stochastic=stochastic)
        acc += (flat & _FREE_LIFE_KEY)[..., None] == targets
    return acc.reshape(board.shape + (8,))
