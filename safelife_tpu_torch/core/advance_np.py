"""Host-side (NumPy) mirror of the CA advance rule.

Port of ``safelife_tpu/core/advance_np.py:1-84`` (own copy; the port never
imports the JAX package). Identical semantics to
:mod:`safelife_tpu_torch.core.advance` (and therefore the reference C
kernel), vectorized in NumPy for host code that must not touch the device:
level packing (``env.state.goals_are_static``) and stability checks.
"""

import numpy as np

from . import cells as C


def _nb_sum(x):
    r = x + np.roll(x, 1, axis=-1) + np.roll(x, -1, axis=-1)
    return r + np.roll(r, 1, axis=-2) + np.roll(r, -1, axis=-2)


def _nb_or(x):
    r = x | np.roll(x, 1, axis=-1) | np.roll(x, -1, axis=-1)
    return r | np.roll(r, 1, axis=-2) | np.roll(r, -1, axis=-2)


def advance_board_np(board, rng=None, spawn_prob=0.3):
    """One physics step on the host. board: int array (H, W) or batched.

    With ``rng`` None the step is deterministic (spawners never fire) —
    exactly correct for spawner-free boards. With an ``rng``, spawn draws
    consume the generator stream exactly like the reference C kernel (one
    draw per eligible cell in raster order), so host-side games reproduce
    reference trajectories bit-for-bit under the same seed.
    """
    board = np.asarray(board).astype(np.int64)
    m = board | ((board & C.DESTRUCTIBLE) << 5)
    alive = m & 1
    packed = (
        alive
        | (((m >> 8) & alive) << 5)
        | (((m >> 9) & alive) << 10)
        | (((m >> 10) & alive) << 15)
        | (((m >> 11) & alive) << 20)
    )
    s = _nb_sum(packed)
    count = s & 31
    cons_destr = np.where(((s >> 5) & 31) >= 2, C.DESTRUCTIBLE, 0)
    cons_colors = (
        np.where(((s >> 10) & 31) >= 2, C.COLOR_R, 0)
        | np.where(((s >> 15) & 31) >= 2, C.COLOR_G, 0)
        | np.where(((s >> 20) & 31) >= 2, C.COLOR_B, 0)
    )
    spawner = (m >> C.SPAWNING_BIT) & 1
    orv = (m & (C.PRESERVING | C.INHIBITING | C.SPAWNING)) \
        | ((m & C.COLORS) * spawner)
    orred = _nb_or(orv)
    cons_colors |= orred & C.COLORS

    is_alive = (board & C.ALIVE) != 0
    frozen = (board & C.FROZEN) != 0
    preserved = (orred & C.PRESERVING) != 0
    inhibited = (orred & C.INHIBITING) != 0
    spawn_nbr = (orred & C.SPAWNING) != 0

    survives = frozen | preserved | (count == 3) | (count == 4)
    live_out = np.where(survives, board, 0)

    newborn = C.ALIVE | cons_colors | cons_destr
    spawned = C.ALIVE | C.DESTRUCTIBLE | cons_colors
    do_spawn = np.zeros(board.shape, bool)
    if rng is not None:
        # Stream-exact spawn draws: the C kernel consumes one next_double
        # per *eligible* cell in raster order (advance_board.c:96-124);
        # ``rng.random(k)`` consumes the identical generator stream, so
        # the host engine reproduces reference trajectories bit-for-bit
        # under the same seed (verified vs the built C engine in
        # tests/test_c_engine_parity.py).
        eligible = (~is_alive) & (~frozen) & (~inhibited) \
            & (count != 3) & spawn_nbr
        draws = rng.random(int(eligible.sum()))
        do_spawn[eligible] = draws < float(np.float32(spawn_prob))
    dead_out = np.where(
        frozen | inhibited, board,
        np.where(count == 3, newborn,
                 np.where(spawn_nbr & do_spawn, spawned, board)))
    return np.where(is_alive, live_out, dead_out)
