"""K1 and K2: the per-step physics kernels and their plain versions.

Port of ``safelife_tpu/ops/physics.py``:

* K1 ``fused_actions_advance`` (``:296-350``, kernel ``_physics_kernel``
  ``:262-293``): per board, the agents' actions in agent order, one CA
  step, and a readback of each agent's post-advance cell. CUDA source
  ``csrc/physics.cu``.
* K2 ``advance`` (``advance_pallas`` ``:371-395``, kernel
  ``_advance_kernel`` ``:353-368``): one CA step on a batch of boards.
  CUDA source ``csrc/advance.cu``.

Each wrapper launches its CUDA kernel for tensors on a CUDA device and
runs its plain version (``*_plain``, built from :mod:`..core`) for tensors
on the CPU; there is no other route. ``launches`` on each wrapper counts
its kernel launches. Both kernels run the CA step of ``csrc/ca.cuh`` on
blocks of several boards; :func:`launch_shape` picks the block layout from
the board shape and the batch. Boards of any shape up to ``MAX_CELLS``
are taken, those smaller than 4x4 included.

Randomness: the stochastic spawn coin of cell ``i`` on board ``lane`` is
the first word of Philox4x32-10 at counter ``(i, lane, 0, 0)`` under the
two seed words as key; its top 24 bits give a float32 uniform
``u = (bits >> 8) * 2**-24`` and the cell spawns when ``u < spawn_prob``
(float32), as the Pallas kernel compares at ``:279-282``. The plain
versions compute the same bits with int64 tensor arithmetic
(:func:`philox_bits`), so kernel and plain version agree bit for bit.
The bits differ from the TPU's on-core generator.
"""

import functools

import torch

from ..core import actions as AC, advance as ADV, scoring
from . import _build

#: Philox4x32 multipliers and Weyl key increments (Salmon et al., 2011).
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF

#: Largest board the kernels take. A block stages the raw board and one
#: packed word a cell in shared memory (8 bytes a cell), so a board of
#: MAX_CELLS needs 96 KB; above 48 KB a kernel opts in to more.
MAX_CELLS = 12288
SMEM_BYTES_PER_CELL = 8
#: Shared memory a block of the H100 may use after opting in (232,448 B).
MAX_SMEM_BYTES = 227 * 1024
_DEFAULT_SMEM_BYTES = 48 * 1024
_MAX_THREADS = 1024
_MAX_BOARDS_PER_BLOCK = 32
#: Threads the CA walk aims to spread a batch over: about three quarters of
#: the 132 x 2048 an H100 holds at once. Fewer leave the walk, a chain of
#: dependent shared-memory reads, bound by latency (measured on the card,
#: PERF.md, PR 2).
_TARGET_THREADS = 196608
#: Fewest rows a thread walks: each walk also reads the two rows above its
#: first, so shorter walks spend more on those.
_MIN_ROWS = 4


def block_threads(h, w, boards, rows):
    """Threads of a K1/K2 block of ``boards`` h x w boards whose columns
    are walked in segments of ``rows`` rows: one a segment, rounded up to
    whole warps, at most 1024 (beyond that the threads loop)."""
    walkers = boards * w * -(-h // rows)
    return min(_MAX_THREADS, -(-walkers // 32) * 32)


@functools.lru_cache(maxsize=64)
def launch_shape(h, w, batch):
    """(boards_per_block, rows_per_thread, threads, shared bytes) of a
    K1/K2 launch.

    One thread walks each column of each board in the CA step, or, when
    the batch has too few columns to keep the card busy, each segment of
    ``rows_per_thread`` rows of one (at least 4 rows; the segments of a
    column aim at ``_TARGET_THREADS`` threads in all). A block of n boards
    then wants n * W * segments threads; n is the smallest count up to 32
    that wastes the fewest lanes of its warps while the block stays within
    1024 threads and the default 48 KB of shared memory (one board may
    exceed either: its threads then loop, and the kernel opts in to more
    shared memory). Never more boards than the batch holds. 26x26 boards
    at B = 4096 give 8 boards a block of 416 threads walking 13 rows each,
    and 43 KB.
    """
    segments = max(1, round(_TARGET_THREADS / (max(batch, 1) * w)))
    rows = max(_MIN_ROWS, -(-h // segments))
    walkers = w * -(-h // rows)     # threads one board wants

    best, best_used = 1, 0.0
    for n in range(1, min(_MAX_BOARDS_PER_BLOCK, batch) + 1):
        if n > 1 and (n * walkers > _MAX_THREADS or
                      n * h * w * SMEM_BYTES_PER_CELL > _DEFAULT_SMEM_BYTES):
            break
        used = min(n * walkers, _MAX_THREADS) / block_threads(h, w, n, rows)
        if used > best_used + 1e-9:
            best, best_used = n, used
    smem = best * h * w * SMEM_BYTES_PER_CELL
    if smem > MAX_SMEM_BYTES:
        raise ValueError("%dx%d boards need %d bytes of shared memory a "
                         "block, above the card's %d" % (h, w, smem,
                                                         MAX_SMEM_BYTES))
    return best, rows, block_threads(h, w, best, rows), smem


def _mulhilo(m, x):
    """(hi, lo) 32-bit words of ``m * x`` for a 32-bit constant ``m`` and
    int64 ``x`` in [0, 2**32), without overflowing int64."""
    p_lo = (x & 0xFFFF) * m
    p_hi = (x >> 16) * m
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (t >> 32)) & _U32, t & _U32


def philox4x32(ctr, key):
    """Philox4x32-10 on int64 tensors holding uint32 values.

    ctr: four broadcastable int64 tensors; key: two int64 values or
    tensors. Returns the four output words.
    """
    x0, x1, x2, x3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _U32
            k1 = (k1 + _PHILOX_W1) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M0, x0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    return x0, x1, x2, x3


def philox_bits(seed, batch, cells):
    """int64[batch, cells] in [0, 2**32): the spawn bits of every cell of
    every board for the int32[2] ``seed`` (counter (cell, lane, 0, 0))."""
    dev = seed.device
    key = seed.to(torch.int64) & _U32
    cell = torch.arange(cells, dtype=torch.int64, device=dev)[None, :]
    lane = torch.arange(batch, dtype=torch.int64, device=dev)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    x0, _, _, _ = philox4x32((cell, lane, zero, zero), (key[0], key[1]))
    return x0.expand(batch, cells)


def spawn_coins(seed, spawn_prob, batch, cells):
    """bool[batch, cells]: the spawn coin flips the kernels draw."""
    u = (philox_bits(seed, batch, cells) >> 8).to(torch.float32) \
        * (1.0 / (1 << 24))
    return u < spawn_prob.to(torch.float32)[:, None]


def _check(name, board, h, w, device):
    if board.dim() != 2 or board.shape[1] != h * w:
        raise ValueError("%s: board must be [B, H*W] = [B, %d], got %s"
                         % (name, h * w, tuple(board.shape)))
    if h * w > MAX_CELLS:
        raise ValueError("%s: %dx%d boards exceed the kernel's %d cells"
                         % (name, h, w, MAX_CELLS))
    if device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (name, device))


def _require(name, tensor, dtype, shape, device):
    if tensor.dtype != dtype or tuple(tensor.shape) != tuple(shape) \
            or tensor.device != device or not tensor.is_contiguous():
        raise ValueError(
            "%s: expected a contiguous %s tensor of shape %s on %s, got %s "
            "%s on %s" % (name, dtype, tuple(shape), device, tensor.dtype,
                          tuple(tensor.shape), tensor.device))


# ---------------------------------------------------------------------------
# K1


def fused_actions_advance_plain(board, agent_locs, actions, spawn_prob, seed,
                                *, h, w, stochastic):
    """Plain version of K1: ``core.actions.execute_actions``, then the CA
    step with the Philox coins, then ``scoring.agent_cells``."""
    b = board.shape[0]
    grid, locs = AC.execute_actions(board.reshape(b, h, w), agent_locs,
                                    actions)
    if stochastic:
        coins = spawn_coins(seed, spawn_prob, b, h * w).reshape(b, h, w)
    else:
        coins = torch.zeros_like(grid, dtype=torch.bool)
    grid = ADV.advance_board_given_spawns(grid, coins)
    return grid.reshape(b, h * w), locs, scoring.agent_cells(grid, locs)


def fused_actions_advance(board, agent_locs, actions, spawn_prob, seed,
                          *, h, w, stochastic):
    """Fused actions + CA advance + agent-cell readback over a batch.

    board int32[B, H*W]; agent_locs int32[B, A, 2] (row, col); actions
    int32[B, A] (padded agents must be 0); spawn_prob float32[B]; seed
    int32[2]. Returns (board int32[B, H*W], agent_locs int32[B, A, 2],
    cells int32[B, A]).
    """
    dev = board.device
    _check("fused_actions_advance", board, h, w, dev)
    if dev.type == "cpu":
        return fused_actions_advance_plain(
            board, agent_locs, actions, spawn_prob, seed,
            h=h, w=w, stochastic=stochastic)
    b = board.shape[0]
    a = agent_locs.shape[1]
    _require("board", board, torch.int32, (b, h * w), dev)
    _require("agent_locs", agent_locs, torch.int32, (b, a, 2), dev)
    _require("actions", actions, torch.int32, (b, a), dev)
    _require("spawn_prob", spawn_prob, torch.float32, (b,), dev)
    _require("seed", seed, torch.int32, (2,), dev)
    out_board = torch.empty_like(board)
    out_locs = torch.empty_like(agent_locs)
    out_cells = torch.empty((b, a), dtype=torch.int32, device=dev)
    bpb, rows, threads, _ = launch_shape(h, w, b)
    _build.launch(
        "sl_fused_actions_advance", dev,
        board.data_ptr(), agent_locs.data_ptr(), actions.data_ptr(),
        spawn_prob.data_ptr(), seed.data_ptr(), out_board.data_ptr(),
        out_locs.data_ptr(), out_cells.data_ptr(), b, h, w, a, bpb, rows,
        threads, int(bool(stochastic)))
    fused_actions_advance.launches += 1
    return out_board, out_locs, out_cells


fused_actions_advance.launches = 0


# ---------------------------------------------------------------------------
# K2


def advance_plain(board, spawn_prob, seed, *, h, w, stochastic):
    """Plain version of K2: the CA step of ``core.advance`` with the
    Philox coins."""
    b = board.shape[0]
    grid = board.reshape(b, h, w)
    if stochastic:
        coins = spawn_coins(seed, spawn_prob, b, h * w).reshape(b, h, w)
    else:
        coins = torch.zeros_like(grid, dtype=torch.bool)
    return ADV.advance_board_given_spawns(grid, coins).reshape(b, h * w)


def advance(board, spawn_prob, seed, *, h, w, stochastic):
    """One batched CA step (no agents). board int32[B, H*W]; spawn_prob
    float32[B]; seed int32[2] → int32[B, H*W]."""
    dev = board.device
    _check("advance", board, h, w, dev)
    if dev.type == "cpu":
        return advance_plain(board, spawn_prob, seed, h=h, w=w,
                             stochastic=stochastic)
    b = board.shape[0]
    _require("board", board, torch.int32, (b, h * w), dev)
    _require("spawn_prob", spawn_prob, torch.float32, (b,), dev)
    _require("seed", seed, torch.int32, (2,), dev)
    out = torch.empty_like(board)
    bpb, rows, threads, _ = launch_shape(h, w, b)
    _build.launch("sl_advance", dev, board.data_ptr(), spawn_prob.data_ptr(),
                  seed.data_ptr(), out.data_ptr(), b, h, w, bpb, rows,
                  threads, int(bool(stochastic)))
    advance.launches += 1
    return out


advance.launches = 0
