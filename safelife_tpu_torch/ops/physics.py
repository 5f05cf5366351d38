"""K1 and K2: the per-step physics kernels and their plain versions.

Port of ``safelife_tpu/ops/physics.py``:

* K1 ``fused_actions_advance`` (``:296-350``, kernel ``_physics_kernel``
  ``:262-293``): per board, the agents' actions in agent order, one CA
  step, and a readback of each agent's post-advance cell. CUDA source
  ``csrc/physics.cu``.
* K2 ``advance`` (``advance_pallas`` ``:371-395``, kernel
  ``_advance_kernel`` ``:353-368``): one CA step on a batch of boards.
  CUDA source ``csrc/advance.cu``.

Each wrapper launches a CUDA kernel for tensors on a CUDA device and runs
its plain version (``*_plain``, built from :mod:`..core`) for tensors on
the CPU; there is no other route. Boards of any shape are taken, those
smaller than 4x4 included. Up to ``MAX_CELLS`` cells, both kernels stage
blocks of several boards in shared memory and run the CA step of
``csrc/ca.cuh`` there; :func:`launch_shape` picks the block layout from the
board shape and the batch. Larger boards take the tiled form of the same
sources (``physics_tiled_kernel``, ``advance_tiled_kernel``; launch-count
keys ``*_global``): a block stages one tile of one board with a one-cell
halo ring and runs the same CA step on it; :func:`tile_shape` picks the
tiles. The JAX package routes by board shape too
(``safelife_tpu/ops/physics.py:78``). :mod:`._build` counts the launches
of each form.

Randomness: the stochastic spawn coin of cell ``i`` on board ``lane`` is
the first word of Philox4x32-10 at counter ``(i + cell_offset,
lane + lane_offset, 0, 0)`` (mod 2**32) under the two seed words as key;
both offsets default to 0. A rank that holds global lanes ``[s, s + b)`` of
a sharded batch passes ``lane_offset = s``, so its boards draw the coins of
the same lanes of the whole batch; the row-sharded advance of
:mod:`..parallel.spatial` passes K2 a ``cell_offset`` that puts a halo slab
at its board's global cells. Its top 24 bits give a float32 uniform
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

#: Largest board the staged kernels take. A block stages the raw board and
#: one packed word a cell in shared memory (8 bytes a cell), so a board of
#: MAX_CELLS needs 96 KB; above 48 KB a kernel opts in to more. Larger
#: boards take the tiled form.
MAX_CELLS = 12288
SMEM_BYTES_PER_CELL = 8
#: Shared memory a block of the H100 may use after opting in (232,448 B).
MAX_SMEM_BYTES = 227 * 1024
_DEFAULT_SMEM_BYTES = 48 * 1024
_MAX_THREADS = 1024
#: Widest tile of the tiled forms: wider boards are cut into columns of
#: tiles too.
TILE_MAX_COLS = 128
#: Fewest blocks a tiled launch cuts its boards into while it can: two an
#: SM of the H100.
_TILE_MIN_BLOCKS = 2 * 132
#: Threads the tiled walk aims to spread a batch over: fewer than the
#: staged forms' target, since a tile's walkers also read its halo rows
#: (192x192 boards at B = 64 walk 16 rows a thread, the fastest of
#: ``chip_sweep.py large``'s layouts; PERF.md).
_TILE_TARGET_THREADS = 147456
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
    staged K1/K2 launch (boards of at most ``MAX_CELLS`` cells).

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
    return (best, rows, block_threads(h, w, best, rows),
            best * h * w * SMEM_BYTES_PER_CELL)


def tile_smem_bytes(rows, cols):
    """Shared bytes of a staged tile of ``rows`` x ``cols`` cells and its
    packed words (``csrc/ca.cuh::tile_smem_bytes``): rows + 2 rows of
    cols + 5 words each (the halo ring and a 16-byte aligned start),
    rounded up to 16 bytes. K1 adds ``csrc/physics.cu``'s
    ``TILE_WORDS_PER_AGENT`` (29) words an agent."""
    return 2 * (rows + 2) * ((cols + 8) & ~3) * 4


@functools.lru_cache(maxsize=64)
def tile_shape(h, w, batch):
    """(tile_rows, tile_cols, rows_per_thread, threads, shared bytes) of a
    tiled K1/K2 launch (boards above ``MAX_CELLS`` cells).

    Columns: the fewest tiles of at most ``TILE_MAX_COLS`` columns across
    the board, their width rounded up to 4 columns (16-byte copies) but
    never past W. Rows a thread walks: at least 4, and as many as cut the
    batch's columns into about ``_TILE_TARGET_THREADS`` walks (as
    :func:`launch_shape` does for its target). The tile's height is a
    multiple k of those rows, k the largest that keeps the launch at
    ``_TILE_MIN_BLOCKS`` blocks or more (tiles x batch), the block within
    1024 threads (one a column, rounded up to whole warps, by k) and the
    staged tile within the default 48 KB of shared memory
    (:func:`tile_smem_bytes`); k = 1 where none does. Tiles of the last
    row or column may be smaller.
    192x192 boards at B = 64 give tiles of 48 x 96 cells, 16 rows a thread,
    288 threads and 41,600 bytes.
    """
    nx = -(-w // TILE_MAX_COLS)
    cols = min(w, -(-w // (4 * nx)) * 4)
    segments = max(1, round(_TILE_TARGET_THREADS / (max(batch, 1) * w)))
    rows = min(h, max(_MIN_ROWS, -(-h // segments)))
    pad = -(-cols // 32) * 32
    tile = rows
    for k in range(2, _MAX_THREADS // pad + 1):
        r = min(h, k * rows)
        if (tile_smem_bytes(r, cols) > _DEFAULT_SMEM_BYTES
                or -(-h // r) * nx * batch < _TILE_MIN_BLOCKS):
            break
        tile = r
        if r == h:
            break
    return (tile, cols, rows, pad * -(-tile // rows),
            tile_smem_bytes(tile, cols))


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


def philox_bits(seed, batch, cells, lane_offset=0, cell_offset=0):
    """int64[batch, cells] in [0, 2**32): the spawn bits of every cell of
    every board for the int32[2] ``seed`` (counter (cell + cell_offset,
    lane + lane_offset, 0, 0), each word mod 2**32)."""
    dev = seed.device
    key = seed.to(torch.int64) & _U32
    cell = (torch.arange(cells, dtype=torch.int64, device=dev)
            + cell_offset)[None, :] & _U32
    lane = (torch.arange(batch, dtype=torch.int64, device=dev)
            + lane_offset)[:, None] & _U32
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    x0, _, _, _ = philox4x32((cell, lane, zero, zero), (key[0], key[1]))
    return x0.expand(batch, cells)


def spawn_coins(seed, spawn_prob, batch, cells, lane_offset=0,
                cell_offset=0):
    """bool[batch, cells]: the spawn coin flips the kernels draw."""
    u = (philox_bits(seed, batch, cells, lane_offset, cell_offset) >> 8).to(
        torch.float32) * (1.0 / (1 << 24))
    return u < spawn_prob.to(torch.float32)[:, None]


def _check(name, board, h, w, device):
    if board.dim() != 2 or board.shape[1] != h * w:
        raise ValueError("%s: board must be [B, H*W] = [B, %d], got %s"
                         % (name, h * w, tuple(board.shape)))
    if device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (name, device))


def _require(name, tensor, dtype, shape, device):
    if tensor.dtype != dtype or tuple(tensor.shape) != tuple(shape) \
            or tensor.device != device or not tensor.is_contiguous():
        raise ValueError(
            "%s: expected a contiguous %s tensor of shape %s on %s, got %s "
            "%s on %s" % (name, dtype, tuple(shape), device, tensor.dtype,
                          tuple(tensor.shape), tensor.device))


def _int32(name, x):
    """A counter offset as a C int; the kernels add it in 32 bits."""
    x = int(x)
    if not -2 ** 31 <= x < 2 ** 31:
        raise ValueError("%s %d does not fit 32 bits" % (name, x))
    return x


# ---------------------------------------------------------------------------
# K1


def fused_actions_advance_plain(board, agent_locs, actions, spawn_prob, seed,
                                *, h, w, stochastic, lane_offset=0):
    """Plain version of K1: ``core.actions.execute_actions``, then the CA
    step with the Philox coins, then ``scoring.agent_cells``."""
    b = board.shape[0]
    grid, locs = AC.execute_actions(board.reshape(b, h, w), agent_locs,
                                    actions)
    if stochastic:
        coins = spawn_coins(seed, spawn_prob, b, h * w,
                            lane_offset).reshape(b, h, w)
    else:
        coins = torch.zeros_like(grid, dtype=torch.bool)
    grid = ADV.advance_board_given_spawns(grid, coins)
    return grid.reshape(b, h * w), locs, scoring.agent_cells(grid, locs)


def fused_actions_advance(board, agent_locs, actions, spawn_prob, seed,
                          *, h, w, stochastic, lane_offset=0):
    """Fused actions + CA advance + agent-cell readback over a batch.

    board int32[B, H*W]; agent_locs int32[B, A, 2] (row, col); actions
    int32[B, A] (padded agents must be 0); spawn_prob float32[B]; seed
    int32[2]; ``lane_offset``: the global index of board 0 in the coins'
    counter. Returns (board int32[B, H*W], agent_locs int32[B, A, 2],
    cells int32[B, A]).
    """
    dev = board.device
    _check("fused_actions_advance", board, h, w, dev)
    if dev.type == "cpu":
        return fused_actions_advance_plain(
            board, agent_locs, actions, spawn_prob, seed,
            h=h, w=w, stochastic=stochastic, lane_offset=lane_offset)
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
    inputs = (board.data_ptr(), agent_locs.data_ptr(), actions.data_ptr(),
              spawn_prob.data_ptr(), seed.data_ptr())
    outputs = (out_board.data_ptr(), out_locs.data_ptr(),
               out_cells.data_ptr())
    if h * w > MAX_CELLS:
        tr, tc, rows, threads, _ = tile_shape(h, w, b)
        _build.launch("sl_fused_actions_advance_global", dev, *inputs,
                      *outputs, b, h, w, a, tr, tc, rows, threads,
                      int(bool(stochastic)),
                      _int32("lane_offset", lane_offset))
    else:
        bpb, rows, threads, _ = launch_shape(h, w, b)
        _build.launch("sl_fused_actions_advance", dev, *inputs, *outputs,
                      b, h, w, a, bpb, rows, threads, int(bool(stochastic)),
                      _int32("lane_offset", lane_offset))
    return out_board, out_locs, out_cells


# ---------------------------------------------------------------------------
# K2


def advance_plain(board, spawn_prob, seed, *, h, w, stochastic,
                  lane_offset=0, cell_offset=0):
    """Plain version of K2: the CA step of ``core.advance`` with the
    Philox coins."""
    b = board.shape[0]
    grid = board.reshape(b, h, w)
    if stochastic:
        coins = spawn_coins(seed, spawn_prob, b, h * w, lane_offset,
                            cell_offset).reshape(b, h, w)
    else:
        coins = torch.zeros_like(grid, dtype=torch.bool)
    return ADV.advance_board_given_spawns(grid, coins).reshape(b, h * w)


def advance(board, spawn_prob, seed, *, h, w, stochastic, lane_offset=0,
            cell_offset=0):
    """One batched CA step (no agents). board int32[B, H*W]; spawn_prob
    float32[B]; seed int32[2] → int32[B, H*W]. Cell ``i`` of board ``lane``
    draws its coin at counter (i + cell_offset, lane + lane_offset)."""
    dev = board.device
    _check("advance", board, h, w, dev)
    if dev.type == "cpu":
        return advance_plain(board, spawn_prob, seed, h=h, w=w,
                             stochastic=stochastic, lane_offset=lane_offset,
                             cell_offset=cell_offset)
    b = board.shape[0]
    _require("board", board, torch.int32, (b, h * w), dev)
    _require("spawn_prob", spawn_prob, torch.float32, (b,), dev)
    _require("seed", seed, torch.int32, (2,), dev)
    out = torch.empty_like(board)
    args = (board.data_ptr(), spawn_prob.data_ptr(), seed.data_ptr(),
            out.data_ptr(), b, h, w)
    offsets = (_int32("lane_offset", lane_offset),
               _int32("cell_offset", cell_offset))
    if h * w > MAX_CELLS:
        tr, tc, rows, threads, _ = tile_shape(h, w, b)
        _build.launch("sl_advance_global", dev, *args, tr, tc, rows,
                      threads, int(bool(stochastic)), *offsets)
    else:
        bpb, rows, threads, _ = launch_shape(h, w, b)
        _build.launch("sl_advance", dev, *args, bpb, rows, threads,
                      int(bool(stochastic)), *offsets)
    return out
