"""Annealed still-life / oscillator generation.

Port of ``safelife_tpu/procgen/pattern.py:1-287`` (the port's own copy):
``gen_pattern``, ``wrapped_label``, the exceptions, ``_pre_evolve`` and the
Python annealer ``_wrapped_label_python`` / ``_gen_pattern_python``.

``gen_pattern`` parity target: the reference binding
(``speedups_src/module.c:290-417``) — given a board and a mask of mutable
cells, grow a violation-free pattern (still life, or period-p oscillator)
by simulated annealing. The hot loop runs in the native C++ annealer
(:mod:`safelife_tpu_torch.native`). The pure-Python annealer of the same
algorithm runs only when asked (``native=False``, or
``SAFELIFE_TPU_TORCH_NO_NATIVE`` set): it draws another random stream, so
it never stands in for a native build that failed.

Mask bits (parity ``gen_board.h:8-12``): NEW_CELL=1 (cell may be changed),
CAN_OSCILLATE=2, INCLUDE_VIOLATIONS=4 (violations at this cell count and are
actively repaired).
"""

import numpy as np

from .. import native as native_lib
from ..core import cells as C
from ..utils.rng import get_rng

NEW_CELL_MASK = 1
CAN_OSCILLATE_MASK = 2
INCLUDE_VIOLATIONS_MASK = 4


class BoardGenException(Exception):
    pass


class MaxIterException(BoardGenException):
    pass


class InsufficientAreaException(BoardGenException):
    pass


_CELL_TYPES = (0, C.FROZEN, C.ALIVE | C.DESTRUCTIBLE, C.FROZEN | C.ALIVE)


def _pre_evolve(board, period):
    """Stack of `period` layers: layer k+1 = deterministic advance(layer k).

    Uses the full advance rule (colors and all), matching the reference
    binding's pre-evolution (module.c:374-378)."""
    from ..core.advance_np import advance_board_np

    layers = np.empty((period,) + board.shape, np.uint16)
    layers[0] = board
    cur = board.astype(np.int64)
    for k in range(1, period):
        cur = advance_board_np(cur)
        layers[k] = cur.astype(np.uint16)
    return layers


def gen_pattern(board, mask, period=1, seeds=None, max_iter=40,
                min_fill=0.2, temperature=0.5, osc_bonus=0.3,
                alive=(0., 0.), wall=(100., 100.), tree=(100., 100.),
                rng=None, native=None):
    """Generate a pattern into ``board`` under ``mask``. Returns a new board.

    Raises MaxIterException when annealing fails to converge and
    InsufficientAreaException when the mask has no usable area. ``native``
    picks the annealer (default: :func:`..native.requested`).
    """
    rng = rng or get_rng()
    board = np.ascontiguousarray(board, np.uint16)
    mask = np.ascontiguousarray(mask, np.int32)
    if seeds is None:
        seeds = mask
    seeds = np.ascontiguousarray(seeds, np.int32)
    if board.ndim != 2 or board.shape != mask.shape:
        raise ValueError("board/mask shape mismatch")
    if board.shape[0] < 3 or board.shape[1] < 3:
        raise ValueError("Board must be at least 3x3.")
    if period <= 0:
        raise ValueError("Pattern period must be larger than 0.")

    penalties = np.array(
        [0., 0., wall[0], wall[1], alive[0], alive[1], tree[0], tree[1]],
        np.float64)
    layers = _pre_evolve(board, period)
    seed = int(rng.integers(0, 2**63))

    if not (native_lib.requested() if native is None else native):
        return _gen_pattern_python(
            layers, mask, seeds, max_iter, min_fill, temperature,
            osc_bonus, penalties, np.random.default_rng(seed))

    lib = native_lib.load()
    layers = np.ascontiguousarray(layers)
    err = lib.sl_gen_pattern(
        layers.ctypes.data, mask.ctypes.data, seeds.ctypes.data,
        int(period), board.shape[0], board.shape[1],
        float(max_iter), float(min_fill), float(temperature),
        float(osc_bonus), penalties.ctypes.data, seed)
    _raise_for(err)
    return layers[0].copy()


def _raise_for(err):
    if err == 0:
        return
    if err == -1:
        raise MaxIterException("Max-iter hit. Aborting!")
    if err == -3:
        raise InsufficientAreaException(
            "The unmasked area was too small to generate a pattern.")
    raise BoardGenException("error %d" % err)


def wrapped_label(data, native=None):
    """Connected-component labels with toroidal wrap (8-connectivity).

    Parity: ``speedups_src/wrapped_label.c``. Returns (labels, num_labels).
    ``native`` as in :func:`gen_pattern`.
    """
    data = np.ascontiguousarray(np.asarray(data) != 0, np.int32)
    labels = np.zeros_like(data, np.int32)

    if not (native_lib.requested() if native is None else native):
        return _wrapped_label_python(data)
    lib = native_lib.load()
    n = lib.sl_wrapped_label(
        data.ctypes.data, labels.ctypes.data, *data.shape)
    return labels, n


# ---------------------------------------------------------------------------
# The Python annealer (slow; only when asked for, and in tests)


def _wrapped_label_python(data):
    rows, cols = data.shape
    parent = list(range(rows * cols))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if not data[r, c]:
                continue
            rm, cm, cp = (r - 1) % rows, (c - 1) % cols, (c + 1) % cols
            for nr, nc in ((rm, cm), (rm, c), (rm, cp), (r, cm)):
                if data[nr, nc]:
                    ra, rb = find(i), find(nr * cols + nc)
                    if ra != rb:
                        parent[rb] = ra
    labels = np.zeros_like(data, np.int32)
    names = {}
    for r in range(rows):
        for c in range(cols):
            if data[r, c]:
                root = find(r * cols + c)
                labels[r, c] = names.setdefault(root, len(names) + 1)
    return labels, len(names)


def _gen_pattern_python(layers, mask, seeds, max_iter, min_fill,
                        temperature, osc_bonus, penalties, rng):
    """Direct Python implementation of the annealing loop (tiny boards)."""
    period, rows, cols = layers.shape
    board = layers.astype(np.int64)
    size = rows * cols

    def nbr_counts():
        out = np.zeros_like(board)
        for p in range(period):
            a = board[p] & 1
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    out[p] += np.roll(np.roll(a, dr, 0), dc, 1)
        return out

    def osc_summary():
        dead = (board & 1 == 0).any(axis=0)
        alive = (board & 1 == 1).any(axis=0)
        return dead * 1 + alive * 2

    def violations():
        first, last = board[0], board[-1]
        n = nbr_counts()[-1]
        v = np.where(
            last & C.FROZEN, (last != first).astype(int),
            np.where(last & 1,
                     ((n == 3) | (n == 4)) != (first & 1 == 1),
                     (n == 3) != (first & 1 == 1)).astype(int))
        v = np.where(first & C.FROZEN, 0, v)
        v += ((osc_summary() == 3)
              & ((mask & CAN_OSCILLATE_MASK) == 0)).astype(int)
        return v

    def evolve_from_layer0():
        for p in range(1, period):
            b1 = board[p - 1]
            n = np.zeros_like(b1)
            a = b1 & 1
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    n += np.roll(np.roll(a, dr, 0), dc, 1)
            board[p] = np.where(
                b1 & C.FROZEN, b1,
                np.where(b1 & 1,
                         np.where((n == 3) | (n == 4), b1, 0),
                         np.where(n == 3, 1, b1)))

    unmasked = np.nonzero((mask.reshape(-1) & NEW_CELL_MASK) > 0)[0]
    total_area = len(unmasked)
    if total_area == 0:
        raise InsufficientAreaException("no unmasked area")
    min_fill_abs = min_fill * total_area
    flat_mask = mask.reshape(-1)
    seed_set = set(np.nonzero(seeds.reshape(-1))[0].tolist())

    for it in range(int(max_iter * total_area * period)):
        v = violations().reshape(-1)
        bad = np.nonzero((v > 0) & (flat_mask & INCLUDE_VIOLATIONS_MASK > 0))[0]
        flat0 = board[0].reshape(-1)
        not_empty = int(((flat0 != 0) & (flat_mask & NEW_CELL_MASK > 0)).sum())
        if len(bad) == 0 and not_empty >= min_fill_abs:
            return board[0].astype(np.uint16)

        if len(bad):
            k0 = int(rng.choice(bad))
        elif seed_set:
            k0 = int(rng.choice(sorted(seed_set)))
        else:
            k0 = int(rng.choice(unmasked))
        seed_set.discard(k0)
        r0, c0 = divmod(k0, cols)

        totals = np.zeros(4, int)
        sel = flat_mask & NEW_CELL_MASK > 0
        pal_idx = (((flat0 & 1) > 0) * 2 + ((flat0 & C.FROZEN) > 0)).astype(int)
        for j in range(4):
            totals[j] = int(((pal_idx == j) & sel).sum())
        pen = np.zeros(4)
        t = not_empty / min_fill_abs if min_fill_abs else 1.0
        pen[0] = 2.0 if t < 0.9 else 20 * (1 - t) if t < 1 else 0.0
        for j in range(1, 4):
            tt = totals[j] / (not_empty + 1.0)
            pen[j] = penalties[2 * j] + tt * (
                penalties[2 * j + 1] - penalties[2 * j])

        base_viol = int(violations().sum())
        base_osc = int((osc_summary() == 3).sum())
        cands = []
        for r in range(r0 - period, r0 + period + 1):
            for c in range(c0 - period, c0 + period + 1):
                rr, cc = r % rows, c % cols
                i1 = rr * cols + cc
                if not flat_mask[i1] & NEW_CELL_MASK:
                    continue
                cur = board[0, rr, cc]
                for cell in _CELL_TYPES:
                    if cell == (cur & (C.FROZEN | 1 | C.DESTRUCTIBLE)):
                        continue
                    save = board[0, rr, cc]
                    board[0, rr, cc] = cell
                    evolve_from_layer0()
                    dv = int(violations().sum()) - base_viol
                    do = int((osc_summary() == 3).sum()) - base_osc
                    pj = (((cell & 1) > 0) * 2 + ((cell & C.FROZEN) > 0))
                    lp = -(dv - osc_bonus * do + pen[pj]) / temperature
                    cands.append((lp, i1, cell))
                    board[0, rr, cc] = save
                    evolve_from_layer0()
        if not cands:
            continue
        lps = np.array([x[0] for x in cands])
        probs = np.exp(lps - lps.max())
        probs /= probs.sum()
        k = int(rng.choice(len(cands), p=probs))
        _, i1, cell = cands[k]
        board[0].reshape(-1)[i1] = cell
        evolve_from_layer0()
    raise MaxIterException("Max-iter hit. Aborting!")
