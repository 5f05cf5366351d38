"""Board partitioning and fencing for procedural generation.

Port of ``safelife_tpu/procgen/regions.py:1-180`` (the port's own copy,
NumPy only): the same draws from the same generator, so equal seeds give
equal regions and fences.

Behavioral parity targets in the reference (distribution-level, not
draw-for-draw — the reference samples from Python ``set`` iteration
order, so no exact draw sequence is even defined):

* :func:`make_partitioned_regions` — ``proc_gen.py:44-110``: stochastic
  region growth on a torus, one cell at a time, with a 2-cell separation
  rule between regions and a Dirichlet-process-style choice between
  growing an existing region and seeding a new one.
* :func:`build_fence` — ``proc_gen.py:113-167``: wall off a region so no
  cell outside it can ever be born from cells inside.
* :func:`make_lattice` — ``proc_gen.py:234-238``.

The implementation here is array-based: frontier and exclusion sets are
boolean planes indexed per region, cells are drawn by masked index
sampling, and the separation test reads a wrapped 5x5 window directly.
"""

import numpy as np

from ..utils.rng import get_rng

#: 4-neighborhood offsets (region growth is edge-connected).
_CROSS = np.array([(-1, 0), (1, 0), (0, -1), (0, 1)])


def _wrapped_window(arr, y, x, radius):
    """A (2r+1, 2r+1) toroidal window of ``arr`` centered at (y, x)."""
    idx = np.arange(-radius, radius + 1)
    return arr[np.ix_((y + idx) % arr.shape[0], (x + idx) % arr.shape[1])]


def _ring_counts(window, member):
    """For each cell of the central 3x3 block of a 5x5 boolean ``member``
    plane, count members among its 8 ring neighbors."""
    padded = member.astype(np.int16)
    # Sliding 3x3 sums over the 5x5 plane -> 3x3 of block totals.
    sums = sum(
        padded[1 + dy:4 + dy, 1 + dx:4 + dx]
        for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return sums - padded[1:4, 1:4]


def _sample_true(rng, plane):
    """Uniformly sample the flat index of one True cell of ``plane``."""
    flat = np.flatnonzero(plane)
    return flat[rng.integers(len(flat))]


def make_partitioned_regions(shape, alpha=1.0, max_regions=5, min_regions=2):
    """Partition a wrapped board into distinct, well-separated regions.

    Returns an int array: 0 marks buffer cells between regions, k >= 1
    marks region k's cells. Any two distinct regions are always at least
    two cells apart, so their patterns cannot interact.
    """
    rng = get_rng()
    h, w = shape
    board = np.zeros(shape, dtype=np.int16)

    # Plane 0 is the global seeding frontier (all unassigned cells at
    # first); plane k >= 1 is region k's growth frontier. ``tried`` marks
    # cells already attempted (and rejected or taken) per plane.
    frontiers = [np.ones(shape, dtype=bool)]
    tried = [np.zeros(shape, dtype=bool)]

    while True:
        counts = np.array([f.sum() for f in frontiers], dtype=float)
        if counts.sum() == 0:
            break
        # Seeding weight: alpha-capped while new regions are allowed,
        # suppressed once max_regions exist; existing regions are
        # suppressed until min_regions exist.
        counts[0] = (min(alpha, counts[0])
                     if len(frontiers) <= max_regions else 1e-10)
        if len(frontiers) <= min_regions:
            counts[1:] = 1e-10
        k = rng.choice(len(frontiers), p=counts / counts.sum())
        if not frontiers[k].any():
            # A suppressed-but-empty plane can still be drawn with
            # epsilon weight; just redraw.
            continue

        flat = _sample_true(rng, frontiers[k])
        y, x = flat // w, flat % w
        frontiers[0].flat[flat] = False
        frontiers[k].flat[flat] = False
        if tried[k][y, x]:
            continue
        tried[0][y, x] = True
        tried[k][y, x] = True

        label = k if k else len(frontiers)  # seeding creates a new label
        win = _wrapped_window(board, y, x, 2).copy()
        win[2, 2] = label
        occupied = _ring_counts(win, win != 0)
        foreign_n = _ring_counts(win, (win != 0) & (win != label))
        # Separation rule: the candidate may not touch a foreign region,
        # and no nearby cell may simultaneously neighbor a foreign region
        # and more than two occupied cells (enough to interact under the
        # CA rules).
        if foreign_n[1, 1] > 0 or \
                ((foreign_n > 0) & (occupied > 2)).any():
            continue

        if k == 0:
            frontiers.append(np.zeros(shape, dtype=bool))
            tried.append(np.zeros(shape, dtype=bool))
        board[y, x] = label
        for dy, dx in _CROSS:
            ny, nx = (y + dy) % h, (x + dx) % w
            if board[ny, nx] == 0:
                frontiers[label][ny, nx] = True
    return board


def _neighbor_sums(plane):
    """Toroidal 3x3 (self-included) sums of an integer plane."""
    out = plane.copy()
    out += np.roll(plane, 1, axis=1) + np.roll(plane, -1, axis=1)
    return out + np.roll(out, 1, axis=0) + np.roll(out, -1, axis=0)


def build_fence(mask, shuffle=True):
    """Wall off the masked region so nothing inside can escape.

    A cell outside the region can only ever be born if it has three live
    neighbors, so it suffices that every outside cell near the region
    boundary keeps fewer than three unfenced region neighbors. Greedy
    construction, then greedy relaxation:

    1. walk the region's edge cells (shuffled); fence any whose removal
       is still needed (an adjacent outside cell sees >= 3 region cells);
    2. walk the placed fence cells (shuffled); unfence any that turned
       out redundant (every adjacent outside count would stay < 3).
    """
    rng = get_rng()
    mask = np.asarray(mask, dtype=bool)
    h, w = mask.shape
    offs = np.mgrid[-1:2, -1:2].reshape(2, 9)

    inside_counts = _neighbor_sums(mask.astype(np.int32))
    # Outside cells' view of how many (unfenced) region cells they see.
    exposure = inside_counts * ~mask
    # Edge cells: region cells with any non-region cell in their block.
    edge = mask & (inside_counts < 9)
    fence = np.zeros(mask.shape, dtype=np.int32)

    def block(y, x):
        return (y + offs[0]) % h, (x + offs[1]) % w

    def walk(cells):
        ys, xs = np.nonzero(cells)
        if shuffle and len(ys):
            order = rng.permutation(len(ys))
            ys, xs = ys[order], xs[order]
        return zip(ys, xs)

    for y, x in walk(edge):
        ny, nx = block(y, x)
        if (exposure[ny, nx] >= 3).any():
            exposure[ny, nx] -= 1
            fence[y, x] = 1

    for y, x in walk(fence > 0):
        ny, nx = block(y, x)
        if (exposure[ny, nx] < 2).all():
            exposure[ny, nx] += 1
            fence[y, x] = 0

    return fence


def make_lattice(h, w, col_skip, row_skip, stagger):
    """Periodic lattice mask used for tree grids."""
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    return (rows % row_skip < 1) & (
        (cols + (rows // row_skip) * stagger) % col_skip < 1)
