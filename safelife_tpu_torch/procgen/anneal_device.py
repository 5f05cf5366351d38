"""Device-batched pattern annealing: N regions annealed in lockstep on the
run's device.

Port of ``safelife_tpu/procgen/anneal_jax.py``: the mask bits and palette
(``:38-45``), ``_count3x3`` (``:50-53``), ``_alive_planes`` (``:56-65``),
``_violations`` (``:68-86``), ``_palette_index`` (``:89-90``),
``_window_still_violations`` (``:93-109``), ``_lane_candidates``
(``:112-167``), ``_osc_count`` (``:170-176``), ``anneal_batch``
(``:179-300``) and ``anneal_with_retries_batched`` (``:303-350``).

The host annealer (``native/annealer.cpp``) runs one region at a time.
Here every quantity of an iteration (violation maps, candidate deltas,
the Boltzmann pick) is a whole-batch tensor operation over the lanes, one
chain a lane, with no per-lane Python loop. As in the JAX package the
chain carries layer 0 only: the alive planes of layers 1..p-1 are a pure
function of it and the frozen bits, and are recomputed each iteration.
The rules (reference ``speedups_src/gen_board.c:316-510``): a cell
violates where the advance of the last layer does not give back the
first (self-inclusive 3x3 count, survive on {3, 4}, birth on 3, frozen
cells inert), plus one where it oscillates but may not; the site is a
uniform pick among violating cells, then the remaining seeds, then any
writable cell; the move a Boltzmann pick among the other palette types of
every writable cell of the site's (2p+1)^2 neighbourhood.

Draws come from an explicit ``torch.Generator`` on the boards' device: a
uniform argmax for the site and Gumbel-max (uniforms clamped below at
1e-20, as ``jax.random.uniform(minval=1e-20)``) for the move. They are not
JAX's stream, so the levels match the JAX package's in distribution, not
draw for draw. The helpers are exact: integer counts, and float32 deltas
of integer sums.

JAX's ``lax.while_loop`` tests ``any(active)`` before every iteration. On
a card that test is a host sync an iteration, so :func:`anneal_batch`
tests it every :data:`CHECK_EVERY` iterations instead: lanes that are done
or over their budget are masked out of every update, so the extra
iterations change no board. An iteration is some 150 small tensor
operations; on a card the blocks of iterations between two tests replay
one CUDA graph, captured on the chains' first run and replayed by every
rung of the retry ladder, so that the host does not launch each of them.
"""

import torch

from ..core import cells as C

NEW_CELL_MASK = 1
CAN_OSCILLATE_MASK = 2
INCLUDE_VIOLATIONS_MASK = 4

#: Palette, indexed by ``alive·2 + frozen``: empty, wall, life, tree.
CELL_TYPES = (0, C.FROZEN, C.ALIVE | C.DESTRUCTIBLE, C.FROZEN | C.ALIVE)

_NEG = -1e30  # -inf stand-in that survives arithmetic

#: Iterations between two tests of whether any lane is still annealing:
#: one host sync each. A chain runs some hundreds to thousands of
#: iterations (its budget is 40 x area x period), so 32 wastes at most
#: 31 masked iterations at the end of a call while the syncs cost a few
#: percent of the loop at most.
CHECK_EVERY = 32


def _count3x3(a):
    """Self-inclusive wrapped 3x3 count of ``a`` (int32 [..., H, W])."""
    r = a + torch.roll(a, 1, -2) + torch.roll(a, -1, -2)
    return r + torch.roll(r, 1, -1) + torch.roll(r, -1, -1)


def _alive_planes(alive0, frozen0, period):
    """Alive planes of the layer stack (period entries, layer 0 first)."""
    planes = [alive0]
    for _ in range(period - 1):
        prev = planes[-1]
        n = _count3x3(prev.to(torch.int32))
        nxt = torch.where(frozen0, prev,
                          torch.where(prev, (n == 3) | (n == 4), n == 3))
        planes.append(nxt)
    return planes


def _violations(board0, can_osc, period):
    """Per-cell violation counts (int32 [..., H, W]): the advance of the
    last layer must give back the first, frozen cells are inert, and
    oscillation where ``can_osc`` forbids it adds one."""
    alive0 = (board0 & C.ALIVE) > 0
    frozen0 = (board0 & C.FROZEN) > 0
    planes = _alive_planes(alive0, frozen0, period)
    last = planes[-1]
    n = _count3x3(last.to(torch.int32))
    predicted = torch.where(last, (n == 3) | (n == 4), n == 3)
    v = (predicted ^ alive0).to(torch.int32)
    if period > 1:
        stack = torch.stack(planes)
        osc = stack.any(0) & (~stack).any(0)
        v = v + (osc & ~can_osc).to(torch.int32)
    return torch.where(frozen0, 0, v)


def _palette_index(cell):
    """``alive·2 + frozen`` of int32 cells (the :data:`CELL_TYPES`
    index)."""
    return ((cell & C.ALIVE) << 1) | ((cell >> C.FROZEN_BIT) & 1)


def _window_still_violations(win):
    """Still-life violations over the interior (1..5)^2 of 7x7 windows
    [..., 7, 7]: int32 [..., 5, 5], equal to :func:`_violations` of the
    board at those cells, whose 3x3 neighbourhoods lie in the window."""
    alive = ((win & C.ALIVE) > 0).to(torch.int32)
    frozen = (win & C.FROZEN) > 0
    r = alive[..., :-2, :] + alive[..., 1:-1, :] + alive[..., 2:, :]
    n = r[..., :-2] + r[..., 1:-1] + r[..., 2:]
    a = alive[..., 1:-1, 1:-1].bool()
    predicted = torch.where(a, (n == 3) | (n == 4), n == 3)
    v = (predicted ^ a).to(torch.int32)
    return torch.where(frozen[..., 1:-1, 1:-1], 0, v)


def _osc_count(board0, period):
    """Cells that oscillate over the layer stack, per board (int32
    [...])."""
    if period == 1:
        return torch.zeros(board0.shape[:-2], dtype=torch.int32,
                           device=board0.device)
    alive0 = (board0 & C.ALIVE) > 0
    frozen0 = (board0 & C.FROZEN) > 0
    stack = torch.stack(_alive_planes(alive0, frozen0, period))
    return (stack.any(0) & (~stack).any(0)).sum((-2, -1)).to(torch.int32)


def candidate_tables(h, w, period, device):
    """The index tables of :func:`_lane_candidates` on an h x w board:
    ``pos`` int64 [H*W, P], each site's (2p+1)^2 neighbourhood in raster
    order (wrapped), and for still lifes on boards of at least 7x7
    ``win`` int64 [H*W, 49], the 7x7 window around each site, with
    ``at`` bool [9, 7, 7], each candidate cell's place in it; ``types``
    int32 :data:`CELL_TYPES`."""
    k = torch.arange(h * w, device=device)
    r0, c0 = k // w, k % w

    def around(radius):
        offs = torch.arange(-radius, radius + 1, device=device)
        rr = (r0[:, None, None] + offs[:, None]) % h
        cc = (c0[:, None, None] + offs[None, :]) % w
        return (rr * w + cc).reshape(h * w, -1)

    tables = {"pos": around(period), "types": torch.tensor(
        CELL_TYPES, dtype=torch.int32, device=device)}
    if period == 1 and h >= 7 and w >= 7:
        # The window's (i, j) is board cell (r0 - 3 + i, c0 - 3 + j); the
        # candidate cells sit at (2..4)^2, their light cones in (1..5)^2.
        n = torch.arange(9, device=device)[:, None, None]
        i7 = torch.arange(7, device=device)
        tables["win"] = around(3)
        tables["at"] = (i7[:, None] == 2 + n // 3) & (i7 == 2 + n % 3)
    return tables


def _lane_candidates(board0, can_osc, k0, period, tables):
    """Violation and oscillation deltas of every candidate move of every
    lane: the 4 palette types at each cell of the (2p+1)^2 neighbourhood
    of the lane's site, flat index ``k0`` (int64 [N]), with the
    :func:`candidate_tables` of the board. The caller masks the cell's own
    type and cells that are not writable.

    Returns (flat cell index int64 [N, P], dv float32 [N, P, 4], dosc
    float32 [N, P, 4]), P = (2p+1)^2, the neighbourhood in raster order.
    Still lifes on boards of at least 7x7 take the deltas from the 7x7
    window around the site (a change's light cone is the 5x5 block around
    it); other boards and oscillators recompute the whole board for each
    candidate.
    """
    n, h, w = board0.shape
    types = tables["types"]
    pos = tables["pos"][k0]                                # [N, P]
    flat = board0.reshape(n, h * w)

    if "win" in tables:
        win = flat.gather(1, tables["win"][k0]).reshape(n, 7, 7)
        base = _window_still_violations(win).sum((-2, -1))
        cand = torch.where(tables["at"][None, :, None],
                           types[None, None, :, None, None],
                           win[:, None, None])             # [N, 9, 4, 7, 7]
        dv = (_window_still_violations(cand).sum((-2, -1))
              - base[:, None, None]).to(torch.float32)
        return pos, dv, torch.zeros_like(dv)

    p = pos.shape[1]
    cand = flat[:, None, None, :].expand(n, p, 4, h * w).clone()
    cand.scatter_(3, pos[:, :, None, None].expand(n, p, 4, 1),
                  types[None, None, :, None].expand(n, p, 4, 1))
    cand = cand.reshape(n, p, 4, h, w)
    co = can_osc[:, None, None]
    base_v = _violations(board0, can_osc, period).sum((-2, -1))
    dv = (_violations(cand, co, period).sum((-2, -1))
          - base_v[:, None, None]).to(torch.float32)
    if period == 1:
        return pos, dv, torch.zeros_like(dv)
    do = (_osc_count(cand, period)
          - _osc_count(board0, period)[:, None, None]).to(torch.float32)
    return pos, dv, do


class _Chains:
    """N lockstep annealing chains: their constants and state, all tensors
    on the boards' device, so that an iteration reads no host value and
    launches no copy from the host. :meth:`start` (re)starts every chain
    from the working boards under a fill floor and a budget, :meth:`run`
    anneals until no chain is active; the retry ladder restarts the same
    chains, and on a card replays the CUDA graph captured on their
    first run."""

    def __init__(self, board0, mask, seeds, temperature, osc_bonus,
                 penalties, period):
        n, h, w = board0.shape
        dev = board0.device
        self.period = period
        self.board0 = board0.to(torch.int32)
        self.seeds = seeds.to(torch.bool)
        self.newcell = (mask & NEW_CELL_MASK) > 0
        self.inclv = (mask & INCLUDE_VIOLATIONS_MASK) > 0
        self.can_osc = (mask & CAN_OSCILLATE_MASK) > 0
        self.area = self.newcell.sum((-2, -1)).to(torch.float32)
        self.beta = 1.0 / temperature
        self.osc_bonus = osc_bonus
        self.penalties = penalties
        self.tables = candidate_tables(h, w, period, dev)
        self.pal_of_type = _palette_index(self.tables["types"])
        self.two = torch.tensor(2.0, device=dev)
        # Per run.
        self.min_fill_abs = torch.zeros((n,), device=dev)
        self.budget = torch.zeros((n,), dtype=torch.int32, device=dev)
        # State.
        self.board = self.board0.clone()
        self.seed_rem = self.seeds.clone()
        self.done = torch.zeros((n,), dtype=torch.bool, device=dev)
        self.it = torch.zeros((), dtype=torch.int32, device=dev)
        # The uniforms of one block of iterations, and its graph.
        self.site_u = torch.empty((CHECK_EVERY, n, h, w), device=dev)
        self.move_u = torch.empty(
            (CHECK_EVERY, n, self.tables["pos"].shape[1] * 4), device=dev)
        self.graph = None

    def active(self):
        return ~self.done & (self.it < self.budget)

    def start(self, min_fill, max_iter):
        """Every chain back at its working board and seeds, with the fill
        floor ``min_fill`` and the relative budget ``max_iter`` (float32
        [N]; a budget of 0 leaves a chain idle)."""
        self.min_fill_abs.copy_(min_fill * self.area)
        self.budget.copy_((max_iter * self.area * self.period)
                          .to(torch.int32))
        self.board.copy_(self.board0)
        self.seed_rem.copy_(self.seeds)
        self.done.zero_()
        self.it.zero_()

    def run(self, generator):
        """Anneal in blocks of :data:`CHECK_EVERY` iterations, each drawing
        its uniforms from ``generator`` first, until no chain is active
        (one host sync a block). Returns (boards, ok, fill); the boards
        are this object's state, overwritten by the next run."""
        while bool(self.active().any()):
            self.site_u.uniform_(generator=generator)
            self.move_u.uniform_(generator=generator)
            if self.graph is not None:
                self.graph.replay()
                continue
            _anneal_block(self)
            if self.board.is_cuda and bool(self.active().any()):
                self.graph = torch.cuda.CUDAGraph()
                torch.cuda.synchronize()
                with torch.cuda.graph(self.graph):
                    _anneal_block(self)
        ok = self.done & (self.area > 0)
        filled = ((self.board != 0) & self.newcell).sum((-2, -1))
        return self.board, ok, filled.to(torch.float32) / torch.clamp(
            self.area, min=1.0)


def _anneal_step(c, site_u, move_u):
    """One annealing iteration of every lane of the chains ``c`` from the
    uniforms ``site_u`` [N, H, W] and ``move_u`` [N, P * 4]. Returns the
    moved (board, seed_rem) and whether each lane had converged before
    the iteration."""
    board, seed_rem, period = c.board, c.seed_rem, c.period
    n, h, w = board.shape
    v = _violations(board, c.can_osc, period)
    bad = (v > 0) & c.inclv
    pal = _palette_index(board)
    totals = ((pal[..., None] == c.pal_of_type) & c.newcell[..., None]) \
        .sum((1, 2))                                       # [N, 4]
    not_empty = totals[:, 1:].sum(1).to(torch.float32)
    any_bad = bad.any(-1).any(-1)
    converged = ~any_bad & (not_empty >= c.min_fill_abs)

    # The site: a uniform pick from the highest-priority non-empty set
    # (the argmax of iid uniforms over a set is a uniform draw from it).
    any_seed = seed_rem.any(-1).any(-1)
    sel = torch.where(any_bad[:, None, None], bad,
                      torch.where(any_seed[:, None, None], seed_rem,
                                  c.newcell))
    k0 = torch.argmax(torch.where(sel, site_u, -1.0).reshape(n, -1), 1)
    seed_rem = seed_rem.reshape(n, -1).scatter(
        1, k0[:, None], False).reshape(n, h, w)

    # Density penalties of this iteration.
    t0 = torch.where(c.min_fill_abs > 0,
                     not_empty / torch.clamp(c.min_fill_abs, min=1e-9),
                     c.two)
    pen0 = torch.where(t0 < 0.9, 2.0,
                       torch.where(t0 < 1.0, 20.0 * (1.0 - t0), 0.0))
    tj = totals[:, 1:].to(torch.float32) / (not_empty[:, None] + 1.0)
    pens = c.penalties
    penj = pens[:, 2::2] + tj * (pens[:, 3::2] - pens[:, 2::2])
    pen = torch.cat([pen0[:, None], penj], 1)              # [N, 4]

    pos, dv, do = _lane_candidates(board, c.can_osc, k0, period, c.tables)
    cur_pal = _palette_index(board.reshape(n, -1).gather(1, pos))
    writable = c.newcell.reshape(n, -1).gather(1, pos)
    lp = -c.beta[:, None, None] * (dv - c.osc_bonus[:, None, None] * do
                                   + pen[:, c.pal_of_type][:, None, :])
    lp = torch.where(writable[:, :, None], lp, _NEG)
    lp = torch.where(cur_pal[:, :, None] == c.pal_of_type, _NEG, lp)

    flat_lp = lp.reshape(n, -1)
    g = -torch.log(-torch.log(torch.clamp(move_u, min=1e-20)))
    pick = torch.argmax(flat_lp + g, 1)
    has_cand = flat_lp.max(1).values > _NEG / 2
    target = pos.gather(1, (pick // 4)[:, None])
    moved = board.reshape(n, -1).scatter(
        1, target, c.tables["types"][pick % 4][:, None]).reshape(n, h, w)
    do_move = ~converged & has_cand
    return torch.where(do_move[:, None, None], moved, board), seed_rem, \
        converged


def _anneal_block(c):
    """One block of iterations of the chains ``c`` on their uniforms, in
    place; chains that are done or over their budget keep their state."""
    for k in range(CHECK_EVERY):
        active = c.active()
        board, seed_rem, conv = _anneal_step(c, c.site_u[k], c.move_u[k])
        sel = active[:, None, None]
        c.board.copy_(torch.where(sel, board, c.board))
        c.seed_rem.copy_(torch.where(sel, seed_rem, c.seed_rem))
        c.done.copy_(c.done | (active & conv))
        c.it.add_(1)


@torch.no_grad()
def anneal_batch(board0, mask, seeds, min_fill, max_iter, temperature,
                 osc_bonus, penalties, generator, period=1):
    """Anneal N regions in lockstep on their device.

    board0 int32 [N, H, W]: the working boards (layer 0). mask int32
    [N, H, W]: per-cell NEW_CELL / CAN_OSCILLATE / INCLUDE_VIOLATIONS
    flags. seeds bool [N, H, W]: the initial seed set (each seed picked
    at most once a chain). min_fill, max_iter, temperature, osc_bonus
    float32 [N]: the relative fill floor, the relative iteration budget,
    the Boltzmann temperature, the oscillation bonus. penalties float32
    [N, 8]: (base, at-full-density) pairs for empty/wall/life/tree, the
    empty pair unused (the fill-progress penalty is built in).
    ``generator`` lives on the boards' device.

    Returns (boards, ok, fill): the annealed boards, whether each lane
    converged, each lane's fill over its writable area. A lane with no
    writable area comes back unchanged with ok False.
    """
    c = _Chains(board0, mask, seeds, temperature, osc_bonus, penalties,
                period)
    c.start(min_fill, max_iter)
    return c.run(generator)


@torch.no_grad()
def anneal_with_retries_batched(board0, mask, seeds, params, generator,
                                attempts=10):
    """The host retry ladder (``generate.py::_anneal_with_retries``) over
    lanes: a lane that does not converge lowers ``min_fill`` by 6% an
    attempt, an overfull result raises ``max_fill`` by 7%; lanes that
    exhaust the ladder, or have no writable area, come back unchanged.

    ``params``: per-lane float32 [N] tensors min_fill, max_fill, max_iter,
    temperature, osc_bonus, penalties [N, 8], and the int ``period``.
    Tensors live on the boards' device, as ``generator`` does.

    Returns (boards int32 [N, H, W], resolved_ok bool [N]).
    """
    n = board0.shape[0]
    min_fill = params["min_fill"]
    max_fill = params["max_fill"]
    out = board0.to(torch.int32)
    # A lane with no writable area never anneals (the host raises
    # InsufficientArea and keeps the board, without retries).
    resolved = ((mask & NEW_CELL_MASK) > 0).sum((-2, -1)) == 0
    success = torch.zeros((n,), dtype=torch.bool, device=board0.device)
    chains = _Chains(board0, mask, seeds, params["temperature"],
                     params["osc_bonus"], params["penalties"],
                     int(params.get("period", 1)))

    for _ in range(attempts + 1):
        # Resolved lanes run with a zero budget (an immediate no-op).
        chains.start(min_fill, torch.where(resolved, 0.0,
                                           params["max_iter"]))
        res, ok, fill = chains.run(generator)
        overfull = ok & (fill > max_fill)
        good = ~resolved & ok & ~overfull
        out = torch.where(good[:, None, None], res, out)
        success = success | good
        min_fill = torch.where(~resolved & ~ok, min_fill * 0.94, min_fill)
        max_fill = torch.where(~resolved & overfull, max_fill * 1.07,
                               max_fill)
        resolved = resolved | good
        if bool(resolved.all()):
            break
    return out, success
