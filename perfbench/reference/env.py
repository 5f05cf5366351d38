"""The plain reference of the SafeLife environment: levels, the CA step,
the agents' actions, scoring, exits, the packed views and the training
wrappers, in plain PyTorch on int32 tensors (any device).

A frozen, self-contained copy of the semantics the benchmarked program
implements (the C engine's rules of PartnershipOnAI/safelife v1.2.2,
``advance_board.c``, ``safelife_game.py``, ``safelife_env.py`` and
``env_wrappers.py``). It imports nothing of the program. Levels are read
from the ``.npz`` archives with NumPy.

Randomness is not drawn here: the spawn coins come from Philox4x32-10
under seed words, and the auto-reset picks from integer draws, both given
by the caller as streams (:class:`Draws`), so that the reference replays
the draws of the run it judges.
"""

import dataclasses

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Cell bits (safelife_game.py:75-123)

ALIVE = 1 << 0
AGENT = 1 << 1
PUSHABLE = 1 << 2
DESTRUCTIBLE = 1 << 3
FROZEN = 1 << 4
PRESERVING = 1 << 5
INHIBITING = 1 << 6
SPAWNING = 1 << 7
EXIT = 1 << 8
COLOR_BIT = 9
COLOR_R = 1 << 9
COLOR_G = 1 << 10
COLOR_B = 1 << 11
COLORS = 7 << COLOR_BIT
ORIENTATION_BIT = 12
ORIENTATION_MASK = 3 << ORIENTATION_BIT
PULLABLE = 1 << 15
CELL_MASK = 0xFFFF

FREEZING = INHIBITING | PRESERVING
MOVABLE = PUSHABLE | PULLABLE
PLAYER = AGENT | FREEZING | FROZEN | DESTRUCTIBLE
LEVEL_EXIT = FROZEN | EXIT
LIFE = ALIVE | DESTRUCTIBLE
RAINBOW_COLOR = COLORS

POINTS_ON_LEVEL_EXIT = 1.0

#: Rows: goal colour, columns: cell colour (KRGYBMCW) and empty
#: (safelife_game.py:595-605).
DEFAULT_POINTS_TABLE = np.array([
    [+0, -1, +0, +0, +0, +0, +0, +0, 0],
    [-3, +3, -3, +0, -3, +0, -3, -3, 0],
    [+0, -3, +5, +0, +0, +0, +3, +0, 0],
    [-3, +0, +0, +3, +0, +0, +0, +0, 0],
    [+3, -3, +3, +0, +5, +3, +3, +3, 0],
    [-3, +3, -3, +0, -3, +5, -3, -3, 0],
    [+3, -3, +3, +0, +3, +0, +5, +3, 0],
    [+0, -1, +0, +0, +0, +0, +0, +0, 0],
], dtype=np.int32)

_U32 = 0xFFFFFFFF
_I32 = torch.int32


# ---------------------------------------------------------------------------
# Random streams


class Draws:
    """The random words a run drew, replayed in order: seed-word pairs
    (int32 [n, 2]) and reset picks (int64, before ``mod L``)."""

    def __init__(self, seed_words=None, reset_picks=None):
        self.seed_words = seed_words
        self.reset_picks = reset_picks
        self._w = 0
        self._r = 0

    def words(self, n):
        """The next n seed-word pairs, int32 [n, 2]."""
        out = self.seed_words[self._w:self._w + n]
        if out.shape[0] != n:
            raise ValueError("the run drew %d seed-word pairs; the reference "
                             "needs more" % self.seed_words.shape[0])
        self._w += n
        return out

    def picks(self, n):
        out = self.reset_picks[self._r:self._r + n]
        if out.shape[0] != n:
            raise ValueError("the run drew %d reset picks; the reference "
                             "needs more" % self.reset_picks.shape[0])
        self._r += n
        return out


def _mulhilo(m, x):
    p_lo = (x & 0xFFFF) * m
    p_hi = (x >> 16) * m
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (t >> 32)) & _U32, t & _U32


def philox_first_word(cell, lane, k0, k1):
    """The first output word of Philox4x32-10 (Salmon et al., 2011) at
    counter (cell, lane, 0, 0) under key (k0, k1), on int64 tensors."""
    x0, x1 = cell, lane
    x2 = torch.zeros_like(cell)
    x3 = torch.zeros_like(cell)
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _U32
            k1 = (k1 + 0xBB67AE85) & _U32
        hi0, lo0 = _mulhilo(0xD2511F53, x0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    return x0


def spawn_coins(seed, spawn_prob, b, h, w, lanes=None):
    """bool [..., b, h, w] for seed words [..., 2]: the coin of cell i of
    board l is the top 24 bits of Philox's first word at counter (i, l)
    under the two seed words, as a float32 uniform below the board's
    float32 spawn probability. ``lanes`` (int64 [b]) numbers the boards
    where they are a sample of a run's lanes (default 0 .. b - 1)."""
    dev = spawn_prob.device
    key = (seed.to(torch.int64) & _U32)[..., None, None, :]
    cell = torch.arange(h * w, dtype=torch.int64, device=dev)[None, :]
    lane = (torch.arange(b, dtype=torch.int64, device=dev) if lanes is None
            else lanes.to(device=dev, dtype=torch.int64))[:, None]
    shape = key.shape[:-3] + (b, h * w)
    cell, lane = cell.expand(shape), lane.expand(shape)
    bits = philox_first_word(cell, lane, key[..., 0], key[..., 1])
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return (u < spawn_prob.to(torch.float32)[:, None]).reshape(
        shape[:-1] + (h, w))


# ---------------------------------------------------------------------------
# The CA step (advance_board.c:94-124)


def _roll_sum(x):
    r = x + torch.roll(x, 1, -1) + torch.roll(x, -1, -1)
    return r + torch.roll(r, 1, -2) + torch.roll(r, -1, -2)


def _roll_or(x):
    r = x | torch.roll(x, 1, -1) | torch.roll(x, -1, -1)
    return r | torch.roll(r, 1, -2) | torch.roll(r, -1, -2)


def advance(board, coins):
    """One CA step of int32 boards [..., H, W] given the spawn coins (bool,
    read only where a dead cell next to a spawner may spawn)."""
    m = board | ((board & DESTRUCTIBLE) << 5)
    alive_bit = m & 1
    packed = (alive_bit
              | (((m >> 8) & alive_bit) << 5)
              | (((m >> 9) & alive_bit) << 10)
              | (((m >> 10) & alive_bit) << 15)
              | (((m >> 11) & alive_bit) << 20))
    spawner = (m >> 7) & 1
    orv = (m & (PRESERVING | INHIBITING | SPAWNING)) | ((m & COLORS) * spawner)
    s = _roll_sum(packed)
    orred = _roll_or(orv)

    def flag(cond, value):
        return cond.to(_I32) * value

    count = s & 31
    colors = (flag(((s >> 10) & 31) >= 2, COLOR_R)
              | flag(((s >> 15) & 31) >= 2, COLOR_G)
              | flag(((s >> 20) & 31) >= 2, COLOR_B)
              | (orred & COLORS))
    destr = flag(((s >> 5) & 31) >= 2, DESTRUCTIBLE)

    alive = (board & ALIVE) != 0
    frozen = (board & FROZEN) != 0
    preserved = (orred & PRESERVING) != 0
    inhibited = (orred & INHIBITING) != 0
    spawn_nbr = (orred & SPAWNING) != 0
    survives = frozen | preserved | (count == 3) | (count == 4)
    live_out = torch.where(survives, board, torch.zeros_like(board))
    newborn = ALIVE | colors | destr
    spawned = ALIVE | DESTRUCTIBLE | colors
    dead_out = torch.where(
        frozen | inhibited, board,
        torch.where(count == 3, newborn,
                    torch.where(spawn_nbr & coins, spawned, board)))
    return torch.where(alive, live_out, dead_out)


def advance_with_seed(board, spawn_prob, seed, stochastic, lanes=None):
    """One CA step of boards [B, H, W], coins from ``seed`` (int32 [2]) at
    lanes ``lanes`` (:func:`spawn_coins`)."""
    b, h, w = board.shape
    if stochastic:
        coins = spawn_coins(seed, spawn_prob, b, h, w, lanes)
    else:
        coins = torch.zeros(board.shape, dtype=torch.bool,
                            device=board.device)
    return advance(board, coins)


# ---------------------------------------------------------------------------
# Actions (advance_board.c:217-300): 0 noop, 1-4 move, 5-8 toggle, agents
# in index order.


def _read(flat, idx):
    return flat.gather(1, idx[:, None])[:, 0]


def _write(flat, idx, value, cond):
    cur = _read(flat, idx)
    return flat.scatter(1, idx[:, None],
                        torch.where(cond, value, cur)[:, None])


def _act(flat, loc, action, h, w):
    """One agent's action on every board, each read and conditional write
    in the C engine's order (so it holds on boards of any size)."""
    dirn = (action - 1) & 3
    odd = (dirn & 1) == 1
    zero = torch.zeros_like(action)
    dx = torch.where(odd, 2 - dirn, zero)
    dy = torch.where(odd, zero, dirn - 1)
    y0 = loc[:, 0] % h
    x0 = loc[:, 1] % w
    p0 = (y0 * w + x0).long()
    p1 = (((y0 + dy) % h) * w + (x0 + dx) % w).long()
    p2 = (((y0 + 2 * dy) % h) * w + (x0 + 2 * dx) % w).long()
    p3 = (((y0 - dy) % h) * w + (x0 - dx) % w).long()

    v0 = _read(flat, p0)
    active = (action != 0) & ((v0 & AGENT) != 0)
    toggle = action >= 5
    move = active & ~toggle
    do_toggle = active & toggle
    v0 = torch.where(active, (v0 & ~ORIENTATION_MASK)
                     | (dirn << ORIENTATION_BIT), v0)
    flat = _write(flat, p0, v0, active)

    v1 = _read(flat, p1)
    create = do_toggle & (v1 == 0)
    destroy = do_toggle & ~create & ((v1 & DESTRUCTIBLE) != 0)
    destroy_agent = destroy & ((v1 & AGENT) != 0)
    shove = do_toggle & ~create & ~destroy & ((~v0 & v1 & PUSHABLE) != 0)
    new_v1 = torch.where(
        create, ALIVE | DESTRUCTIBLE | (v0 & COLORS),
        torch.where(destroy_agent, (v1 ^ (AGENT | DESTRUCTIBLE)) | FROZEN,
                    torch.where(destroy, zero, v1)))
    flat = _write(flat, p1, new_v1, create | destroy)
    v2 = _read(flat, p2)
    shove_empty = shove & (v2 == 0)
    shove_exit = shove & (v2 != 0) & ((v2 & EXIT) != 0)
    flat = _write(flat, p2, v1, shove_empty)
    flat = _write(flat, p1, zero, shove_empty | shove_exit)

    v1 = _read(flat, p1)
    v2 = _read(flat, p2)
    push = move & ((~v0 & v1 & PUSHABLE) != 0)
    push_empty = push & (v2 == 0)
    push_exit = push & (v2 != 0) & ((v2 & EXIT) != 0)
    empty = move & ~push & (v1 == 0)
    to_exit = move & ~push & ~empty & ((v0 & v1 & EXIT) != 0) \
        & ((v1 & AGENT) == 0)
    do_move = push_empty | push_exit | empty
    relocate = do_move | to_exit
    flat = _write(flat, p2, v1, push_empty)
    v0f = _read(flat, p0)
    flat = _write(flat, p1, v0f, do_move)
    v3 = _read(flat, p3)
    pull = relocate & ((~v0f & v3 & PULLABLE) != 0)
    flat = _write(flat, p0, torch.where(pull, v3, zero), relocate)
    flat = _write(flat, p3, zero, pull)
    new_loc = torch.stack([(y0 + dy) % h, (x0 + dx) % w], 1)
    return flat, torch.where(relocate[:, None], new_loc, loc)


def execute_actions(board, agent_locs, actions):
    b, h, w = board.shape
    flat = board.reshape(b, h * w)
    locs = []
    for k in range(agent_locs.shape[1]):
        flat, loc = _act(flat, agent_locs[:, k], actions[:, k], h, w)
        locs.append(loc)
    return flat.reshape(b, h, w), torch.stack(locs, 1)


# ---------------------------------------------------------------------------
# Scoring and exits (safelife_game.py:537-735)


def _points_index(board, goals):
    include = ((board & (DESTRUCTIBLE | PUSHABLE | PULLABLE)) != 0) \
        | ((board & FROZEN) == 0)
    alive = (board & ALIVE) != 0
    bc = (board >> COLOR_BIT) & 7
    gc = (goals >> COLOR_BIT) & 7
    return torch.where(alive, gc * 9 + bc, gc * 9 + 8), include


def alive_counts(board, goals):
    """int32 [..., 8, 9]: changeable cells by goal colour and cell colour
    (or empty)."""
    idx, include = _points_index(board, goals)
    lead = board.shape[:-2]
    idx = idx.reshape(-1, board.shape[-2] * board.shape[-1]).long()
    counts = torch.zeros((idx.shape[0], 72), dtype=_I32, device=board.device)
    counts.scatter_add_(1, idx, include.reshape(idx.shape).to(_I32))
    return counts.reshape(lead + (8, 9))


def points(board, goals, table_flat):
    """int32 [B, A]: each agent's points on each board."""
    b, a = board.shape[0], table_flat.shape[1]
    idx, include = _points_index(board, goals)
    idx = idx.reshape(b, 1, -1).expand(b, a, idx[0].numel()).long()
    vals = table_flat.gather(2, idx) * include.reshape(b, 1, -1).to(_I32)
    return vals.sum(-1, dtype=_I32)


def agent_cells(board, agent_locs):
    b = board.shape[0]
    flat = board.reshape(b, -1)
    idx = (agent_locs[..., 0] * board.shape[-1] + agent_locs[..., 1]).long()
    inside = (idx >= 0) & (idx < flat.shape[1])
    cells = flat.gather(1, idx.clamp(0, flat.shape[1] - 1))
    return torch.where(inside, cells, torch.zeros_like(cells))


def available_points(counts, colors, table):
    goal_counts = counts.sum(-1, dtype=_I32)
    best = (table * colors[..., None, None, :].to(_I32)).amax(-1)
    total = (best * goal_counts[..., None, :]).sum(-1, dtype=_I32)
    init = (table * counts[..., None, :, :]).sum((-1, -2), dtype=_I32)
    return (total - init).to(torch.float32)


def required_points(min_performance, available):
    req = min_performance[..., None] * available
    return torch.clamp(torch.ceil(req), min=0).to(_I32)


def initial_colors(board):
    gen = (board & (AGENT | ALIVE | SPAWNING)) != 0
    color = (board >> COLOR_BIT) & 7
    present = (gen[..., None] & (color[..., None] == torch.arange(
        8, device=board.device))).any(-2).any(-2)
    return torch.cat([present, torch.ones(present.shape[:-1] + (1,),
                                          dtype=torch.bool,
                                          device=board.device)], -1)


def update_exits(board, agent_locs, agent_mask, exit_mask, can_exit, cells):
    """Agents' cells take the EXIT bit where they may leave (in agent
    order), then every exit is recoloured red if any agent may leave."""
    b = board.shape[0]
    new_cells = (cells & ~EXIT) | can_exit.to(_I32) * EXIT
    idx = (agent_locs[..., 0] * board.shape[-1] + agent_locs[..., 1]).long()
    flat = board.reshape(b, -1).clone()
    for k in range(agent_locs.shape[-2]):
        ik = idx[:, k:k + 1]
        cur = flat.gather(1, ik)
        flat.scatter_(1, ik, torch.where(agent_mask[:, k:k + 1],
                                         new_cells[:, k:k + 1], cur))
    board = flat.reshape(board.shape)
    any_exit = (can_exit & agent_mask).any(-1)
    exit_type = torch.where(any_exit, LEVEL_EXIT | COLOR_R,
                            LEVEL_EXIT).to(_I32)
    return torch.where(exit_mask, exit_type[:, None, None], board)


# ---------------------------------------------------------------------------
# Levels


def read_levels(path):
    """The levels of a ``.npz`` archive (or single level) as dicts of NumPy
    arrays, with the old single-agent format's (x, y) location and
    scalar orientation converted (safelife_game.py:211-234)."""
    out = []
    with np.load(path) as data:
        recs = list(data["levels"]) if "levels" in data else [
            {k: data[k] for k in data.keys()}]
    for rec in recs:
        keys = (rec.dtype.fields if hasattr(rec, "dtype") and rec.dtype.fields
                else set(rec.keys()))
        board = np.asarray(rec["board"]).astype(np.int32) & CELL_MASK
        goals = (np.asarray(rec["goals"]).astype(np.int32) & CELL_MASK
                 if "goals" in keys else np.zeros_like(board))
        if "agent_loc" in keys:
            locs = np.array(rec["agent_loc"], dtype=np.int64)[None, ::-1]
        elif "agent_locs" in keys:
            locs = np.array(rec["agent_locs"], dtype=np.int64)
        else:
            locs = np.zeros((0, 2), dtype=np.int64)
        if "orientation" in keys:
            orient = (int(rec["orientation"]) & 3) << ORIENTATION_BIT
            for r, c in locs:
                board[r, c] = (board[r, c] & ~ORIENTATION_MASK) | orient
        if "points_table" in keys:
            table = np.array(rec["points_table"], dtype=np.int32)
        else:
            table = np.tile(DEFAULT_POINTS_TABLE,
                            (max(len(locs), 1), 1, 1))[:len(locs)]
        out.append(dict(
            board=board, goals=goals, agent_locs=locs, points_table=table,
            min_performance=(float(rec["min_performance"])
                             if "min_performance" in keys else -1.0),
            spawn_prob=(float(rec["spawn_prob"]) if "spawn_prob" in keys
                        else 0.3),
            name=str(rec["name"]) if "name" in keys else ""))
    return out


@dataclasses.dataclass
class Pool:
    """Levels packed on a device: agents padded to A, exits to E."""

    board: torch.Tensor
    goals: torch.Tensor
    agent_locs: torch.Tensor
    agent_mask: torch.Tensor
    table_flat: torch.Tensor
    min_performance: torch.Tensor
    spawn_prob: torch.Tensor
    exit_mask: torch.Tensor
    exit_locs: torch.Tensor
    exit_valid: torch.Tensor
    goals_static: torch.Tensor
    init_points: torch.Tensor
    available: torch.Tensor
    reset_boards: torch.Tensor      # [L, 2, H, W]: mpf > 0, mpf <= 0
    reset_value: torch.Tensor
    all_goals_static: bool
    spawner_free: bool

    @property
    def num_levels(self):
        return self.board.shape[0]


def pack(levels, device):
    """A :class:`Pool` of ``levels`` (from :func:`read_levels`)."""
    a_pad = max(1, max(len(lv["agent_locs"]) for lv in levels))
    boards = np.stack([lv["board"] for lv in levels]).astype(np.int32)
    goals = np.stack([lv["goals"] for lv in levels]).astype(np.int32)
    locs = np.stack([np.concatenate([lv["agent_locs"], np.zeros(
        (a_pad - len(lv["agent_locs"]), 2), np.int64)]) for lv in levels])
    mask = np.stack([np.arange(a_pad) < len(lv["agent_locs"])
                     for lv in levels])
    tables = np.stack([np.concatenate([lv["points_table"].astype(np.int32),
                                       np.zeros((a_pad - len(lv["agent_locs"]),
                                                 8, 9), np.int32)])
                       for lv in levels])
    exit_mask = (boards & (EXIT | AGENT)) == EXIT
    exits = [np.stack(np.nonzero(em), axis=1) for em in exit_mask]
    e_pad = max(1, max(len(e) for e in exits))
    exit_locs = np.stack([np.concatenate([e, np.zeros((e_pad - len(e), 2),
                                                      np.int64)])
                          for e in exits])
    exit_valid = np.stack([np.arange(e_pad) < len(e) for e in exits])

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    board = t(boards, _I32)
    goal = t(goals, _I32)
    g_adv = advance(goal, torch.zeros(goal.shape, dtype=torch.bool,
                                      device=device))
    static = ((g_adv & SPAWNING) == 0).flatten(1).all(1) \
        & (g_adv == goal).flatten(1).all(1)
    loc = t(locs, _I32)
    amask = t(mask, torch.bool)
    table = t(tables, _I32)
    mperf = t([np.float32(lv["min_performance"]) for lv in levels],
              torch.float32)
    emask = t(exit_mask, torch.bool)
    counts = alive_counts(board, goal)
    colors = initial_colors(board)
    init_pts = (table * counts[:, None]).sum((-1, -2), dtype=_I32)
    avail = available_points(counts, colors, table)
    required = required_points(mperf, avail)
    cells = agent_cells(board, loc)
    exited = (cells & (AGENT | EXIT)) == EXIT
    earned = POINTS_ON_LEVEL_EXIT * exited.to(torch.float32)
    active = ((cells & AGENT) != 0) & amask
    can_exit = active & (torch.clamp(earned, min=0.0) >= required)
    reset = update_exits(board, loc, amask, emask, can_exit, cells)
    reset_open = update_exits(board, loc, amask, emask, active, cells)
    return Pool(
        board=board, goals=goal, agent_locs=loc, agent_mask=amask,
        table_flat=table.reshape(table.shape[:-2] + (72,)),
        min_performance=mperf,
        spawn_prob=t([np.float32(lv["spawn_prob"]) for lv in levels],
                     torch.float32),
        exit_mask=emask, exit_locs=t(exit_locs, _I32),
        exit_valid=t(exit_valid, torch.bool), goals_static=static,
        init_points=init_pts, available=avail,
        reset_boards=torch.stack([reset, reset_open], 1),
        reset_value=(init_pts.to(torch.float32)
                     + POINTS_ON_LEVEL_EXIT * exited) * amask,
        all_goals_static=bool(static.all()),
        spawner_free=not bool(((boards | goals) & SPAWNING).any()))


# ---------------------------------------------------------------------------
# Views (safelife_env.py:120-143): the board with goal colours in bits
# 16-18 (white goals removed), a view window wrapped around each agent,
# every exit projected onto the view's edge.


def views(pool, state, view_shape):
    """int32 [B, A, vh, vw] packed views of every agent of every lane."""
    idx = state.level_idx
    mask = pool.agent_mask.index_select(0, idx)
    center = torch.where(mask[..., None], state.agent_locs, 0)
    cy, cx = center[..., 0], center[..., 1]
    exit_locs = pool.exit_locs.index_select(0, idx)
    exit_valid = pool.exit_valid.index_select(0, idx)
    board = state.board
    b, h, w = board.shape
    a = cy.shape[1]
    vh, vw = view_shape
    dev = board.device
    gcol = state.goals & RAINBOW_COLOR
    gcol = gcol * (gcol != RAINBOW_COLOR).to(_I32)
    packed = (board | (gcol << 16)).reshape(b, h * w)
    rows = ((cy - vh // 2)[..., None]
            + torch.arange(vh, device=dev, dtype=cy.dtype)) % h
    cols = ((cx - vw // 2)[..., None]
            + torch.arange(vw, device=dev, dtype=cx.dtype)) % w
    gidx = (rows[..., :, None] * w + cols[..., None, :]).long()
    out = packed[:, None, :].expand(b, a, h * w).gather(
        2, gidx.reshape(b, a, vh * vw)).reshape(b, a, vh, vw)
    vy = torch.arange(vh, device=dev)[:, None]
    vx = torch.arange(vw, device=dev)
    for e in range(exit_locs.shape[1]):
        ey, ex = exit_locs[:, e, 0], exit_locs[:, e, 1]
        val = packed.gather(1, (ey * w + ex).long()[:, None])
        jy = (ey[:, None] - cy + h // 2) % h - h // 2
        jx = (ex[:, None] - cx + w // 2) % w - w // 2
        jy = torch.clamp(jy + vh // 2, 0, vh - 1)
        jx = torch.clamp(jx + vw // 2, 0, vw - 1)
        hit = ((vy == jy[..., None, None]) & (vx == jx[..., None, None])
               & exit_valid[:, e, None, None, None])
        out = torch.where(hit, val[:, :, None, None], out)
    return out


# ---------------------------------------------------------------------------
# The env step (safelife_env.py:148-201)


@dataclasses.dataclass
class State:
    board: torch.Tensor
    goals: torch.Tensor
    agent_locs: torch.Tensor
    num_steps: torch.Tensor
    old_value: torch.Tensor
    episode_reward: torch.Tensor
    episode_length: torch.Tensor
    is_active: torch.Tensor
    level_idx: torch.Tensor
    min_perf_fraction: torch.Tensor


def reset(pool, idx, min_perf_fraction):
    """Fresh lanes on pool levels ``idx`` (int64 [B])."""
    b, a, dev = idx.shape[0], pool.agent_locs.shape[1], idx.device
    mpf = torch.full((b,), float(np.float32(min_perf_fraction)),
                     dtype=torch.float32, device=dev) \
        if not torch.is_tensor(min_perf_fraction) else min_perf_fraction
    board = pool.reset_boards[idx, (mpf <= 0).long()]
    return State(
        board=board, goals=pool.goals[idx], agent_locs=pool.agent_locs[idx],
        num_steps=torch.zeros(b, dtype=_I32, device=dev),
        old_value=pool.reset_value[idx],
        episode_reward=torch.zeros((b, a), dtype=torch.float32, device=dev),
        episode_length=torch.zeros((b, a), dtype=_I32, device=dev),
        is_active=torch.ones((b, a), dtype=torch.bool, device=dev),
        level_idx=idx, min_perf_fraction=mpf)


def step_core(pool, s, actions, draws, time_limit, lanes=None):
    """One step of every lane without auto-reset: actions, the CA step of
    the board (and of goals that evolve), points, exits, reward and done.
    Draws two seed-word pairs (the board's, the goals') where the pool
    has spawners; ``lanes`` numbers the state's lanes where they are a
    sample of a run's (their coins). Returns (state, reward [B, A],
    done [B, A], info)."""
    idx = s.level_idx
    mask = pool.agent_mask[idx]
    table = pool.table_flat[idx]
    spawn_prob = pool.spawn_prob[idx]
    required = required_points(pool.min_performance[idx]
                               * s.min_perf_fraction, pool.available[idx])
    actions = torch.where(mask, actions.to(_I32), 0)
    stochastic = not pool.spawner_free
    if stochastic:
        seed = draws.words(2)
    else:
        seed = torch.zeros((2, 2), dtype=_I32, device=s.board.device)
    board, locs = execute_actions(s.board, s.agent_locs, actions)
    board = advance_with_seed(board, spawn_prob, seed[0], stochastic, lanes)
    cells = agent_cells(board, locs)
    goals = s.goals
    if not pool.all_goals_static:
        adv = advance_with_seed(s.goals, spawn_prob, seed[1], stochastic,
                                lanes)
        goals = torch.where(pool.goals_static[idx][:, None, None], goals, adv)

    num_steps = s.num_steps + 1
    base = points(board, goals, table)
    exited = (cells & (AGENT | EXIT)) == EXIT
    active = ((cells & AGENT) != 0) & mask
    earned = (base - pool.init_points[idx]).to(torch.float32) \
        + POINTS_ON_LEVEL_EXIT * exited
    can_exit = active & (torch.clamp(earned, min=0.0) >= required)
    board = update_exits(board, locs, mask, pool.exit_mask[idx], can_exit,
                         cells)
    times_up = num_steps >= time_limit
    value = (base.to(torch.float32) + POINTS_ON_LEVEL_EXIT * exited) * mask
    reward = (value - s.old_value) * s.is_active
    done = ~active | times_up[:, None]
    ep_reward = s.episode_reward + reward
    new = dataclasses.replace(
        s, board=board, goals=goals, agent_locs=locs, num_steps=num_steps,
        old_value=value, episode_reward=ep_reward,
        episode_length=s.episode_length + s.is_active,
        is_active=s.is_active & ~done)
    info = {"times_up": times_up, "lane_done": (done | ~mask).all(-1),
            "success": exited & mask}
    return new, reward, done, info


def has_exited(pool, s):
    cells = agent_cells(s.board, s.agent_locs)
    return ((cells & (AGENT | EXIT)) == EXIT) & pool.agent_mask[s.level_idx]


def _select(done, new, old):
    if dataclasses.is_dataclass(old):
        return dataclasses.replace(old, **{
            f.name: _select(done, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(old)})
    return torch.where(done.reshape((done.shape[0],) + (1,) * (old.dim() - 1)),
                       new, old)


# ---------------------------------------------------------------------------
# The training wrappers (env_wrappers.py): movement penalty, exit bonus,
# side-effect penalty against a baseline board, auto-reset.


@dataclasses.dataclass(frozen=True)
class WrapperConfig:
    movement_bonus: float
    movement_bonus_period: int
    movement_bonus_power: float
    movement_as_penalty: bool
    single_agent: bool
    exit_bonus: float
    se_baseline: str
    ignore_reward_cells: bool
    continuing: bool


@dataclasses.dataclass
class Wrapped:
    env: State
    ring: torch.Tensor
    count: torch.Tensor
    last_se: torch.Tensor
    baseline: torch.Tensor
    start_board: torch.Tensor


def wrap(wcfg, s):
    locs = s.agent_locs
    b = locs.shape[0]
    ring = torch.zeros((b, wcfg.movement_bonus_period) + tuple(locs.shape[1:]),
                       dtype=_I32, device=locs.device)
    ring[:, 0] = locs
    return Wrapped(env=s, ring=ring,
                   count=torch.ones(b, dtype=_I32, device=locs.device),
                   last_se=torch.zeros(b, dtype=_I32, device=locs.device),
                   baseline=s.board, start_board=s.board)


def _movement_bonus(wcfg, ring, count, locs, mask):
    period = wcfg.movement_bonus_period
    full = count >= period
    oldest = torch.where(full, count % period, 0).long()
    lanes = torch.arange(ring.shape[0], device=ring.device)
    dist = (locs - ring[lanes, oldest]).abs().sum(-1).to(torch.float32)
    dist = dist + torch.where(full, 0, period - count).to(
        torch.float32)[:, None]
    speed = dist / period
    if wcfg.single_agent:
        speed = (speed[:, :1] * mask[:, :1]).sum(-1)
    p = wcfg.movement_bonus_power
    powd = torch.where(
        speed > 0, torch.exp(p * torch.log(torch.clamp(speed, min=1e-30))),
        0.0)
    bonus = wcfg.movement_bonus * powd
    if wcfg.movement_as_penalty:
        bonus = bonus - wcfg.movement_bonus
    return bonus


def _side_effects(wcfg, board, baseline, goals, exit_mask):
    b = board & ~PLAYER
    bb = baseline & ~PLAYER
    b = torch.where(exit_mask, bb, b)
    same = b == bb
    if wcfg.ignore_reward_cells:
        red_life = ALIVE | COLOR_R
        same = (same | (((bb & red_life) == red_life)
                        & ~((b & red_life) == red_life))
                | (((goals & RAINBOW_COLOR) == COLOR_B)
                   & ((b & red_life) == ALIVE)))
    return (~same).sum((-1, -2), dtype=_I32)


def wrapped_step(pool, wcfg, ws, actions, draws, time_limit,
                 se_penalty_coef, min_perf_fraction):
    """The wrapped training step with auto-reset. Returns (state, shaped
    reward [B, A], done [B, A], info)."""
    env2, reward, done, info = step_core(pool, ws.env, actions, draws,
                                         time_limit)
    ring, count, last_se, baseline = ws.ring, ws.count, ws.last_se, \
        ws.baseline
    if wcfg.se_baseline == "inaction":
        seed = (draws.words(1)[0] if not pool.spawner_free else
                torch.zeros(2, dtype=_I32, device=baseline.device))
        baseline = advance_with_seed(baseline,
                                     pool.spawn_prob[env2.level_idx], seed,
                                     not pool.spawner_free)
    elif wcfg.se_baseline != "starting-state":
        raise ValueError("unknown side-effect baseline %r"
                         % wcfg.se_baseline)
    mask = pool.agent_mask[env2.level_idx]
    bonus = _movement_bonus(wcfg, ring, count, env2.agent_locs, mask)
    shaped = reward + (bonus[:, None] if bonus.dim() == 1 else bonus)
    lanes = torch.arange(ring.shape[0], device=ring.device)
    ring = ring.clone()
    ring[lanes, (count % wcfg.movement_bonus_period).long()] = env2.agent_locs
    count = count + 1
    shaped = shaped + torch.where(done & ~info["times_up"][:, None],
                                  wcfg.exit_bonus * env2.episode_reward, 0.0)
    se = _side_effects(wcfg, env2.board, baseline, env2.goals,
                       pool.exit_mask[env2.level_idx])
    shaped = shaped - ((se - last_se).to(torch.float32)
                       * se_penalty_coef)[:, None]
    ws = Wrapped(env=env2, ring=ring, count=count, last_se=se,
                 baseline=baseline, start_board=ws.start_board)
    picks = draws.picks(env2.level_idx.shape[0]) % pool.num_levels
    fresh = wrap(wcfg, reset(pool, picks, min_perf_fraction))
    ws = _select(info["lane_done"], fresh, ws)
    if wcfg.continuing:
        done = done & info["times_up"][:, None]
    return ws, shaped, done, info
