"""Top-level procedural level generation.

Port of ``safelife_tpu/procgen/generate.py:1-544`` (the port's own copy,
NumPy and SciPy only): ``fix_random_values``, ``_RegionCanvas``,
``host_annealer``, ``_drive_requests``, ``populate_region`` and its
request generator, ``add_agents_and_exit``, ``gen_game`` and its request
generator, ``stability_mask``. The same draws in the same order, so equal
seeds give byte-identical levels.

Distribution parity: reference ``safelife/proc_gen.py`` — the same YAML
parameter schema drives the same layered region population (fencing,
spawners, tree lattices, annealed patterns, movable/hardened conversions,
buffer zones, fountains, board/goal targeting), agent and exit placement,
the recursive randomization DSL (``{choices: ...}`` / ``{uniform: [lo,
hi]}``), and ``stability_mask``. Reference yaml files load unchanged.

Structure here is our own: each region is painted onto a
:class:`_RegionCanvas` that tracks the working board, the annealer's
cell-permission flags, and which painted cells belong to the final board
versus the goal board; every layer feature is a canvas method.
"""

import numpy as np
from scipy import ndimage

from ..core import cells as C
from ..io.levels import Level
from ..core.scoring import DEFAULT_POINTS_TABLE
from ..utils.rng import get_rng, coinflip
from . import pattern as P
from .regions import build_fence, make_lattice, make_partitioned_regions

COLORS = {
    'black': 0,
    'red': C.COLOR_R,
    'green': C.COLOR_G,
    'blue': C.COLOR_B,
    'yellow': C.COLOR_R | C.COLOR_G,
    'magenta': C.COLOR_R | C.COLOR_B,
    'cyan': C.COLOR_G | C.COLOR_B,
    'white': C.RAINBOW_COLOR,
}

AGENT_PROPERTIES = {
    "alive": C.ALIVE,
    "pushable": C.PUSHABLE,
    "pullable": C.PULLABLE,
    "destructible": C.DESTRUCTIBLE,
    "frozen": C.FROZEN,
    "preserving": C.PRESERVING,
    "inhibiting": C.INHIBITING,
    "spawning": C.SPAWNING,
}

DEFAULT_AGENT = {
    'color': 'black',
    'flags': ['preserving', 'inhibiting'],
    'points_table': DEFAULT_POINTS_TABLE,
}

_FULL_PERMISSIONS = (P.NEW_CELL_MASK | P.CAN_OSCILLATE_MASK
                     | P.INCLUDE_VIOLATIONS_MASK)
_NOT_RAINBOW = np.uint16(~C.RAINBOW_COLOR & 0xFFFF)


def fix_random_values(val):
    """Resolve the stochastic-parameter DSL: ``{choices: ..., weights: ...}``
    picks an option, ``{uniform: [lo, hi]}`` samples a float; dicts recurse.
    Parity: ``proc_gen.py:170-196``."""
    if not isinstance(val, dict):
        return val
    if 'choices' in val:
        choices = val['choices']
        if isinstance(choices, list):
            keys = choices
            weights = val.get('weights')
            vals = (np.asanyarray(weights) if weights is not None
                    else np.ones(len(choices)))
        elif isinstance(choices, dict):
            keys = list(choices.keys())
            vals = np.array(list(choices.values()), dtype=float)
        else:
            raise ValueError("'choices' must be a list or a dict of weights")
        if (vals < 0).any() or vals.sum() <= 0:
            raise ValueError("choice weights must be non-negative and sum"
                             " to a positive value")
        return get_rng().choice(keys, p=vals / vals.sum())
    if 'uniform' in val:
        low, high = np.array(val['uniform'])
        return float(low + (high - low) * get_rng().random())
    return {key: fix_random_values(x) for key, x in val.items()}


def _wrapped_dilate(plane, size=3):
    return ndimage.maximum_filter(plane, size=size, mode='wrap')


def _anneal_with_retries(board, flags, seeds=None, attempts=10, **kwargs):
    """Run the annealer, relaxing fill bounds on failure.

    Retry policy parity (``proc_gen.py:199-231``): non-convergence lowers
    ``min_fill`` by 6% per attempt; an overfull result raises ``max_fill``
    by 7%; unrecoverable errors return the board unchanged.
    """
    min_fill = kwargs.setdefault('min_fill', 0.2)
    max_fill = kwargs.pop('max_fill', min_fill * 2)
    try:
        out = P.gen_pattern(board, flags, seeds=seeds, **kwargs)
    except P.InsufficientAreaException:
        return board
    except P.MaxIterException:
        if attempts <= 0:
            return board
        kwargs.update(min_fill=min_fill * 0.94, max_fill=max_fill)
        return _anneal_with_retries(board, flags, seeds, attempts - 1,
                                    **kwargs)
    except P.BoardGenException:
        return board
    writable = (flags & P.NEW_CELL_MASK) > 0
    fill = ((out != 0) & writable).sum() / max(writable.sum(), 1)
    if fill > max_fill:
        if attempts <= 0:
            return board
        kwargs.update(min_fill=min_fill, max_fill=1.07 * max_fill)
        return _anneal_with_retries(board, flags, seeds, attempts - 1,
                                    **kwargs)
    return out


class _RegionCanvas:
    """Working state while painting one region, layer by layer.

    Attributes
    ----------
    board : uint16 working cells (everything painted so far).
    flags : per-cell annealer permissions (NEW_CELL / CAN_OSCILLATE /
        INCLUDE_VIOLATIONS) — layers progressively revoke permissions so
        later layers cannot disturb earlier ones.
    to_board / to_goals : selectors deciding which painted cells end up
        on the final board vs the goal board.
    keep_goal_color : cells whose goal keeps its own color (everything
        else painted onto goals is decolored).
    """

    def __init__(self, region):
        region = np.asarray(region, bool)
        shape = region.shape
        halo = _wrapped_dilate(region) ^ region
        self.region = region
        self.flags = (region * _FULL_PERMISSIONS
                      + halo * P.INCLUDE_VIOLATIONS_MASK).astype(np.int32)
        self.board = np.zeros(shape, dtype=np.uint16)
        self.to_board = np.zeros(shape, dtype=bool)
        self.to_goals = np.zeros(shape, dtype=bool)
        self.keep_goal_color = np.zeros(shape, dtype=bool)
        self.seeds = None
        self.deepest_period = 1

    # -- queries ---------------------------------------------------------

    def writable(self, flags=None):
        return ((self.flags if flags is None else flags)
                & P.NEW_CELL_MASK) > 0

    # -- layer features --------------------------------------------------

    def paint_fences(self, fraction):
        fences = build_fence(self.flags & P.NEW_CELL_MASK)
        fences *= coinflip(fraction, fences.shape)
        self.flags &= ~(fences * (P.NEW_CELL_MASK | P.CAN_OSCILLATE_MASK))
        self.board += fences.astype(np.uint16) * C.WALL

    def paint_spawners(self, density, color, writable0, interior):
        rng = get_rng()
        eligible = writable0 & interior
        chosen = eligible & coinflip(density, self.board.shape)
        if not chosen.any() and eligible.any():
            # A spawner region must actually contain a spawner.
            ys, xs = np.nonzero(eligible)
            pick = rng.choice(len(ys))
            chosen[ys[pick], xs[pick]] = True
        self.flags[chosen] ^= P.NEW_CELL_MASK
        self.board[chosen] = C.SPAWNER + color

    def paint_lattice(self, params, color):
        if not isinstance(params, dict):
            params = {}
        h, w = self.board.shape
        stagger = params.get('stagger', True)
        spacing = float(params.get('spacing', 5))
        if not stagger:
            cells = make_lattice(h, w, spacing, spacing, 0)
        elif spacing <= 3:
            cells = make_lattice(h, w, 3, 3, 1)
        elif spacing == 4:
            cells = make_lattice(h, w, 10, 1, 3)
        elif spacing == 5:
            cells = make_lattice(h, w, 13, 1, 5)
        else:
            cells = make_lattice(h, w, 6, 3, 3)
        cells &= self.writable()
        self.board[cells] = C.TREE + color

    def paint_pattern(self, params, color):
        """Anneal a still-life / oscillator layer, then freeze it.

        A generator: yields one anneal request ``(board, flags, seeds,
        params)`` and expects ``send`` to deliver the annealed board (see
        :func:`_drive_requests`). Returns the layer's declared period
        (0 = inert, 1 = still, p >= 2 = oscillator).
        """
        params = dict(params)
        period = params.get('period', 1)
        if period == 1:
            flags = self.flags & ~P.CAN_OSCILLATE_MASK
            params.update(period=self.deepest_period, osc_bonus=0)
        elif period == 0:
            flags = self.flags & ~P.INCLUDE_VIOLATIONS_MASK
            params.update(period=self.deepest_period, osc_bonus=0)
        elif period < self.deepest_period:
            raise ValueError(
                "Periods for sequential layers in a region must be "
                "either 0, 1, or at least as large as prior layers.")
        else:
            flags = self.flags
            self.deepest_period = period

        before = self.board.copy()
        self.board = yield (self.board, flags, self.seeds, params)
        self._freeze_pattern()

        painted = self.board != before
        lifeborn = ((self.board & C.ALIVE) > 0) & painted
        self.board += (color * lifeborn).astype(np.uint16)
        self.seeds = ((self.board & C.ALIVE) > 0) & self.region
        return period

    def _freeze_pattern(self):
        """Revoke permissions over the evolved pattern's support so later
        layers leave it intact: still cells lose writability, oscillating
        cells (and their neighbors) additionally lose oscillation."""
        from ..core.advance_np import advance_board_np

        phases = [self.board.astype(np.int64)]
        for _ in range(1, self.deepest_period):
            phases.append(advance_board_np(phases[-1]))
        support = np.array(phases) != 0
        always = support.all(axis=0)
        sometimes = always ^ support.any(axis=0)
        self.flags[sometimes] &= ~(P.NEW_CELL_MASK
                                   | P.INCLUDE_VIOLATIONS_MASK)
        self.flags[always | _wrapped_dilate(sometimes)] &= \
            ~(P.NEW_CELL_MASK | P.CAN_OSCILLATE_MASK)

    def convert_cells(self, painted, fraction, from_type, bit, sign=+1):
        """Flip a bit on a random ``fraction`` of painted ``from_type``
        cells (movable walls/trees, hardened life)."""
        chosen = coinflip(fraction, self.board.shape) * painted
        chosen *= (self.board & _NOT_RAINBOW) == from_type
        delta = (chosen * bit).astype(np.uint16)
        if sign > 0:
            self.board += delta
        else:
            self.board -= delta

    def apply_buffer(self, cells_wide):
        """Life cells repel later construction by ``cells_wide`` cells."""
        size = cells_wide * 2 + 1
        near_life = _wrapped_dilate((self.board & C.ALIVE) > 0, size)
        self.flags[near_life] &= ~P.NEW_CELL_MASK
        return size

    def route_layer(self, painted, target, period):
        """Record which of this layer's cells go to board vs goals."""
        if target == 'board':
            self.to_board[painted] = True
            if period > 0:
                self.to_goals[painted] = True
        elif target == 'goals':
            self.to_goals[painted] = True
            self.keep_goal_color[painted] = True
            self.to_board[painted & ((self.board & C.ALIVE) == 0)] = True
        elif target == 'both':
            self.to_board[painted] = True
            if period > 0:
                self.to_goals[painted] = True
                self.keep_goal_color[painted] = True
        else:
            raise ValueError("Unexpected value for 'target': %s" % (target,))

    def paint_fountains(self, density, color, buffer_size):
        centers = coinflip(density, self.board.shape) * self.writable()
        halos = _wrapped_dilate(centers) * self.writable()
        self.flags[halos] = P.INCLUDE_VIOLATIONS_MASK
        if buffer_size > 1:
            self.flags[_wrapped_dilate(halos, buffer_size)] &= \
                ~P.NEW_CELL_MASK
        self.board[halos] = C.WALL + color
        self.board[centers] = C.FOUNTAIN + color
        self.to_board[centers] = True
        self.to_goals[halos] = True
        self.keep_goal_color[halos] = True

    # -- output ----------------------------------------------------------

    def render(self):
        """Split the painted cells into (board, goals)."""
        goals = self.board.copy()
        board = self.board * self.to_board
        goals *= self.to_goals
        goals &= ~np.uint16(C.SPAWNING)
        goals &= ~np.uint16(C.RAINBOW_COLOR * ~self.keep_goal_color)
        return board, goals


def host_annealer(board, flags, seeds, **params):
    """The default (host) handler for anneal requests."""
    return _anneal_with_retries(board, flags, seeds, **params)


def _drive_requests(gen, annealer):
    """Run a request generator to completion, answering every yielded
    anneal request with ``annealer(board, flags, seeds, **params)``.
    Returns the generator's return value."""
    try:
        req = next(gen)
        while True:
            board, flags, seeds, params = req
            req = gen.send(annealer(board, flags, seeds, **params))
    except StopIteration as stop:
        return stop.value


def populate_region(mask, layer_params, annealer=host_annealer):
    """Fill one isolated region with layered content. Returns
    (board, goals). Layer schema parity: ``proc_gen.py:241-489``."""
    return _drive_requests(
        populate_region_requests(mask, layer_params), annealer)


def populate_region_requests(mask, layer_params):
    """Generator form of :func:`populate_region`: yields anneal requests
    (so a batched driver can answer them on device) and returns
    (board, goals)."""
    canvas = _RegionCanvas(mask)

    for layer in layer_params:
        if not isinstance(layer, dict):
            raise ValueError("layer_params must be a list of dicts")
        layer = fix_random_values(layer)
        before = canvas.board.copy()
        writable0 = canvas.writable()
        interior = ndimage.minimum_filter(
            writable0, size=3, mode='wrap')
        color = COLORS.get(layer.get('color'), 0)

        if layer.get('fences', 0.0) > 0:
            canvas.paint_fences(layer['fences'])
        if layer.get('spawners', 0) > 0:
            canvas.paint_spawners(layer['spawners'], color, writable0,
                                  interior)
        if layer.get('tree_lattice') is not None:
            canvas.paint_lattice(layer['tree_lattice'], color)

        period = 1
        if 'pattern' in layer:
            period = yield from canvas.paint_pattern(layer['pattern'],
                                                     color)

        painted = canvas.board != before
        if layer.get('movable_walls', 0) > 0:
            canvas.convert_cells(painted, layer['movable_walls'],
                                 C.WALL, C.MOVABLE)
        if layer.get('movable_trees', 0) > 0:
            canvas.convert_cells(painted, layer['movable_trees'],
                                 C.TREE, C.MOVABLE)
        if layer.get('hardened_life', 0) > 0:
            canvas.convert_cells(painted, layer['hardened_life'],
                                 C.LIFE, C.DESTRUCTIBLE, sign=-1)

        buffer_size = canvas.apply_buffer(layer.get('buffer_zone', 0))
        canvas.route_layer(painted, layer.get('target', 'board'), period)

        if layer.get('fountains', 0) > 0:
            canvas.paint_fountains(layer['fountains'], color, buffer_size)

    return canvas.render()


def _resolve_agent_roster(agents, agent_types):
    """Turn the yaml agent roster into concrete cell values and tables."""
    registry = {'default': DEFAULT_AGENT, **agent_types}
    values, tables, names = [], [], []
    for entry in fix_random_values(agents):
        entry = fix_random_values(entry)
        if entry not in registry:
            continue
        spec = {**DEFAULT_AGENT, **registry[entry]}
        val = C.AGENT | C.FROZEN | COLORS.get(spec['color'], 0)
        for flag in spec['flags']:
            val |= AGENT_PROPERTIES.get(flag, 0)
        values.append(val)
        tables.append(np.asarray(spec['points_table']))
        names.append(entry)
    return values, tables, names


def _wrapped_l1_from(locs, shape):
    """Summed toroidal L1 distance from every board cell to ``locs``."""
    h, w = shape
    dy = np.abs(np.arange(h)[:, None] - locs[:, 0])
    dx = np.abs(np.arange(w)[:, None] - locs[:, 1])
    dy = np.minimum(dy, h - dy).sum(axis=-1)
    dx = np.minimum(dx, w - dx).sum(axis=-1)
    return dy[:, None] + dx[None, :]


def add_agents_and_exit(board, regions, agents, agent_types):
    """Place the agent roster in the buffer region and one exit as far
    from the agents as possible. Modifies board and regions in place.
    Placement parity: ``proc_gen.py:492-573``."""
    values, tables, names = _resolve_agent_roster(agents, agent_types)
    if not values:
        return (np.zeros((0, 2), dtype=int), np.zeros((0, 8, 9), dtype=int),
                [])

    buffer_cells = regions == 0
    open_spots = np.argwhere(buffer_cells)
    values = values[:len(open_spots)]  # cannot place more than fits
    agent_locs = open_spots[
        get_rng().choice(len(open_spots), len(values), replace=False)]
    board[tuple(agent_locs.T)] = values

    dist = _wrapped_l1_from(agent_locs, board.shape) * buffer_cells
    exit_loc = np.unravel_index(np.argmax(dist), board.shape)
    board[exit_loc] = C.LEVEL_EXIT | C.COLOR_R

    # Reserve a one-cell margin around agents and exit so no region
    # content is generated adjacent to them.
    reserved = np.concatenate([agent_locs, [exit_loc]])
    offs = np.mgrid[-1:2, -1:2].reshape(2, 9).T
    near = (reserved[:, None] + offs).reshape(-1, 2) % board.shape
    regions[tuple(near.T)] = -1

    return agent_locs, np.array(tables), names


def gen_game(annealer=host_annealer, **params):
    """Generate one random level. Returns a
    :class:`~safelife_tpu_torch.io.levels.Level`.
    Parameter schema parity: ``proc_gen.py:576-687``."""
    return _drive_requests(gen_game_requests(**params), annealer)


def gen_game_requests(board_shape=(25, 25), min_performance=-1,
                      partitioning={}, starting_region=None,
                      later_regions=None, buffer_region=None,
                      named_regions={}, agents=['default'], agent_types={},
                      **etc):
    """Generator form of :func:`gen_game`: yields anneal requests,
    returns the Level."""
    board_shape = tuple(fix_random_values(board_shape))
    min_performance = fix_random_values(min_performance)
    partitioning = fix_random_values(partitioning)

    regions = make_partitioned_regions(board_shape, **partitioning)
    board = np.zeros(board_shape, dtype=np.uint16)
    goals = np.zeros(board_shape, dtype=np.uint16)

    agent_locs, points_table, agent_names = add_agents_and_exit(
        board, regions, agents, agent_types)

    first_pick, later_pick = starting_region, later_regions
    for k in np.unique(regions)[2:]:
        pick = later_pick if first_pick is None else first_pick
        region_name = fix_random_values(pick)
        if region_name not in named_regions:
            continue
        rboard, rgoals = yield from populate_region_requests(
            regions == k, named_regions[region_name])
        board += rboard
        goals += rgoals
        # The starting-region pick is only spent on a region that was
        # actually populated (parity: proc_gen.py consumes it after a
        # successful populate, so an unknown name falls through to the
        # next region).
        first_pick = None

    buffer_pick = fix_random_values(buffer_region)
    if buffer_pick in named_regions:
        rboard, rgoals = yield from populate_region_requests(
            regions == 0, named_regions[buffer_pick])
        board += rboard
        goals += rgoals

    # White-color the buffer goals as a visual hint.
    no_color = (regions <= 0) & ((goals & C.RAINBOW_COLOR) == 0)
    goals[no_color] += C.RAINBOW_COLOR

    board = board.astype(np.int32)
    # Agents start facing right (parity: gen_game passes orientation=1).
    board[tuple(agent_locs.T)] |= 1 << C.ORIENTATION_BIT

    if len(agent_locs) == 0:
        points_table = np.zeros((0, 8, 9), np.int32)
    return Level(
        board=board,
        goals=goals.astype(np.int32),
        agent_locs=np.asarray(agent_locs, np.int64).reshape(-1, 2),
        agent_names=np.array(agent_names),
        points_table=np.asarray(points_table, np.int32).reshape(-1, 8, 9),
        min_performance=float(min_performance),
        spawn_prob=0.3,
        name="procgen",
    )


def stability_mask(board, period=6, remove_agent=True):
    """Mask of separable regions that are stable over ``period`` steps.
    Behavior parity: ``proc_gen.py:690-731``."""
    from ..core.advance_np import advance_board_np

    board = np.asarray(board).astype(np.int64)
    if remove_agent:
        board = board * ((board & C.AGENT) == 0)

    # Roll the CA forward, tracking the phases.
    phases = [board]
    for _ in range(period):
        phases.append(advance_board_np(phases[-1]))
    alive = (np.array(phases) & C.ALIVE) == C.ALIVE
    counts = np.array([
        sum(np.roll(np.roll(a.astype(np.int32), dy, 0), dx, 1)
            for dy in (-1, 0, 1) for dx in (-1, 0, 1))
        for a in alive])

    # Boundary cells split the board into independent components: frozen
    # cells at the end state, plus cells that never interact with life
    # (never alive, never more than 2 live neighbors at any phase).
    final = phases[-1]
    boundary = (final & C.FROZEN) > 0
    boundary |= ~alive.any(axis=0) & (counts.max(axis=0) <= 2)

    labels, n = P.wrapped_label(~boundary)
    stable = np.zeros(board.shape, dtype=bool)
    for k in range(1, n + 1):
        component = labels == k
        if (final[component] == board[component]).all():
            stable |= component
    return stable
