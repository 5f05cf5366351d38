"""Experimental cellular-automata rule variants.

Port of ``safelife_tpu/variants.py:1-253`` (reference
``safelife/safelife_game.py:768-936``): ``_variant_step_np``,
``GameOfLife`` (arbitrary Born/Survive rules; its colour consensus,
destructibility inheritance and spawn-probability compounding
*intentionally* differ from the main CA rules), ``AsyncGame``
(asynchronous single-cell updates with an energy/temperature rule,
including the Ising and vine rule sets) and ``advance_board_general``.

The host classes play NumPy boards like :class:`.game.SafeLifeGame`;
:func:`advance_board_general` is the batched formulation of the
GameOfLife rules on torch tensors, on the board's device. JAX computes it
in plain ``jnp`` outside any Pallas kernel, and so does the port in plain
torch.
"""

import numpy as np
import torch

from .core import cells as C
from .game import SafeLifeGame
from .utils.rng import coinflip, get_rng

_NEIGHBORHOODS = {
    4: np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]]),   # Von Neumann
    6: np.array([[0, 1, 1], [1, 0, 1], [1, 1, 0]]),   # hexagonal
    8: np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]]),   # Moore
}


def _variant_step_np(board, draw, spawn_prob, born_rule, survive_rule):
    """One GameOfLife-variant step (numpy twin of
    :func:`advance_board_general`; both encode the rule spec below).

    Rule spec (this variant *intentionally* differs from the canonical C
    kernel in its consensus and spawn compounding):

    * dead cell -> born when its Moore-neighbor count is in
      ``born_rule``, or by spawning with probability ``1 - (1-p)^k`` over
      k spawner neighbors; blocked by frozen self or inhibiting neighbor.
    * live cell -> dies when its count is outside ``survive_rule``;
      blocked by frozen self or preserving neighbor. Death clears every
      bit of the cell.
    * newborn color: per RGB channel, weighted neighborhood votes (live
      cell = 1, spawner = 2) pass at >= 2.
    * newborn destructibility: destructible unless >= 2 indestructible
      live neighbors.

    ``draw`` is a uniform [0,1) field used for the spawn test.
    """
    def ring(x):
        cols = np.roll(x, 1, -1) + np.roll(x, -1, -1)
        rows = x + cols
        return np.roll(rows, 1, -2) + np.roll(rows, -1, -2) + cols

    alive = (board & C.ALIVE) > 0
    spawning = (board & C.SPAWNING) > 0
    frozen = (board & C.FROZEN) > 0

    can_die = ~frozen & (ring(board & C.PRESERVING) == 0)
    can_grow = ~frozen & (ring(board & C.INHIBITING) == 0)

    nn = ring(alive.astype(np.int64))
    ns = ring(spawning.astype(np.int64))
    has_spawned = draw < 1 - (1 - spawn_prob) ** ns

    born = np.zeros(9, bool)
    born[list(born_rule)] = True
    dies = np.ones(9, bool)
    dies[list(survive_rule)] = False

    new_alive = (born[nn] | has_spawned) & ~alive & can_grow
    new_dead = dies[nn] & alive & can_die

    new_flags = np.zeros_like(board)
    weights = 1 * alive + 2 * spawning
    for color in (C.COLOR_R, C.COLOR_G, C.COLOR_B):
        votes = ring(((board & color) > 0) * weights)
        new_flags += color * (votes >= 2)
    indestructible = alive & ((board & C.DESTRUCTIBLE) == 0)
    new_flags += C.DESTRUCTIBLE * (ring(indestructible.astype(np.int64)) < 2)

    out = board * ~(new_alive | new_dead)
    return (out + new_alive * (C.ALIVE + new_flags)).astype(board.dtype)


class GameOfLife(SafeLifeGame):
    """SafeLife with configurable Born/Survive rules (classic Conway is
    B3/S23). Role parity: reference ``GameOfLife``
    (safelife_game.py:768-838); the step itself is :func:`_variant_step_np`.
    """

    survive_rule = (2, 3)
    born_rule = (3,)

    def advance_board(self):
        self.num_steps += 1
        self._needs_new_counts = True
        self.board = _variant_step_np(
            self.board, self.rng.random(self.board.shape), self.spawn_prob,
            self.born_rule, self.survive_rule)
        # Goals do not evolve in this variant (matching the reference,
        # whose GameOfLife.advance_board only touches the board).

    @property
    def is_stochastic(self):
        return bool((self.board & C.SPAWNING).any())


class AsyncGame(SafeLifeGame):
    """Asynchronous single-cell updates with an energy rule + temperature.

    Parity: reference ``AsyncGame`` (safelife_game.py:845-936): each board
    update performs ``cells_per_update * board.size`` random single-cell
    updates; a cell flips alive/dead with probability
    ``sigmoid-like 0.5 + 0.5*tanh(H / T)`` where H is the energy gain from
    living given the live-neighbor count, further compounded by spawner
    neighbors.
    """

    energy_rule_sets = {
        'conway': (
            (-1, -1, +1, +1, -1, -1, -1, -1, -1),
            (-1, -1, -1, +1, -1, -1, -1, -1, -1),
        ),
        'ising': (
            (-2, -1, 0, +1, +2),
            (-2, -1, 0, +1, +2),
        ),
        'vine': (
            (-1, -1, +1, +1, +1),
            (-1, +1, -1, -1, -1),
        ),
    }
    energy_rules = energy_rule_sets['conway']
    temperature = 0
    cells_per_update = 0.3

    def serialize(self):
        data = super().serialize()
        data['energy_rules'] = self.energy_rules
        return data

    def deserialize(self, data, as_initial_state=True):
        super().deserialize(data, as_initial_state)
        if 'energy_rules' in data:
            self.energy_rules = tuple(
                tuple(int(v) for v in row) for row in
                np.asarray(data['energy_rules']))

    def _live_prob_table(self, n_neighbors):
        """P(site ends alive | was_dead/alive, #alive nbrs, #spawner nbrs).

        The flip probability depends on the site only through three small
        integers, so the whole rule collapses into one precomputed
        [2, n+1, n+1] table: a thermal acceptance ``0.5 + tanh(H/T)/2``
        of the energy gain for living, compounded toward life once per
        spawning neighbor (each contributes an independent spawn_prob
        chance).
        """
        rules = np.asarray(self.energy_rules, float)  # [2, n+1]
        beta = 1.0 / max(1e-20, self.temperature)
        p_thermal = 0.5 + 0.5 * np.tanh(rules * beta)
        # Row 0 applies to live sites, row 1 to dead sites.
        spawn_boost = (1.0 - self.spawn_prob) ** np.arange(n_neighbors + 1)
        return 1.0 - (1.0 - p_thermal[:, :, None]) * spawn_boost

    def advance_board(self):
        self.num_steps += 1
        self._needs_new_counts = True
        board = self.board
        h, w = board.shape
        n_neighbors = len(self.energy_rules[0]) - 1
        if n_neighbors not in _NEIGHBORHOODS:
            raise RuntimeError("async rules must have length 5, 7, or 9")
        # Flat-index neighbor offsets for the chosen neighborhood, and the
        # per-(state, counts) live-probability table.
        dy, dx = np.nonzero(_NEIGHBORHOODS[n_neighbors])
        dy, dx = dy - 1, dx - 1
        p_live = self._live_prob_table(n_neighbors)

        rng = get_rng()
        n_updates = int(board.size * self.cells_per_update)
        # All site coordinates drawn up front (one vectorized draw); the
        # commits stay strictly sequential — update k sees update k-1's
        # write, which is what makes the dynamics asynchronous.
        #
        # Stream-parity note: the reference (safelife_game.py:896-936)
        # draws x then y per site, interleaved with the acceptance
        # coinflips, so same-seed AsyncGame trajectories diverge from it.
        # That is intentional and out of scope — AsyncGame is an
        # experimental variant with no golden tests or benchmark levels;
        # the dynamics are distributionally identical (same uniform site
        # law, same per-site acceptance probabilities). Everything with
        # parity stakes (the CA kernel's stochastic spawns) stays
        # bit-exact via the PCG64 emulator instead.
        sites = rng.integers(0, (h, w), size=(n_updates, 2))
        for y, x in sites:
            site = board[y, x]
            if site & C.FROZEN:
                continue
            nbrs = board[(y + dy) % h, (x + dx) % w]
            if (nbrs & C.FREEZING).any():
                continue
            n_alive = int(((nbrs & C.ALIVE) > 0).sum())
            n_spawn = int(((nbrs & C.SPAWNING) > 0).sum())
            was_alive = 0 if site & C.ALIVE else 1
            p = p_live[was_alive, n_alive, n_spawn]
            board[y, x] = C.LIFE if coinflip(p) else C.EMPTY


def advance_board_general(board, generator, spawn_prob, born_rule=(3,),
                          survive_rule=(2, 3)):
    """Batched GameOfLife-variant advance on the board's device.

    Same rules as :class:`GameOfLife`, over any leading batch dims; the
    spawn draws are independent per-cell uniforms from ``generator`` (a
    ``torch.Generator`` on the board's device), where JAX takes a key.

    board: int32[..., H, W]; spawn_prob: float. Returns int32[..., H, W].
    """
    def conv(x):
        r = torch.roll(x, 1, -1) + torch.roll(x, -1, -1)
        rows = x + r
        return (torch.roll(rows, 1, -2) + torch.roll(rows, -1, -2) + r)

    dev, dtype = board.device, board.dtype
    alive = (board & C.ALIVE) > 0
    spawning = (board & C.SPAWNING) > 0
    frozen = (board & C.FROZEN) > 0

    can_die = ~frozen & (conv(board & C.PRESERVING) == 0)
    can_grow = ~frozen & (conv(board & C.INHIBITING) == 0)

    nn = conv(alive.to(torch.int32))
    ns = conv(spawning.to(torch.int32))
    keep = 1 - torch.tensor(spawn_prob, dtype=torch.float32, device=dev)
    sp = 1 - keep ** ns
    has_spawned = torch.rand(board.shape, generator=generator,
                             device=dev) < sp

    born = torch.zeros(9, dtype=torch.bool, device=dev)
    born[list(born_rule)] = True
    dead = torch.ones(9, dtype=torch.bool, device=dev)
    dead[list(survive_rule)] = False

    new_alive = (born[nn] | has_spawned) & ~alive & can_grow
    new_dead = dead[nn] & alive & can_die

    new_flags = torch.zeros_like(board)
    weights = alive.to(dtype) + 2 * spawning.to(dtype)
    for color in (C.COLOR_R, C.COLOR_G, C.COLOR_B):
        votes = conv(((board & color) > 0).to(dtype) * weights)
        new_flags += color * (votes >= 2).to(dtype)
    indestructible = alive & ((board & C.DESTRUCTIBLE) == 0)
    new_flags += C.DESTRUCTIBLE * (
        conv(indestructible.to(torch.int32)) < 2).to(dtype)

    out = board * (~(new_alive | new_dead)).to(dtype)
    return out + new_alive.to(dtype) * (C.ALIVE + new_flags)
