"""Cell-type bitfield constants for the SafeLife cellular automaton.

Port of ``safelife_tpu/core/cells.py:1-152``: the port keeps its own copy
so that it never imports the JAX package.

Every cell on a SafeLife board is a 16-bit bitfield. Boards are stored as
``int32`` tensors; the semantic payload lives in the low 16 bits and
serialization round-trips through ``uint16`` (see
:mod:`safelife_tpu_torch.io.levels`).

Bit layout (parity: reference ``safelife/safelife_game.py:75-101`` and
``safelife/speedups_src/constants.h:4-33``):

====  ============  =====================================================
bit   flag          meaning
====  ============  =====================================================
0     alive         evolves under the Life rules
1     agent         occupied by an agent
2     pushable      can be pushed by an agent
3     destructible  can be destroyed by an agent
4     frozen        never evolves
5     preserving    neighbors cannot die
6     inhibiting    neighbors cannot be born
7     spawning      stochastically creates live neighbors
8     exit          level exit
9-11  color r/g/b   3-bit cell color (KRGYBMCW order)
12-13 orientation   agent facing (0=up, 1=right, 2=down, 3=left)
15    pullable      can be pulled (out of order for historical reasons)
====  ============  =====================================================
"""

import numpy as np

ALIVE_BIT = 0
AGENT_BIT = 1
PUSHABLE_BIT = 2
DESTRUCTIBLE_BIT = 3
FROZEN_BIT = 4
PRESERVING_BIT = 5
INHIBITING_BIT = 6
SPAWNING_BIT = 7
EXIT_BIT = 8
COLOR_BIT = 9
ORIENTATION_BIT = 12
PULLABLE_BIT = 15

ALIVE = 1 << ALIVE_BIT
AGENT = 1 << AGENT_BIT
PUSHABLE = 1 << PUSHABLE_BIT
DESTRUCTIBLE = 1 << DESTRUCTIBLE_BIT
FROZEN = 1 << FROZEN_BIT
PRESERVING = 1 << PRESERVING_BIT
INHIBITING = 1 << INHIBITING_BIT
SPAWNING = 1 << SPAWNING_BIT
EXIT = 1 << EXIT_BIT
COLOR_R = 1 << COLOR_BIT
COLOR_G = 1 << (COLOR_BIT + 1)
COLOR_B = 1 << (COLOR_BIT + 2)
COLORS = 7 << COLOR_BIT
ORIENTATION_MASK = 3 << ORIENTATION_BIT
PULLABLE = 1 << PULLABLE_BIT

# Composite cell types (reference safelife_game.py:103-123).
EMPTY = 0
FREEZING = INHIBITING | PRESERVING
MOVABLE = PUSHABLE | PULLABLE
# The player is marked "destructible" so that it never contributes to
# producing indestructible cells.
PLAYER = AGENT | FREEZING | FROZEN | DESTRUCTIBLE
WALL = FROZEN
CRATE = FROZEN | MOVABLE
SPAWNER = FROZEN | SPAWNING | DESTRUCTIBLE
HARD_SPAWNER = FROZEN | SPAWNING
LEVEL_EXIT = FROZEN | EXIT
LIFE = ALIVE | DESTRUCTIBLE
RAINBOW_COLOR = COLOR_R | COLOR_G | COLOR_B
ICE_CUBE = FROZEN | FREEZING | MOVABLE
PLANT = FROZEN | ALIVE | MOVABLE
TREE = FROZEN | ALIVE
FOUNTAIN = PRESERVING | FROZEN
PARASITE = INHIBITING | ALIVE | PUSHABLE | FROZEN
WEED = PRESERVING | ALIVE | PUSHABLE | FROZEN
POWERS = ALIVE | FREEZING | SPAWNING

COLOR_NAMES = ('black', 'red', 'green', 'yellow',
               'blue', 'magenta', 'cyan', 'white')

#: Mask of bits that constitute the persisted cell state.
CELL_MASK = 0xFFFF


class CellTypes:
    """Namespace mirroring the reference ``CellTypes`` class API.

    Attributes are plain Python ints (safe to mix with int32 jnp arrays).
    Parity: reference ``safelife/safelife_game.py:38-123``.
    """

    alive_bit = ALIVE_BIT
    agent_bit = AGENT_BIT
    pushable_bit = PUSHABLE_BIT
    pullable_bit = PULLABLE_BIT
    destructible_bit = DESTRUCTIBLE_BIT
    frozen_bit = FROZEN_BIT
    preserving_bit = PRESERVING_BIT
    inhibiting_bit = INHIBITING_BIT
    spawning_bit = SPAWNING_BIT
    exit_bit = EXIT_BIT
    color_bit = COLOR_BIT
    orientation_bit = ORIENTATION_BIT

    alive = ALIVE
    agent = AGENT
    pushable = PUSHABLE
    pullable = PULLABLE
    destructible = DESTRUCTIBLE
    frozen = FROZEN
    preserving = PRESERVING
    inhibiting = INHIBITING
    spawning = SPAWNING
    exit = EXIT
    color_r = COLOR_R
    color_g = COLOR_G
    color_b = COLOR_B
    orientation_mask = ORIENTATION_MASK

    empty = EMPTY
    freezing = FREEZING
    movable = MOVABLE
    player = PLAYER
    wall = WALL
    crate = CRATE
    spawner = SPAWNER
    hard_spawner = HARD_SPAWNER
    level_exit = LEVEL_EXIT
    life = LIFE
    colors = (COLOR_R, COLOR_G, COLOR_B)
    rainbow_color = RAINBOW_COLOR
    ice_cube = ICE_CUBE
    plant = PLANT
    tree = TREE
    fountain = FOUNTAIN
    parasite = PARASITE
    weed = WEED
    powers = POWERS


def to_uint16(board):
    """Convert an int32 device/host board to the uint16 serialization dtype."""
    return np.asarray(board).astype(np.uint16)


def to_int32(board):
    """Convert a uint16 serialized board to the int32 compute dtype."""
    return np.asarray(board).astype(np.int32) & CELL_MASK
