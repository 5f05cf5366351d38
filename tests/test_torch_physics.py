"""Plain versions of kernels K1 (fused_actions_advance) and K2 (advance)
against the JAX package, on the CPU.

The JAX side runs as tests/test_pallas.py pairs it: core.actions
.execute_actions → core.advance.advance_board_deterministic /
advance_board_given_spawns → scoring.agent_cells. The Philox spawn bits
that the kernels share with the plain versions are checked for
determinism per (seed, lane, cell) and against published answers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu.core import (  # noqa: E402
    actions as JAC, advance as JADV, cells as C, scoring as JS)
from safelife_tpu_torch.core import actions as AC  # noqa: E402
from safelife_tpu_torch.ops import physics as P  # noqa: E402


def soup(rng, b, h, w, n_agents, spawners=False):
    """tests/test_pallas.py::_soup: random boards with agents."""
    board = np.zeros((b, h, w), np.int32)
    alive = rng.random((b, h, w)) < 0.2
    board |= alive * (C.ALIVE | C.DESTRUCTIBLE)
    board |= ((rng.random((b, h, w)) < 0.1) * C.FROZEN).astype(np.int32)
    board |= ((rng.random((b, h, w)) < 0.05)
              * (C.PUSHABLE | C.PULLABLE)).astype(np.int32)
    board |= ((rng.random((b, h, w)) < 0.03) * C.EXIT).astype(np.int32)
    board |= (alive * (rng.integers(0, 8, (b, h, w)) << C.COLOR_BIT)
              ).astype(np.int32)
    if spawners:
        board |= ((rng.random((b, h, w)) < 0.02)
                  * (C.SPAWNING | C.FROZEN)).astype(np.int32)
    locs = rng.integers(2, min(h, w) - 2, (b, n_agents, 2)).astype(np.int32)
    for i in range(b):
        for k in range(n_agents):
            board[i, locs[i, k, 0], locs[i, k, 1]] = C.PLAYER
    return board, locs


def _seed(a, b):
    return torch.tensor([a, b], dtype=torch.int32)


@pytest.mark.parametrize("shape", [(26, 26), (7, 5)])
@pytest.mark.parametrize("n_agents", [1, 3])
def test_fused_plain_matches_jax(n_agents, shape):
    rng = np.random.default_rng(3 + n_agents)
    b, (h, w) = 16, shape
    board, locs = soup(rng, b, h, w, n_agents)
    acts = rng.integers(0, 9, (b, n_agents)).astype(np.int32)

    xb, xl = jax.vmap(JAC.execute_actions)(
        jnp.asarray(board), jnp.asarray(locs), jnp.asarray(acts))
    xb = JADV.advance_board_deterministic(xb)
    xc = JS.agent_cells(xb, xl)

    pb, pl, pc = P.fused_actions_advance(
        torch.from_numpy(board.reshape(b, h * w)), torch.from_numpy(locs),
        torch.from_numpy(acts), torch.full((b,), 0.3), _seed(0, 0),
        h=h, w=w, stochastic=False)
    np.testing.assert_array_equal(pb.numpy().reshape(b, h, w),
                                  np.asarray(xb))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(xl))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(xc))


def test_fused_stochastic_plain_matches_injected_coins():
    """With spawners and p = 0.3, K1's plain version equals the JAX
    actions + advance_board_given_spawns fed the same Philox coins."""
    rng = np.random.default_rng(11)
    b, h, w = 8, 26, 26
    board, locs = soup(rng, b, h, w, 2, spawners=True)
    acts = rng.integers(0, 9, (b, 2)).astype(np.int32)
    sp = torch.full((b,), 0.3)
    seed = _seed(-123456789, 987654321)
    coins = P.spawn_coins(seed, sp, b, h * w).numpy().reshape(b, h, w)

    xb, xl = jax.vmap(JAC.execute_actions)(
        jnp.asarray(board), jnp.asarray(locs), jnp.asarray(acts))
    xb = JADV.advance_board_given_spawns(xb, jnp.asarray(coins))
    pb, pl, pc = P.fused_actions_advance(
        torch.from_numpy(board.reshape(b, h * w)), torch.from_numpy(locs),
        torch.from_numpy(acts), sp, seed, h=h, w=w, stochastic=True)
    np.testing.assert_array_equal(pb.numpy().reshape(b, h, w),
                                  np.asarray(xb))
    np.testing.assert_array_equal(pc.numpy(),
                                  np.asarray(JS.agent_cells(xb, xl)))


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_advance_plain_edge_probs(p):
    """p = 0 and p = 1 make the coins certain: exact against JAX."""
    rng = np.random.default_rng(4)
    b, h, w = 16, 26, 26
    board, _ = soup(rng, b, h, w, 1, spawners=True)
    ref = JADV.advance_board(jnp.asarray(board), jax.random.PRNGKey(0), p)
    got = P.advance(torch.from_numpy(board.reshape(b, h * w)),
                    torch.full((b,), p), _seed(7, 8), h=h, w=w,
                    stochastic=True)
    np.testing.assert_array_equal(got.numpy().reshape(b, h, w),
                                  np.asarray(ref))


def test_advance_plain_spawn_fraction():
    """At p = 0.3 about 30% of eligible cells spawn (test_pallas.py:92)."""
    rng = np.random.default_rng(5)
    b, h, w = 16, 26, 26
    board, _ = soup(rng, b, h, w, 1, spawners=True)
    elig = np.asarray(JADV.spawn_eligible(jnp.asarray(board)))
    det = np.asarray(JADV.advance_board_deterministic(jnp.asarray(board)))
    out = P.advance(torch.from_numpy(board.reshape(b, h * w)),
                    torch.full((b,), 0.3), _seed(123, 0), h=h, w=w,
                    stochastic=True).numpy().reshape(b, h, w)
    assert elig.sum() > 500
    frac = ((out != det) & elig).sum() / elig.sum()
    assert 0.25 < frac < 0.35


def test_philox_known_answers():
    """Philox4x32-10 test vectors of the Random123 distribution."""
    def run(ctr, key):
        t = [torch.tensor(v, dtype=torch.int64) for v in ctr + key]
        return [int(x) for x in P.philox4x32(t[:4], t[4:])]

    assert run([0, 0, 0, 0], [0, 0]) == [
        0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    m = 0xFFFFFFFF
    assert run([m, m, m, m], [m, m]) == [
        0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]
    assert run([0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344],
               [0xa4093822, 0x299f31d0]) == [
        0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]


def test_philox_bits_per_seed_lane_cell():
    bits = P.philox_bits(_seed(5, -6), 4, 100)
    again = P.philox_bits(_seed(5, -6), 6, 120)
    # The bits of (lane, cell) do not depend on the batch's extent.
    np.testing.assert_array_equal(bits.numpy(), again[:4, :100].numpy())
    assert bits.min() >= 0 and bits.max() < 2 ** 32
    assert len(np.unique(bits.numpy())) == bits.numel()
    other = P.philox_bits(_seed(5, -5), 4, 100)
    assert (bits != other).float().mean() > 0.99
    # Uniform in mean over many draws.
    u = (P.philox_bits(_seed(1, 2), 64, 676) >> 8).double() / 2 ** 24
    assert abs(float(u.mean()) - 0.5) < 0.01


def small_soup(rng, b, h, w, n_agents):
    """Dense random boards for min(H, W) < 4, with the agents placed next
    to one another (in a row or in a column, wrapping), so that their
    actions touch each other's cells and the four cells of one action
    alias. Agent 0 of board i takes action i mod 9, the others random."""
    shape = (b, h, w)
    board = np.zeros(shape, np.int64)
    alive = rng.random(shape) < 0.3
    board |= alive * (C.ALIVE | C.DESTRUCTIBLE)
    for flag, p in ((C.FROZEN, 0.1), (C.PUSHABLE, 0.2), (C.PULLABLE, 0.15),
                    (C.EXIT, 0.1), (C.DESTRUCTIBLE, 0.1)):
        board |= (rng.random(shape) < p) * flag
    board |= alive * (rng.integers(0, 8, shape) << C.COLOR_BIT)
    locs = np.zeros((b, n_agents, 2), np.int64)
    y0, x0 = rng.integers(0, h, b), rng.integers(0, w, b)
    down = rng.random(b) < 0.5
    for k in range(n_agents):
        locs[:, k, 0] = (y0 + k * down) % h
        locs[:, k, 1] = (x0 + k * ~down) % w
        board[np.arange(b), locs[:, k, 0], locs[:, k, 1]] = C.PLAYER | (
            rng.integers(0, 8, b) << C.COLOR_BIT)
    acts = rng.integers(0, 9, (b, n_agents))
    acts[:, 0] = np.arange(b) % 9
    return (board.astype(np.int32), locs.astype(np.int32),
            acts.astype(np.int32))


SMALL_SHAPES = [(3, 3), (2, 5), (3, 7), (1, 4)]


@pytest.mark.parametrize("shape", SMALL_SHAPES)
@pytest.mark.parametrize("n_agents", [1, 3])
def test_small_boards_fused_matches_jax(n_agents, shape):
    """K1's plain version on boards with min(H, W) < 4 against JAX's
    execute_actions (its aliasing path) → advance_board_deterministic →
    agent_cells, every action on every shape."""
    rng = np.random.default_rng(20 + n_agents + 7 * shape[1])
    b, (h, w) = 36, shape
    board, locs, acts = small_soup(rng, b, h, w, n_agents)
    xb, xl = jax.vmap(JAC.execute_actions)(
        jnp.asarray(board), jnp.asarray(locs), jnp.asarray(acts))
    xb = JADV.advance_board_deterministic(xb)
    xc = JS.agent_cells(xb, xl)

    pb, pl, pc = P.fused_actions_advance(
        torch.from_numpy(board.reshape(b, h * w)), torch.from_numpy(locs),
        torch.from_numpy(acts), torch.full((b,), 0.3), _seed(0, 0),
        h=h, w=w, stochastic=False)
    np.testing.assert_array_equal(pb.numpy().reshape(b, h, w),
                                  np.asarray(xb))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(xl))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(xc))


@pytest.mark.parametrize("shape", SMALL_SHAPES)
@pytest.mark.parametrize("n_agents", [1, 3])
def test_small_boards_execute_actions_matches_jax(n_agents, shape):
    """core.actions.execute_actions alone on the same boards: the aliased
    reads and writes change cells (the check is not vacuous)."""
    rng = np.random.default_rng(40 + n_agents + 7 * shape[1])
    b, (h, w) = 36, shape
    board, locs, acts = small_soup(rng, b, h, w, n_agents)
    xb, xl = jax.vmap(JAC.execute_actions)(
        jnp.asarray(board), jnp.asarray(locs), jnp.asarray(acts))
    tb, tl = AC.execute_actions(torch.from_numpy(board),
                                torch.from_numpy(locs),
                                torch.from_numpy(acts))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(xb))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(xl))
    assert (tb.numpy() != board).any(-1).any(-1).sum() > b // 3


def test_shapes_outside_the_kernels_raise():
    board = torch.zeros((2, 9), dtype=torch.int32)
    with pytest.raises(ValueError):
        P.advance(board, torch.zeros(2), _seed(0, 0), h=4, w=4,
                  stochastic=False)


#: Boards above MAX_CELLS, which take the kernels' global-memory form on
#: the card.
LARGE_SHAPES = [(112, 112), (6, 2100)]


@pytest.mark.parametrize("shape", LARGE_SHAPES)
@pytest.mark.parametrize("stochastic", [False, True])
def test_large_boards_fused_matches_jax(shape, stochastic):
    """K1 on boards above MAX_CELLS against JAX's execute_actions → CA
    step → agent_cells: deterministic, and with spawners at p = 0.3 fed
    the same Philox coins (advance_board_given_spawns)."""
    rng = np.random.default_rng(60 + shape[1] + stochastic)
    b, (h, w) = 2, shape
    assert h * w > P.MAX_CELLS
    board, locs = soup(rng, b, h, w, 2, spawners=stochastic)
    acts = rng.integers(0, 9, (b, 2)).astype(np.int32)
    sp = torch.full((b,), 0.3)
    seed = _seed(-987654321, 123456789)

    xb, xl = jax.vmap(JAC.execute_actions)(
        jnp.asarray(board), jnp.asarray(locs), jnp.asarray(acts))
    if stochastic:
        coins = P.spawn_coins(seed, sp, b, h * w).numpy().reshape(b, h, w)
        assert coins.any()
        xb = JADV.advance_board_given_spawns(xb, jnp.asarray(coins))
    else:
        xb = JADV.advance_board_deterministic(xb)
    pb, pl, pc = P.fused_actions_advance(
        torch.from_numpy(board.reshape(b, h * w)), torch.from_numpy(locs),
        torch.from_numpy(acts), sp, seed, h=h, w=w, stochastic=stochastic)
    np.testing.assert_array_equal(pb.numpy().reshape(b, h, w),
                                  np.asarray(xb))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(xl))
    np.testing.assert_array_equal(pc.numpy(),
                                  np.asarray(JS.agent_cells(xb, xl)))


@pytest.mark.parametrize("shape", LARGE_SHAPES)
@pytest.mark.parametrize("stochastic", [False, True])
def test_large_boards_advance_matches_jax(shape, stochastic):
    """K2 on boards above MAX_CELLS against JAX's CA step: deterministic,
    and with spawners at p = 0.3 fed the same Philox coins."""
    rng = np.random.default_rng(70 + shape[1] + stochastic)
    b, (h, w) = 2, shape
    board, _ = soup(rng, b, h, w, 2, spawners=stochastic)
    sp = torch.full((b,), 0.3)
    seed = _seed(31337, -4242)
    if stochastic:
        coins = P.spawn_coins(seed, sp, b, h * w).numpy().reshape(b, h, w)
        ref = JADV.advance_board_given_spawns(jnp.asarray(board),
                                              jnp.asarray(coins))
    else:
        ref = JADV.advance_board_deterministic(jnp.asarray(board))
    got = P.advance(torch.from_numpy(board.reshape(b, h * w)), sp, seed,
                    h=h, w=w, stochastic=stochastic)
    np.testing.assert_array_equal(got.numpy().reshape(b, h, w),
                                  np.asarray(ref))
    assert (got.numpy() != board.reshape(b, h * w)).any()


@pytest.mark.parametrize("shape,batch,expected", [
    ((26, 26), 4096, (8, 13, 416, 8 * 676 * 8)),
    ((26, 26), 512, (4, 4, 736, 4 * 676 * 8)),
    ((26, 26), 1, (1, 4, 192, 676 * 8)),
    ((3, 3), 7, (7, 4, 32, 7 * 9 * 8)),
    ((2, 5), 7, (6, 4, 32, 6 * 10 * 8)),
    ((1, 4), 512, (8, 4, 32, 8 * 4 * 8)),
    ((3, 3), 4096, (32, 4, 96, 32 * 9 * 8)),
    ((33, 40), 4096, (4, 33, 160, 4 * 1320 * 8)),
    ((96, 128), 7, (1, 4, 1024, 96 * 128 * 8)),
    ((96, 128), 4096, (1, 96, 128, 96 * 128 * 8)),
    ((1, 12288), 2, (1, 4, 1024, 12288 * 8)),
])
def test_launch_shape(shape, batch, expected):
    """Boards per block, rows per thread, threads and shared bytes of
    K1/K2 launches: columns are cut into segments of at least 4 rows while
    the batch has too few columns to fill the card, and the walkers of a
    block's boards fill whole warps where they can, within 1024 threads
    and, for more than one board, 48 KB."""
    assert P.launch_shape(*shape, batch) == expected


@pytest.mark.parametrize("stochastic", [False, True])
def test_lane_offsets_slice_a_global_batch(stochastic):
    """K1 and K2's plain versions on slices of a batch, each launched with
    its first lane as ``lane_offset``, equal the whole batch's call; an
    offset of 0 is the default's coins."""
    rng = np.random.default_rng(21)
    b, h, w = 12, 9, 11
    board, locs = soup(rng, b, h, w, 2, spawners=True)
    acts = torch.from_numpy(rng.integers(0, 9, (b, 2)).astype(np.int32))
    flat = torch.from_numpy(board.reshape(b, h * w))
    locs = torch.from_numpy(locs)
    sp = torch.full((b,), 0.5)
    seed = _seed(-123456789, 987654321)
    kw = dict(h=h, w=w, stochastic=stochastic)
    whole1 = P.fused_actions_advance(flat, locs, acts, sp, seed, **kw)
    whole2 = P.advance(flat, sp, seed, **kw)
    assert torch.equal(P.advance(flat, sp, seed, lane_offset=0,
                                 cell_offset=0, **kw), whole2)
    for lo, hi in ((0, 5), (5, 6), (6, 12)):
        part1 = P.fused_actions_advance(flat[lo:hi], locs[lo:hi],
                                        acts[lo:hi], sp[lo:hi], seed,
                                        lane_offset=lo, **kw)
        for got, ref in zip(part1, whole1):
            assert torch.equal(got, ref[lo:hi])
        assert torch.equal(P.advance(flat[lo:hi], sp[lo:hi], seed,
                                     lane_offset=lo, **kw), whole2[lo:hi])
    if stochastic:  # an offset draws other coins
        shifted = P.advance(flat, sp, seed, lane_offset=1, **kw)
        assert not torch.equal(shifted, whole2)


def test_cell_offset_places_a_slab_at_its_cells():
    """The coins of rows r-1 .. r+k of a board, drawn as a board of their
    own at ``cell_offset = (r - 1) * W``, are the whole board's coins of
    those rows (negative offsets wrap mod 2**32, as in the kernel)."""
    h, w = 10, 7
    seed = _seed(5, -6)
    sp = torch.full((3,), 0.5)
    whole = P.philox_bits(seed, 3, h * w, lane_offset=4).reshape(3, h, w)
    for r, k in ((1, 3), (4, 5)):
        slab = P.philox_bits(seed, 3, (k + 2) * w, lane_offset=4,
                             cell_offset=(r - 1) * w).reshape(3, k + 2, w)
        assert torch.equal(slab, whole[:, r - 1:r + k + 1])
    wrapped = P.philox_bits(seed, 1, 2 * w, cell_offset=-w)
    assert torch.equal(wrapped[:, w:], P.philox_bits(seed, 1, w))
    coins = P.spawn_coins(seed, sp, 3, h * w, 4)
    assert torch.equal(coins, (whole.reshape(3, -1) >> 8).to(torch.float32)
                       * (1.0 / (1 << 24)) < 0.5)
