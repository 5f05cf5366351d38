"""The port's plain CA step (safelife_tpu_torch.core.advance) against the
JAX package's (safelife_tpu.core.advance), bit for bit, on the same
numpy-seeded boards."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from safelife_tpu.core import advance as JA, cells as C  # noqa: E402
from safelife_tpu_torch.core import advance as TA  # noqa: E402


def soup(rng, shape, spawners=False):
    """Random boards exercising every cell flag, exits and colours."""
    board = np.zeros(shape, np.int64)
    alive = rng.random(shape) < 0.3
    board |= alive * C.ALIVE
    for flag in (C.PUSHABLE, C.DESTRUCTIBLE, C.FROZEN, C.PRESERVING,
                 C.INHIBITING, C.PULLABLE, C.EXIT):
        board |= (rng.random(shape) < 0.07) * flag
    if spawners:
        board |= (rng.random(shape) < 0.05) * (C.SPAWNING | C.FROZEN)
    board |= rng.integers(0, 8, shape) << C.COLOR_BIT
    return board.astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("spawners", [False, True])
@pytest.mark.parametrize("shape", [(4, 26, 26), (3, 9, 13), (2, 5, 4)])
def test_deterministic_step(shape, spawners):
    rng = np.random.default_rng(hash((shape, spawners)) % 2 ** 31)
    board = soup(rng, shape, spawners)
    ref = np.asarray(JA.advance_board_deterministic(jnp.asarray(board)))
    got = TA.advance_board_deterministic(_t(board)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_injected_spawn_mask(seed):
    rng = np.random.default_rng(100 + seed)
    board = soup(rng, (4, 26, 26), spawners=True)
    mask = rng.random(board.shape) < 0.3
    ref = np.asarray(JA.advance_board_given_spawns(
        jnp.asarray(board), jnp.asarray(mask)))
    got = TA.advance_board_given_spawns(_t(board), _t(mask)).numpy()
    np.testing.assert_array_equal(got, ref)
    # A spawn mask must change spawn-eligible cells only.
    elig = TA.spawn_eligible(_t(board)).numpy()
    np.testing.assert_array_equal(elig, np.asarray(
        JA.spawn_eligible(jnp.asarray(board))))
    det = TA.advance_board_deterministic(_t(board)).numpy()
    assert not ((got != det) & ~elig).any()
    assert ((got != det) & elig).any()


def test_neighborhood_stats():
    rng = np.random.default_rng(5)
    board = soup(rng, (3, 11, 12), spawners=True)
    ref = JA.neighborhood_stats(jnp.asarray(board))
    got = TA.neighborhood_stats(_t(board))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_fast_stochastic_edge_probs(p):
    """p = 0 and p = 1 make the draws irrelevant: exact against JAX."""
    import jax

    rng = np.random.default_rng(7)
    board = soup(rng, (4, 26, 26), spawners=True)
    ref = np.asarray(JA.advance_board(jnp.asarray(board),
                                      jax.random.PRNGKey(0), p))
    gen = torch.Generator().manual_seed(0)
    got = TA.advance_board(_t(board), torch.full((4,), p), gen).numpy()
    np.testing.assert_array_equal(got, ref)
