"""The row-sharded board advance (``safelife_tpu_torch/parallel/spatial.py``)
over 2 and 4 ``gloo`` ranks on the CPU, against the JAX package's
``parallel/spatial.py`` on the virtual 8-device mesh and against the
unsharded port, bit for bit: the given-spawns and the deterministic step,
the stochastic step (K2's plain version on each rank's halo slab at its
``cell_offset``) against the unsharded K2 step under the same seed words,
and five such steps. Rank processes: ``torch_ranks.run_ranks``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks as R  # noqa: E402
from conftest import random_board  # noqa: E402
from safelife_tpu.parallel import mesh as JM, spatial as JS  # noqa: E402
from safelife_tpu_torch.core import advance as ADV  # noqa: E402
from safelife_tpu_torch.ops import physics as P  # noqa: E402
from safelife_tpu_torch.parallel import spatial as S  # noqa: E402

SHAPE = (64, 32)
SPAWN_PROB = 0.3


def _inputs():
    rng = np.random.default_rng(20260816)
    board = random_board(rng, shape=SHAPE, spawners=True).astype(np.int32)
    draws = rng.random(SHAPE) < 0.4
    seeds = rng.integers(-2 ** 31, 2 ** 31 - 1, (5, 2)).astype(np.int32)
    return board, draws, seeds


def _unsharded(board, seeds, stochastic=True, steps=1):
    flat = torch.from_numpy(board.reshape(1, -1))
    prob = torch.full((1,), SPAWN_PROB)
    for i in range(steps):
        flat = P.advance(flat, prob, torch.from_numpy(seeds[i]),
                         h=SHAPE[0], w=SHAPE[1], stochastic=stochastic)
    return flat.reshape(SHAPE).numpy()


@pytest.fixture(scope="module")
def jax_reference():
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")
    board, draws, _ = _inputs()
    mesh = JM.make_mesh(8)
    given = JS.advance_sharded_given_spawns(jnp.asarray(board),
                                            jnp.asarray(draws), mesh)
    det = JS.advance_sharded(jnp.asarray(board), jax.random.PRNGKey(0),
                             SPAWN_PROB, mesh, stochastic=False)
    return np.asarray(given), np.asarray(det)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_advance_matches_jax_and_unsharded(world, jax_reference):
    board, draws, seeds = _inputs()
    parts = R.run_ranks(R.spatial, world, board, draws, seeds, SPAWN_PROB)
    got = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    jgiven, jdet = jax_reference
    tboard = torch.from_numpy(board)
    np.testing.assert_array_equal(got["given"], jgiven)
    np.testing.assert_array_equal(got["given"], ADV.advance_board_given_spawns(
        tboard, torch.from_numpy(draws)).numpy())
    np.testing.assert_array_equal(got["deterministic"], jdet)
    np.testing.assert_array_equal(
        got["deterministic"], ADV.advance_board_deterministic(tboard).numpy())
    stoch = _unsharded(board, seeds)
    np.testing.assert_array_equal(got["stochastic"], stoch)
    assert (stoch != got["deterministic"]).any()  # spawns fired
    np.testing.assert_array_equal(got["nstep"],
                                  _unsharded(board, seeds, steps=5))


def test_one_rank_ring_wraps_onto_itself():
    """Without a process group the halos are the board's own last and first
    rows: the sharded step is the toroidal step of the whole board."""
    board, draws, seeds = _inputs()
    tboard = torch.from_numpy(board)
    np.testing.assert_array_equal(
        S.advance_sharded_given_spawns(tboard, torch.from_numpy(draws)),
        ADV.advance_board_given_spawns(tboard, torch.from_numpy(draws)))
    np.testing.assert_array_equal(
        S.advance_sharded(tboard, torch.from_numpy(seeds[0]), SPAWN_PROB),
        _unsharded(board, seeds))
