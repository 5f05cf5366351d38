"""The exact-match oracle step (``core/advance.py::advance_board_oracle``,
``core/pcg64.py``) against the JAX package's, on the CPU.

The JAX package emulates NumPy's PCG64 in 16-bit limbs; the port draws
from the NumPy generator itself. From equal generator states both give
the same boards bit for bit, step after step, and leave the generator in
the same state. The threshold is the spawn probability narrowed to
float32, as the reference's C kernel compares it: where float32 and
float64 round a probability to opposite sides of a draw, the narrowed
threshold decides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu.core import advance as JA, cells as C  # noqa: E402
from safelife_tpu.core import pcg64 as JP  # noqa: E402
from safelife_tpu_torch.core import advance as TA  # noqa: E402
from safelife_tpu_torch.core import pcg64 as TP  # noqa: E402

_STEP = jax.jit(JA.advance_board_oracle)


def _soup(seed, shape=(26, 26)):
    """A random board with life, walls, trees and spawners."""
    rng = np.random.default_rng(seed)
    cells = [C.EMPTY, C.LIFE, C.ALIVE, C.WALL, C.TREE, C.SPAWNER]
    board = rng.choice(cells, size=shape, p=[0.55, 0.15, 0.1, 0.08, 0.07,
                                             0.05])
    return board.astype(np.int32)


def _jax_steps(board, rng, spawn_prob, steps):
    """JAX's oracle for ``steps`` steps from ``rng``'s state; writes the
    emulated state back into ``rng``. Returns every board."""
    state, inc = JP.state_from_numpy(rng)
    k_hi, k_lo = JP.threshold_53(spawn_prob)
    b = jnp.asarray(board)
    out = []
    for _ in range(steps):
        b, state = _STEP(b, state, inc, k_hi, k_lo)
        out.append(np.asarray(b))
    JP.state_to_numpy(rng, state)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_oracle_matches_jax_and_numpy_state(seed):
    board = _soup(seed)
    jrng, trng = (np.random.default_rng(1000 + seed) for _ in range(2))
    ref = _jax_steps(board, jrng, 0.3, 20)
    b = torch.from_numpy(board)
    for t in range(20):
        b = TA.advance_board_oracle(b, trng, 0.3)
        np.testing.assert_array_equal(b.numpy(), ref[t],
                                      err_msg="step %d" % t)
    assert trng.bit_generator.state == jrng.bit_generator.state
    assert trng.random() == jrng.random()
    # The soup spawned: the draws mattered.
    det = torch.from_numpy(board)
    for _ in range(20):
        det = TA.advance_board_deterministic(det)
    assert not torch.equal(det, b)


def _straddling_prob(side):
    """(seed, p) where the generator's first draw ``u`` lies strictly
    between ``p`` and ``float32(p)``: ``side`` "up" has p < u <
    float32(p) (only the narrowed threshold spawns), "down" has
    float32(p) <= u < p."""
    for seed in range(200):
        u = np.random.default_rng(seed).random()
        p = u - 2.0 ** -40 if side == "up" else u + 2.0 ** -40
        narrowed = float(np.float32(p))
        if (side == "up" and narrowed > u) or \
                (side == "down" and narrowed <= u):
            return seed, p
    raise AssertionError("no straddling draw found")


@pytest.mark.parametrize("side", ["up", "down"])
def test_threshold_is_narrowed_to_float32(side):
    seed, p = _straddling_prob(side)
    assert TP.spawn_threshold(p) == float(np.float32(p)) != p
    board = np.zeros((9, 9), np.int32)
    board[4, 4] = C.SPAWNER
    # The spawner's eight neighbours draw in raster order: (3, 3) first.
    elig = TA.spawn_eligible(torch.from_numpy(board))
    assert int(elig.sum()) == 8 and bool(elig[3, 3])
    ref = _jax_steps(board, np.random.default_rng(seed), p, 1)[0]
    got = TA.advance_board_oracle(torch.from_numpy(board),
                                  np.random.default_rng(seed), p)
    np.testing.assert_array_equal(got.numpy(), ref)
    spawned = bool(got[3, 3] & C.ALIVE)
    assert spawned == (side == "up")
    # A float64 threshold would have decided the other way.
    assert (np.random.default_rng(seed).random() < p) != spawned


def test_oracle_needs_pcg64():
    board = torch.from_numpy(_soup(0, (9, 9)))
    with pytest.raises(ValueError, match="PCG64"):
        TA.advance_board_oracle(
            board, np.random.Generator(np.random.MT19937(0)), 0.3)
