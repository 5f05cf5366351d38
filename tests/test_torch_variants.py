"""The port's rule variants against the JAX package's, on the CPU: the
``GameOfLife`` and ``AsyncGame`` host classes step for step under equal
NumPy seeds (byte for byte), and the batched ``advance_board_general``
exactly where it draws nothing (no spawners, or ``spawn_prob`` 0), over
leading batch dims, and in distribution where spawners draw."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from conftest import random_board  # noqa: E402
from safelife_tpu import variants as JV  # noqa: E402
from safelife_tpu.utils import rng as JR  # noqa: E402
from safelife_tpu_torch import variants as TV  # noqa: E402
from safelife_tpu_torch.core import cells as C  # noqa: E402
from safelife_tpu_torch.utils import rng as TR  # noqa: E402


def soup(seed, shape=(12, 12), spawners=True):
    return random_board(np.random.default_rng(seed), shape, density=0.3,
                        spawners=spawners)


def pair(cls_name, board, **attrs):
    out = []
    for mod in (JV, TV):
        g = getattr(mod, cls_name)(board.shape)
        g.board = board.copy()
        g.goals = np.zeros_like(board)
        for k, v in attrs.items():
            setattr(g, k, v)
        out.append(g)
    return out


RULES = [((3,), (2, 3)), ((1, 2, 3, 4, 5, 6, 7, 8), tuple(range(9))),
         ((3, 6), (2, 3)), ((2,), (1,))]


@pytest.mark.parametrize("born,survive", RULES)
def test_game_of_life_host(born, survive):
    """20 steps of GameOfLife with spawners under equal seeds."""
    gs = pair("GameOfLife", soup(1), born_rule=born, survive_rule=survive,
              spawn_prob=0.2)
    for g in gs:
        g.seed = 5
    for t in range(20):
        for g in gs:
            g.advance_board()
        np.testing.assert_array_equal(gs[1].board, gs[0].board,
                                      err_msg=str(t))
        assert gs[1].board.dtype == gs[0].board.dtype
        assert gs[1].num_steps == gs[0].num_steps
    assert gs[1].is_stochastic == gs[0].is_stochastic


@pytest.mark.parametrize("rules,temperature,per_update", [
    ("conway", 0.0, 0.3), ("ising", 0.4, 1.0), ("vine", 0.3, 0.5)])
def test_async_game_host(rules, temperature, per_update):
    """AsyncGame draws its sites and coin flips from each package's global
    generator (the reference quirk): equal generators give equal boards,
    and the energy rules round-trip through serialize."""
    board = soup(2, (10, 9))
    gs = pair("AsyncGame", board,
              energy_rules=JV.AsyncGame.energy_rule_sets[rules],
              temperature=temperature, cells_per_update=per_update)
    for g in gs:
        g.seed = 3  # seeds nothing the update reads, as in JAX
    for t in range(5):
        with JR.set_rng(np.random.default_rng(t)):
            gs[0].advance_board()
        with TR.set_rng(np.random.default_rng(t)):
            gs[1].advance_board()
        np.testing.assert_array_equal(gs[1].board, gs[0].board,
                                      err_msg=str(t))
    np.testing.assert_array_equal(
        gs[1]._live_prob_table(len(gs[1].energy_rules[0]) - 1),
        gs[0]._live_prob_table(len(gs[0].energy_rules[0]) - 1))
    ja, ta = gs[0].serialize(), gs[1].serialize()
    assert ta["energy_rules"] == ja["energy_rules"]
    restored = [mod.AsyncGame((10, 9)) for mod in (JV, TV)]
    restored[0].deserialize(ja)
    restored[1].deserialize(ta)
    assert restored[1].energy_rules == restored[0].energy_rules
    bad = TV.AsyncGame((6, 6))
    bad.energy_rules = ((1, 2), (1, 2))
    with pytest.raises(RuntimeError):
        bad.advance_board()


@pytest.mark.parametrize("born,survive", RULES)
@pytest.mark.parametrize("shape", [(12, 12), (3, 7, 9), (2, 2, 5, 6)])
def test_advance_board_general_deterministic(born, survive, shape):
    """No draw matters: soups with spawners at ``spawn_prob`` 0, and
    soups without spawners at 0.3, over any leading batch dims."""
    n = int(np.prod(shape[:-2]))
    for spawners, p in ((True, 0.0), (False, 0.3)):
        board = np.stack([soup(10 + i, shape[-2:], spawners)
                          for i in range(n)]).reshape(shape).astype(np.int32)
        want = np.asarray(JV.advance_board_general(
            board, jax.random.PRNGKey(0), p, born, survive))
        got = TV.advance_board_general(
            torch.from_numpy(board), torch.Generator().manual_seed(0), p,
            born, survive)
        assert got.dtype == torch.int32 and got.shape == board.shape
        np.testing.assert_array_equal(got.numpy(), want)
    # The host class computes the same step.
    host = TV.GameOfLife(shape[-2:])
    host.board = board.reshape((-1,) + shape[-2:])[0].astype(np.int64)
    host.born_rule, host.survive_rule = born, survive
    host.spawn_prob = p
    host.advance_board()
    np.testing.assert_array_equal(host.board, want.reshape(
        (-1,) + shape[-2:])[0])


def test_advance_board_general_spawns_in_distribution():
    """One isolated spawner a board: each of its 8 empty neighbours comes
    alive with probability ``spawn_prob`` (1 - (1 - p)^1) in both
    packages; 4000 boards, 5 sigma."""
    n, p = 4000, 0.3
    board = np.zeros((n, 9, 9), np.int32)
    board[:, 4, 4] = C.SPAWNER
    want = np.asarray(JV.advance_board_general(
        board, jax.random.PRNGKey(1), p))
    got = TV.advance_board_general(
        torch.from_numpy(board), torch.Generator().manual_seed(1), p).numpy()
    sigma = np.sqrt(p * (1 - p) / (8 * n))
    for out in (want, got):
        ring = out[:, 3:6, 3:6].reshape(n, 9)[:, [0, 1, 2, 3, 5, 6, 7, 8]]
        assert ((out & C.ALIVE) > 0).sum() == ((ring & C.ALIVE) > 0).sum()
        assert abs(((ring & C.ALIVE) > 0).mean() - p) < 5 * sigma
        np.testing.assert_array_equal(out[:, 4, 4], C.SPAWNER)
    # Spawned cells take the spawner's colour votes (weight 2) in both.
    np.testing.assert_array_equal(np.unique(got[got != C.SPAWNER]),
                                  np.unique(want[want != C.SPAWNER]))
