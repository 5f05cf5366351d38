"""The port's side-effect scoring against the JAX package's, on the CPU:
the cell names, the EMD within 1e-9 (the port's network simplex against the
JAX package's HiGHS LP, and both Sinkhorn solves), the occupancy
counts exactly (``advance_board_nstep``, ``life_occupancy``,
``batched_occupancy``), and the scores of ``episode_side_effects`` and
``side_effect_score`` within 1e-9.

Boards without spawners are deterministic, so the two packages' different
random streams give the same counts. With spawners the port's Philox coins
(``ops.physics.spawn_coins`` for its seed words) are fed to a loop of JAX's
``advance_board_given_spawns``."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu import side_effects as JSE  # noqa: E402
from safelife_tpu.core import advance as JADV  # noqa: E402
from safelife_tpu.render import text as JT  # noqa: E402
from safelife_tpu.training import runner as JR  # noqa: E402
from safelife_tpu_torch import side_effects as TSE  # noqa: E402
from safelife_tpu_torch.core import advance as TADV, cells as C  # noqa: E402
from safelife_tpu_torch.env.env import seed_words  # noqa: E402
from safelife_tpu_torch.ops.physics import spawn_coins  # noqa: E402
from safelife_tpu_torch.render import text as TT  # noqa: E402
from safelife_tpu_torch.training import runner as TR  # noqa: E402

EMD_TOL = 1e-9


def soup(rng, b, h, w, spawners):
    """Boards of coloured life with walls, crates, exits, an agent each, and
    spawners if asked."""
    board = np.zeros((b, h, w), np.int32)
    alive = rng.random((b, h, w)) < 0.3
    board |= alive * (C.LIFE | (rng.integers(0, 8, (b, h, w)) << C.COLOR_BIT))
    for cell, p in ((C.WALL, 0.04), (C.CRATE, 0.03), (C.LEVEL_EXIT, 0.01),
                    (C.TREE, 0.02)):
        board = np.where(rng.random((b, h, w)) < p, cell, board)
    if spawners:
        board = np.where(rng.random((b, h, w)) < 0.03,
                         C.SPAWNER | C.COLOR_G, board)
    board[:, h // 2, w // 2] = C.PLAYER
    return board.astype(np.int32)


def jax_nstep_given_coins(board, coins):
    """JAX's CA stepped under the given coins [T, B, H, W]."""
    b = jnp.asarray(board)
    for c in coins:
        b = JADV.advance_board_given_spawns(b, jnp.asarray(c))
    return np.asarray(b)


def port_coins(seeds, spawn_prob, shape):
    """The port's spawn coins [T, B, H, W] for its seed words."""
    b, h, w = shape
    sp = torch.as_tensor(spawn_prob, dtype=torch.float32).expand(b)
    return np.stack([spawn_coins(s, sp, b, h * w).reshape(b, h, w).numpy()
                     for s in seeds])


def jax_occupancy_given_coins(board, coins):
    b = jnp.asarray(board)
    acc = np.zeros(board.shape + (8,), np.int32)
    for c in coins:
        b = JADV.advance_board_given_spawns(b, jnp.asarray(c))
        bn = np.asarray(b)
        free = ((bn & C.ALIVE) != 0) & ((bn & (C.AGENT | C.EXIT | C.FROZEN))
                                        == 0)
        color = (bn >> C.COLOR_BIT) & 7
        acc += (color[..., None] == np.arange(8)) & free[..., None]
    return acc


# ---------------------------------------------------------------------------
# Names and the EMD


def test_cell_name_tables_match_jax():
    assert TT.CELLTYPE_NAMES == JT.CELLTYPE_NAMES
    assert TT.COLOR_NAMES == JT.COLOR_NAMES
    for cell in range(0, 1 << 16, 7):
        assert TT.cell_name(cell) == JT.cell_name(cell), cell
    for name in ("life-green", "spawner-yellow", "crate-gray", "tree-blue",
                 "hard-spawner-white", "agent-red", "unknown-x"):
        assert TT.name_to_cell(name) == JT.name_to_cell(name), name


def _pair(n_changed, seed, scale_a=1.0, masses="uniform"):
    """Two 26x26 distributions that differ in ``n_changed`` cells.

    ``uniform``: a's uniform masses (times ``scale_a``) on half the cells,
    b's on the others. ``occupancy``: counts over 1000 samples (integers /
    1000, a's up to 1000 ``scale_a``) on both sides of every changed cell,
    and 40 cells equal on both. ``binary``: 0/1 masses, as the frozen types
    give, a's share of the changed cells ``scale_a / (1 + scale_a)``, and 40
    cells 1 on both sides."""
    rng = np.random.default_rng(seed)
    a = np.zeros((26, 26))
    b = np.zeros((26, 26))
    if masses == "uniform":
        idx = rng.choice(676, n_changed, replace=False)
        a.flat[idx[:n_changed // 2]] = rng.random(n_changed // 2) * scale_a
        b.flat[idx[n_changed // 2:]] = rng.random(n_changed - n_changed // 2)
        return a, b
    idx = rng.choice(676, n_changed + 40, replace=False)
    changed, same = idx[:n_changed], idx[n_changed:]
    if masses == "occupancy":
        a.flat[same] = b.flat[same] = rng.integers(1, 1001, 40) / 1000
        ka = rng.integers(0, int(1000 * scale_a) + 1, n_changed)
        kb = rng.integers(0, 1001, n_changed)
        # Changed by at least 5 of 1000: above 1e-3 of the largest change.
        near = np.abs(ka - kb) < 5
        kb[near] = np.where(ka[near] < 500, ka[near] + 5, ka[near] - 5)
        a.flat[changed], b.flat[changed] = ka / 1000, kb / 1000
    else:
        a.flat[same] = b.flat[same] = 1.0
        k = int(round(n_changed * scale_a / (1 + scale_a)))
        a.flat[changed[:k]] = 1.0
        b.flat[changed[k:]] = 1.0
    return a, b


def _case_id(n, seed, scale, masses="uniform"):
    return "-".join(map(str, (n, seed, scale) + (
        () if masses == "uniform" else (masses,))))


EMD_CASES = [
    (1, 0, 1.0), (40, 1, 1.0), (200, 2, 2.5), (340, 3, 1.0),  # exact
    (360, 4, 1.0), (500, 5, 0.4), (676, 6, 1.0),              # Sinkhorn
    # The exact solver at the sizes evaluation meets, on occupancy-like
    # and 0/1 masses, with the surplus on either side.
    (2, 10, 1.0, "occupancy"), (150, 11, 1.0, "occupancy"),
    (302, 12, 1.0, "occupancy"), (350, 13, 1.0, "occupancy"),
    (302, 14, 3.0, "occupancy"), (302, 15, 0.3, "occupancy"),
    (2, 16, 1.0, "binary"), (150, 17, 1.0, "binary"),
    (302, 18, 1.0, "binary"), (350, 19, 1.0, "binary"),
    (150, 20, 2.0, "binary"), (150, 21, 0.5, "binary"),
]


@pytest.mark.parametrize("n,seed,scale,masses", [
    (c + ("uniform",))[:4] for c in EMD_CASES],
    ids=[_case_id(*c) for c in EMD_CASES])
def test_emd_matches_jax(n, seed, scale, masses):
    a, b = _pair(n, seed, scale, masses)
    if masses == "uniform":
        a[0, 0], b[0, 25] = 0.5, 0.7  # the wrap's asymmetric distances
    for x, y in ((a, b), (b, a))[:2 if n <= 40 else 1]:
        ref = JSE.earth_mover_distance(x, y)
        got = TSE.earth_mover_distance(x, y)
        assert abs(got - ref) <= EMD_TOL, (got, ref)
    # The case takes the solver it is listed under, at its size.
    assert TSE.EXACT_EMD_MAX_CELLS == JSE.EXACT_EMD_MAX_CELLS == 350
    delta = np.abs(a - b)
    changed = int((delta > 1e-3 * delta.max()).sum())
    assert (changed > TSE.EXACT_EMD_MAX_CELLS) == (n >= 360)
    if masses != "uniform":
        assert changed == n
        assert (a.sum() > b.sum()) == (scale > 1) or scale == 1


def _grid_costs(n, m, seed):
    """tanh-capped wrapped-manhattan costs from the first n to the first m
    of max(n, m) cells of a 26x26 board, as ``earth_mover_distance`` makes
    them (there n = m: a changed cell's cost to itself is 0)."""
    cells = np.random.default_rng(seed).choice(676, max(n, m),
                                                replace=False)
    y, x = np.divmod(cells, 26)
    dx = np.abs(np.subtract.outer(x[:n], x[:m]))
    dy = np.abs(np.subtract.outer(y[:n], y[:m]))
    d = np.minimum(dx, 26 - dx) + np.minimum(dy, 26 - dy)
    return np.tanh(d / 5.0)


def _occupancy(n, seed, top=1000):
    return np.random.default_rng(seed).integers(0, top + 1, n) / 1000


def _binary(n, ones):
    return (np.arange(n) < ones).astype(float)


EMD_HAT_CASES = {
    "one": lambda: ([1.0], [1.0], [[0.5]], 1.0),
    "surplus": lambda: ([2.0], [1.0], [[0.2]], 1.0),
    "two": lambda: ([1, 1], [1, 1], [[0.1, 0.9], [0.9, 0.1]], 1.0),
    "penalty": lambda: ([3, 0.5], [1, 1, 1],
                        np.linspace(0, 1, 6).reshape(2, 3), 2.0),
    "empty": lambda: ([], [1.0], np.zeros((0, 1)), 1.0),
    "zero": lambda: ([0.0], [0.0], [[1.0]], 1.0),
    # Every cost equal: every plan is optimal (degenerate).
    "equal-costs-occupancy-150": lambda: (
        _occupancy(150, 1), _occupancy(150, 2), np.full((150, 150), 0.5),
        1.0),
    "equal-costs-binary-302": lambda: (
        _binary(302, 151), _binary(302, 140), np.full((302, 302), 0.7), 1.0),
    "zero-row-occupancy-150": lambda: (
        np.where(np.arange(150) == 7, 0.0, _occupancy(150, 3)),
        _occupancy(150, 4), _grid_costs(150, 150, 5), 1.0),
    "surplus-a-40x25": lambda: (
        _occupancy(40, 6, 3000), _occupancy(25, 7), _grid_costs(40, 25, 8),
        1.0),
    "surplus-b-25x40": lambda: (
        _occupancy(25, 9), _occupancy(40, 10, 3000), _grid_costs(25, 40, 11),
        1.0),
    "binary-350": lambda: (
        _binary(350, 200), _binary(350, 200)[::-1], _grid_costs(350, 350, 12),
        1.0),
    "occupancy-350": lambda: (
        _occupancy(350, 13), _occupancy(350, 14), _grid_costs(350, 350, 15),
        1.0),
}


@pytest.mark.parametrize("case", sorted(EMD_HAT_CASES))
def test_emd_hat_cases_match_jax(case):
    a, b, dist, pen = EMD_HAT_CASES[case]()
    assert abs(TSE.emd_hat(a, b, dist, pen)
               - JSE.emd_hat(a, b, dist, pen)) <= EMD_TOL


def test_exact_emd_runs_no_lp(monkeypatch):
    """The exact branch is the native solver: with scipy's LP refused, the
    port still gives the JAX package's HiGHS optimum."""
    import scipy.optimize

    a, b, dist, pen = EMD_HAT_CASES["occupancy-350"]()
    ref = JSE.emd_hat(a, b, dist, pen)

    def refuse(*args, **kwargs):
        raise AssertionError("linprog called")
    monkeypatch.setattr(scipy.optimize, "linprog", refuse)
    assert abs(TSE.emd_hat(a, b, dist, pen) - ref) <= EMD_TOL
    # The solver's own answer, without the penalty.
    assert abs(TSE.exact_transport_cost(a, b, dist)
               + abs(a.sum() - b.sum()) - ref) <= EMD_TOL


def test_exact_emd_refuses_bad_input():
    with pytest.raises(RuntimeError, match="negative or not finite"):
        TSE.exact_transport_cost([1.0, -1.0], [1.0], [[0.0], [1.0]])
    with pytest.raises(RuntimeError, match="negative or not finite"):
        TSE.exact_transport_cost([1.0], [1.0], [[np.nan]])


def test_exact_emd_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build of the solver raises; nothing falls back to an LP
    solver."""
    from safelife_tpu_torch import native

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "GXX_FLAGS",
                        native.GXX_FLAGS + ("-x", "no-such-language"))
    a, b = _pair(40, 1)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        TSE.earth_mover_distance(a, b)
    assert os.listdir(tmp_path) == []


def test_weighted_total_matches_jax():
    se = {"life-green": [2.0, 4.0], "spawner-yellow": [1.0, 1.0],
          "crate-gray": [0.5, 3.0]}
    w = {"life-green": 1.0, "spawner-yellow": 2.0, "tree-blue": 5.0}
    assert TSE.weighted_side_effect_total(se, w) == \
        JSE.weighted_side_effect_total(se, w) == [4.0, 6.0]


# ---------------------------------------------------------------------------
# Occupancy


@pytest.mark.parametrize("shape", [(4, 12, 12), (3, 26, 26)])
def test_nstep_and_occupancy_match_jax_without_spawners(shape):
    board = soup(np.random.default_rng(shape[1]), *shape, spawners=False)
    seeds = seed_words(torch.Generator().manual_seed(0), 9, "cpu")
    tb = torch.from_numpy(board)
    got = TADV.advance_board_nstep(tb, 0.3, seeds)
    ref = JADV.advance_board_nstep(jnp.asarray(board),
                                   jax.random.PRNGKey(0), 0.3, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # A single board without a batch axis, and stochastic off: the same.
    np.testing.assert_array_equal(
        TADV.advance_board_nstep(tb[1], 0.3, seeds, stochastic=False).numpy(),
        np.asarray(ref)[1])

    occ = TADV.life_occupancy(tb, torch.full((shape[0],), 0.3), seeds)
    jocc = JADV.life_occupancy(jnp.asarray(board), jax.random.PRNGKey(1),
                               0.3, 9)
    assert occ.dtype == torch.int32 and occ.shape == shape + (8,)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert occ.sum() > 0


def test_nstep_and_occupancy_match_jax_under_port_coins():
    shape = (3, 12, 12)
    board = soup(np.random.default_rng(5), *shape, spawners=True)
    sp = np.float32([0.3, 1.0, 0.05])
    seeds = seed_words(torch.Generator().manual_seed(1), 12, "cpu")
    coins = port_coins(seeds, sp, shape)
    tb, tsp = torch.from_numpy(board), torch.from_numpy(sp)
    got = TADV.advance_board_nstep(tb, tsp, seeds)
    np.testing.assert_array_equal(got.numpy(),
                                  jax_nstep_given_coins(board, coins))
    occ = TADV.life_occupancy(tb, tsp, seeds)
    np.testing.assert_array_equal(occ.numpy(),
                                  jax_occupancy_given_coins(board, coins))
    # Spawns happened: the coins matter here.
    det = jax_nstep_given_coins(board, np.zeros_like(coins))
    assert (got.numpy() != det).any()


STEPS = np.array([0, 1, 7, 9], np.int32)  # per lane; 9 is the max


def _occupancy_inputs(h, w, spawners, seed):
    rng = np.random.default_rng(seed)
    init = soup(rng, 4, h, w, spawners)
    final = soup(rng, 4, h, w, spawners)
    return init, final, np.float32([0.3, 0.5, 1.0, 0.2])


@pytest.mark.parametrize("hw", [(10, 13), (26, 26)])
def test_batched_occupancy_matches_jax_without_spawners(hw):
    init, final, sp = _occupancy_inputs(*hw, spawners=False, seed=2)
    ns, max_pre = 20, 12
    jin, jac = JR.batched_occupancy(init, final, STEPS, sp,
                                    jax.random.PRNGKey(3), num_samples=ns,
                                    max_pre_steps=max_pre)
    tin, tac = TR.batched_occupancy(
        torch.from_numpy(init), torch.from_numpy(final),
        torch.from_numpy(STEPS), torch.from_numpy(sp),
        torch.Generator().manual_seed(3), num_samples=ns,
        max_pre_steps=max_pre)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(tac.numpy(), np.asarray(jac))


def test_batched_occupancy_matches_jax_under_port_coins():
    """The JAX package's per-lane hold (``runner.py:109-118``) and its
    occupancy, stepped by ``advance_board_given_spawns`` under the port's
    coins; then ``episode_side_effects`` on both packages' counts."""
    init, final, sp = _occupancy_inputs(12, 12, spawners=True, seed=4)
    ns, max_pre = 15, 12
    seeds = seed_words(torch.Generator().manual_seed(5), max_pre + 2 * ns,
                       "cpu")
    tin, tac = TR.batched_occupancy(
        torch.from_numpy(init), torch.from_numpy(final),
        torch.from_numpy(STEPS), torch.from_numpy(sp), None,
        num_samples=ns, max_pre_steps=max_pre, seeds=seeds)

    coins = port_coins(seeds, sp, init.shape)
    b = init
    for t in range(max_pre):
        nb = jax_nstep_given_coins(b, coins[t:t + 1])
        b = np.where((STEPS > t)[:, None, None], nb, b)
    np.testing.assert_array_equal(
        tin.numpy(), jax_occupancy_given_coins(b, coins[max_pre:][:ns]))
    np.testing.assert_array_equal(
        tac.numpy(), jax_occupancy_given_coins(final, coins[max_pre + ns:]))

    weights = {"life-green": 1.0, "spawner-yellow": 2.0}
    inaction, action = tin.numpy(), tac.numpy()
    for lane in range(len(STEPS)):
        args = (init[lane], final[lane], int(STEPS[lane]), float(sp[lane]),
                inaction[lane], action[lane], ns)
        got = TR.episode_side_effects(*args, side_effect_weights=weights)
        ref = JR.episode_side_effects(*args, side_effect_weights=weights)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=EMD_TOL)
        assert got["total"][1] > 0


# ---------------------------------------------------------------------------
# side_effect_score: the JAX package's three scenarios
# (tests/test_side_effects.py:80-114), and include / exclude


def _still_board():
    rng = np.random.default_rng(3)
    board = np.zeros((12, 12), np.int32)
    board |= (rng.random((12, 12)) < 0.2) * (C.ALIVE | C.DESTRUCTIBLE)
    final = board
    for _ in range(5):
        final = np.asarray(JADV.advance_board_deterministic(
            jnp.asarray(final)))
    return board, final


def _destroyed_block():
    board = np.zeros((12, 12), np.int32)
    board[4:6, 4:6] = C.LIFE | C.COLOR_G
    return board, np.zeros_like(board)


def _moved_crate():
    board = np.zeros((10, 10), np.int32)
    board[3, 3] = C.CRATE
    final = np.zeros_like(board)
    final[3, 5] = C.CRATE
    return board, final


@pytest.mark.parametrize("scenario,steps,samples", [
    (_still_board, 5, 50), (_destroyed_block, 5, 50), (_moved_crate, 1, 10)])
def test_side_effect_score_matches_jax(scenario, steps, samples):
    board, final = scenario()
    kw = dict(num_steps=steps, num_samples=samples, strkeys=True)
    ref = JSE.side_effect_score(board, final, key=jax.random.PRNGKey(0), **kw)
    got = TSE.side_effect_score(board, final, device="cpu",
                                generator=torch.Generator().manual_seed(0),
                                **kw)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=EMD_TOL)
    if scenario is _still_board:
        assert all(v[0] == 0 for v in got.values())
    elif scenario is _destroyed_block:
        assert got["life-green"][0] > 3.5 and got["life-green"][1] == 4.0
    else:
        assert abs(got["crate-gray"][0] - np.tanh(2 / 5.0)) <= EMD_TOL


def test_side_effect_score_include_exclude_match_jax():
    rng = np.random.default_rng(8)
    board = soup(rng, 1, 14, 14, spawners=False)[0]
    final = soup(rng, 1, 14, 14, spawners=False)[0]
    for kw in (dict(include=["life-green", "crate-gray"], strkeys=True),
               dict(exclude=["life-red"], strkeys=True),
               dict(include=[C.LIFE | C.COLOR_B], num_runs=3),
               dict(num_steps=0)):
        kw = dict(dict(num_steps=4, num_samples=20), **kw)
        ref = JSE.side_effect_score(board, final,
                                    key=jax.random.PRNGKey(1), **kw)
        got = TSE.side_effect_score(board, final, device="cpu",
                                    generator=torch.Generator(), **kw)
        assert set(got) == set(ref) and got, kw
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=EMD_TOL)
