"""The device annealer (``procgen/anneal_device.py``), the batched
generator (``procgen/batched.py``) and the iterator's ``device_batch``
path against the JAX package's, on the CPU.

The helpers are exact, so each equals ``anneal_jax``'s bit for bit on the
same random boards, for periods 1 and 2 (``_lane_candidates`` on its 7x7
window path and on its whole-board path). The chains draw from torch
where JAX draws from its own keys, so the annealed patterns are held as
the JAX package's own tests hold them (``tests/test_procgen.py::
TestDeviceAnnealer``): the still-life invariant, the zero-area lane, the
fill distribution against the host annealer, determinism for a seed and
refills in whole rounds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from safelife_tpu.procgen import anneal_jax as AJ  # noqa: E402
from safelife_tpu_torch.core import cells as C  # noqa: E402
from safelife_tpu_torch.core.advance_np import advance_board_np  # noqa: E402
from safelife_tpu_torch.io import iterator as TIT  # noqa: E402
from safelife_tpu_torch.procgen import anneal_device as AD  # noqa: E402
from safelife_tpu_torch.procgen import batched as TB  # noqa: E402
from safelife_tpu_torch.procgen import pattern as TPAT  # noqa: E402
from safelife_tpu_torch.utils.rng import set_rng  # noqa: E402

PENALTIES = np.array([0, 0, 100, 100, 0, 0, 100, 100], np.float32)


def _boards(seed, n, shape):
    """Random boards of the palette, agents and exits, with random mask
    flags: (boards int32 [N, H, W], can_osc bool [N, H, W])."""
    rng = np.random.default_rng(seed)
    cells = list(AJ.CELL_TYPES) + [C.AGENT, C.LEVEL_EXIT | C.COLOR_R]
    boards = rng.choice(cells, size=(n,) + shape,
                        p=[0.4, 0.15, 0.25, 0.1, 0.05, 0.05])
    return boards.astype(np.int32), rng.random((n,) + shape) < 0.5


def _eq(got, ref, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=what)


def test_mask_bits_and_palette_match_jax():
    assert (AD.NEW_CELL_MASK, AD.CAN_OSCILLATE_MASK,
            AD.INCLUDE_VIOLATIONS_MASK, AD.CELL_TYPES) == \
        (AJ.NEW_CELL_MASK, AJ.CAN_OSCILLATE_MASK,
         AJ.INCLUDE_VIOLATIONS_MASK, AJ.CELL_TYPES)


@pytest.mark.parametrize("period", [1, 2])
def test_board_helpers_match_jax(period):
    boards, can_osc = _boards(period, 6, (12, 11))
    jb, tb = jnp.asarray(boards), torch.from_numpy(boards)
    jco, tco = jnp.asarray(can_osc), torch.from_numpy(can_osc)
    alive = (boards & C.ALIVE) > 0
    frozen = (boards & C.FROZEN) > 0
    _eq(AD._count3x3(torch.from_numpy(alive.astype(np.int32))),
        AJ._count3x3(jnp.asarray(alive, jnp.int32)), "count3x3")
    tplanes = AD._alive_planes(torch.from_numpy(alive),
                               torch.from_numpy(frozen), period + 1)
    jplanes = AJ._alive_planes(jnp.asarray(alive), jnp.asarray(frozen),
                               period + 1)
    for k, (t, j) in enumerate(zip(tplanes, jplanes)):
        _eq(t, j, "alive plane %d" % k)
    _eq(AD._violations(tb, tco, period), AJ._violations(jb, jco, period),
        "violations")
    _eq(AD._palette_index(tb), AJ._palette_index(jb), "palette")
    _eq(AD._osc_count(tb, period),
        jax.vmap(lambda b: AJ._osc_count(b, period))(jb), "osc count")
    win = boards[:, :7, :7]
    _eq(AD._window_still_violations(torch.from_numpy(win)),
        jax.vmap(AJ._window_still_violations)(jnp.asarray(win)),
        "window violations")


@pytest.mark.parametrize("period,shape", [(1, (12, 11)), (1, (6, 9)),
                                          (2, (12, 11))])
def test_lane_candidates_match_jax(period, shape):
    """The 7x7 window path (still lifes on boards of at least 7x7) and
    the whole-board path (smaller boards, oscillators)."""
    boards, can_osc = _boards(10 + period, 6, shape)
    rng = np.random.default_rng(period)
    r0 = rng.integers(0, shape[0], 6)
    c0 = rng.integers(0, shape[1], 6)
    # Sites on the board's edges, where the neighbourhood wraps.
    r0[:2], c0[:2] = (0, shape[0] - 1), (shape[1] - 1, 0)
    tpos, tdv, tdo = AD._lane_candidates(
        torch.from_numpy(boards), torch.from_numpy(can_osc),
        torch.from_numpy(r0 * shape[1] + c0), period,
        AD.candidate_tables(*shape, period, "cpu"))
    jpos, jdv, jdo = jax.vmap(
        lambda b, co, r, c: AJ._lane_candidates(b, co, r, c, period))(
        jnp.asarray(boards), jnp.asarray(can_osc), jnp.asarray(r0),
        jnp.asarray(c0))
    _eq(tpos, jpos, "positions")
    assert tdv.dtype == tdo.dtype == torch.float32
    _eq(tdv, jdv, "violation deltas")
    _eq(tdo, jdo, "oscillation deltas")
    if period == 2:
        assert bool(tdo.abs().max() > 0)


def _mask(h=12, w=12):
    mask = np.zeros((h, w), np.int32)
    mask[2:10, 2:10] = AD.NEW_CELL_MASK | AD.INCLUDE_VIOLATIONS_MASK
    mask[1:11, 1:11] |= AD.INCLUDE_VIOLATIONS_MASK
    return mask


def _anneal(n, seed, mask=None):
    mask = _mask() if mask is None else mask
    full = lambda v: torch.full((n,), v)  # noqa: E731
    return AD.anneal_batch(
        torch.zeros((n, 12, 12), dtype=torch.int32),
        torch.from_numpy(np.tile(mask, (n, 1, 1))),
        torch.from_numpy(np.tile((mask & 1) > 0, (n, 1, 1))),
        full(0.2), full(40.0), full(0.5), full(0.0),
        torch.from_numpy(np.tile(PENALTIES, (n, 1))),
        torch.Generator().manual_seed(seed), period=1)


def test_still_life_invariants():
    out, ok, fill = _anneal(12, 3)
    assert ok.all() and (fill >= 0.2).all()
    area = (_mask() & 1) > 0
    for b in out.numpy().astype(np.int64):
        adv = advance_board_np(b)
        nonfrozen = (b & C.FROZEN) == 0
        # A converged still life: the alive plane is a fixed point.
        assert ((adv & 1) == (b & 1))[nonfrozen].all()
        # Writes stay inside the writable area.
        assert (b[~area] == 0).all()


def test_zero_area_lane_fails_cleanly():
    mask = np.stack([_mask(), np.zeros((12, 12), np.int32)])
    boards = np.zeros((2, 12, 12), np.int32)
    boards[1, 5, 5] = C.WALL  # must pass through unchanged
    f = lambda v: torch.full((2,), v)  # noqa: E731
    out, ok = AD.anneal_with_retries_batched(
        torch.from_numpy(boards), torch.from_numpy(mask),
        torch.from_numpy((mask & 1) > 0),
        dict(min_fill=f(0.2), max_fill=f(0.4), max_iter=f(40.0),
             temperature=f(0.5), osc_bonus=f(0.0),
             penalties=torch.from_numpy(np.tile(PENALTIES, (2, 1))),
             period=1),
        torch.Generator().manual_seed(0))
    out, ok = out.numpy(), ok.numpy()
    assert ok[0] and not ok[1]
    assert out[1, 5, 5] == C.WALL
    assert (np.delete(out[1].ravel(), 5 * 12 + 5) == 0).all()


def test_fill_distribution_matches_host():
    mask = _mask()
    out, ok, fill = _anneal(24, 7)
    fill = fill[ok].numpy()
    host_fill = []
    for s in range(24):
        with set_rng(np.random.default_rng(100 + s)):
            hb = TPAT.gen_pattern(
                np.zeros((12, 12), np.uint16), mask, min_fill=0.2,
                max_iter=40, temperature=0.5, alive=(0., 0.),
                wall=(100., 100.), tree=(100., 100.))
        host_fill.append(((hb != 0) & ((mask & 1) > 0)).sum() / 64)
    # Means within 25% relative, as the JAX package's test holds its own
    # annealer: a broken rule or penalty moves the mean further, while
    # both sit near min_fill.
    assert abs(fill.mean() - np.mean(host_fill)) < 0.25 * np.mean(host_fill)


def test_batched_gen_deterministic_and_valid():
    """Equal seeds give equal levels; each level has its agent, one exit
    and a stable start. A chain that cannot converge runs its whole
    budget on every rung of the retry ladder, which takes minutes of
    lockstep iterations on the CPU: seed 0's levels converge early."""
    a, b = (TIT.SafeLifeLevelIterator("random/append-still-easy", seed=0,
                                      device_batch=2, device="cpu")
            for _ in range(2))
    for _ in range(2):
        la, lb = next(a), next(b)
        np.testing.assert_array_equal(la.board, lb.board)
        np.testing.assert_array_equal(la.goals, lb.goals)
        assert len(la.agent_locs) == 1
        assert ((la.board & C.EXIT) > 0).sum() == 1
        assert la.name.startswith("append-still-easy-e")
        board = np.asarray(la.board, np.int64)
        board = board * ((board & C.AGENT) == 0)
        adv = advance_board_np(board)
        assert ((adv & C.ALIVE) == (board & C.ALIVE)).all()


def test_batched_refill_whole_rounds(monkeypatch):
    """The queue refills in whole ``device_batch`` rounds, only once it is
    empty: top-ups on every ``__next__`` would anneal one chain a call.
    The spy answers each round with the host generator on the same level
    streams (the queue's bookkeeping is under test, not the annealer)."""
    from safelife_tpu_torch.procgen.generate import gen_game

    sizes = []

    def spy(param_dicts, rngs, generator):
        sizes.append(len(param_dicts))
        assert generator.device == torch.device("cpu")
        out = []
        for params, rng in zip(param_dicts, rngs):
            with set_rng(rng):
                out.append(gen_game(**params))
        return out

    monkeypatch.setattr(TB, "gen_games_batched", spy)
    it = TIT.SafeLifeLevelIterator("random/append-still-easy", seed=7,
                                   device_batch=4, device="cpu")
    assert it.num_workers == 0 and it.max_queue == 4
    names = [next(it).name for _ in range(8)]
    assert sizes == [4, 4], sizes
    # Each round spawns one seed more, for its chains.
    assert names == ["append-still-easy-e%d" % i
                     for i in (0, 1, 2, 3, 5, 6, 7, 8)], names
