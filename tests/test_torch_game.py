"""The port's host game (``game.py``) against the JAX package's, on the CPU:
the same scripts of named actions, edits (with the reference's quirks),
saves, loads, reverts and board edits leave both games in the same state,
byte for byte, and 20 steps of ``advance_board`` on a level with spawners
under equal NumPy seeds give the same boards. Then the port's game against
the port's own batched env on the CPU, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import random_board  # noqa: E402
from safelife_tpu import game as JG  # noqa: E402
from safelife_tpu.io import levels as JL  # noqa: E402
from safelife_tpu_torch import game as TG  # noqa: E402
from safelife_tpu_torch.core import cells as C  # noqa: E402
from safelife_tpu_torch.core.scoring import DEFAULT_POINTS_TABLE  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402

#: Every attribute a script may change; compared byte for byte.
STATE = ("board", "goals", "agent_locs", "agent_names", "points_table",
         "edit_loc", "edit_color", "num_steps", "game_over",
         "min_performance", "spawn_prob", "initial_counts",
         "initial_colors")


def level(pkg_levels, seed=0, size=(12, 12), spawners=False):
    rng = np.random.default_rng(seed)
    board = random_board(rng, size, density=0.15, spawners=spawners)
    loc = (size[0] // 2, size[1] // 2)
    board[loc] = C.PLAYER
    board[1, 1] = C.LEVEL_EXIT
    goals = np.zeros(size, np.int64)
    goals[2:5, 2:5] = C.COLOR_B
    goals[6:9, 1:4] = C.COLOR_G
    return pkg_levels.Level(
        board=board.astype(np.int32), goals=goals.astype(np.int32),
        agent_locs=np.array([loc]), agent_names=np.array(["agent0"]),
        points_table=np.tile(DEFAULT_POINTS_TABLE, (1, 1, 1)),
        min_performance=0.3, spawn_prob=0.3, name="test")


def games(seed=0, size=(12, 12), spawners=False):
    """The same level in a JAX game and a port game."""
    out = []
    for G, L in ((JG, JL), (TG, TL)):
        g = G.SafeLifeGame(board_size=None)
        g.deserialize(level(L, seed, size, spawners))
        out.append(g)
    return out


def assert_same(jg, tg, what=""):
    for name in STATE:
        a, b = getattr(jg, name), getattr(tg, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
            np.testing.assert_array_equal(a, b, err_msg="%s %s"
                                          % (what, name))
        else:
            assert type(a) is type(b) and a == b, (what, name, a, b)
    for a, b in zip(jg.exit_locs, tg.exit_locs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jg.alive_counts, tg.alive_counts)
    if len(jg.agent_locs):  # both packages' scores need an agent
        np.testing.assert_array_equal(jg.points_earned(),
                                      tg.points_earned())
        np.testing.assert_array_equal(jg.can_exit(), tg.can_exit())


def both(gs, fn):
    outs = [fn(g) for g in gs]
    assert_same(*gs, what=repr(outs[0]))
    return outs


NAMED = ["MOVE DOWN", "FACE LEFT", "MOVE FORWARD", "TURN RIGHT",
         "MOVE BACKWARD", "TOGGLE", "TOGGLE UP", "TURN LEFT", "MOVE UP",
         "MOVE LEFT", "TOGGLE", "FACE DOWN", "MOVE FORWARD",
         "TOGGLE RIGHT", "MOVE RIGHT", "RESTART"]


@pytest.mark.parametrize("seed", [1, 4])
def test_named_actions_and_steps(seed):
    """Named actions interleaved with advances and exit recolouring, then
    numeric actions for each agent."""
    gs = games(seed)
    for k, action in enumerate(NAMED):
        outs = both(gs, lambda g: g.execute_action(action))
        assert outs[0] == outs[1] == 0
        both(gs, lambda g: g.advance_board())
        both(gs, lambda g: g.update_exit_colors())
    for g in gs:
        g.game_over = False
    for a in (0, 1, 2, 3, 4, 5, 6, 7, 8, 2, 2, 3):
        both(gs, lambda g: g.execute_actions(a))
        both(gs, lambda g: g.update_exit_colors())
    assert [g.is_stochastic for g in gs] == [gs[0].is_stochastic] * 2
    np.testing.assert_array_equal(gs[0].current_points(),
                                  gs[1].current_points())
    np.testing.assert_array_equal(gs[0].required_points(),
                                  gs[1].required_points())
    np.testing.assert_array_equal(gs[0].initial_available_points(),
                                  gs[1].initial_available_points())


def test_serialize_save_load_round_trip(tmp_path):
    """Both games serialize to the same dict and save the same file; each
    package loads the other's file into the same game."""
    jg, tg = games(2)
    for g in (jg, tg):
        g.execute_actions(3)
    ja, ta = jg.serialize(), tg.serialize()
    assert sorted(ja) == sorted(ta)
    for key in ja:
        np.testing.assert_array_equal(ja[key], ta[key], err_msg=key)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jpath, tpath = str(tmp_path / "jax" / "lvl"), str(tmp_path / "port"
                                                       / "lvl")
    jg.save(jpath)
    tg.save(tpath)
    assert_same(jg, tg, "saved")
    for a, b in ((jpath, tpath), (tpath, jpath)):
        j2 = JG.SafeLifeGame.load(a + ".npz")
        t2 = TG.SafeLifeGame.load(b + ".npz")
        assert_same(j2, t2, "loaded")
        assert t2.file_name == b + ".npz" and t2.title == "lvl"
    data = np.load(tpath + ".npz")
    j3, t3 = JG.SafeLifeGame.loaddata(data), TG.SafeLifeGame.loaddata(data)
    assert_same(j3, t3, "loaddata")
    lv_j, lv_t = jg.level, tg.level
    for f in ("board", "goals", "agent_locs", "points_table"):
        np.testing.assert_array_equal(getattr(lv_j, f), getattr(lv_t, f))
    assert (lv_j.name, lv_j.min_performance) == (lv_t.name,
                                                 lv_t.min_performance)
    assert isinstance(lv_t, TL.Level)
    assert (jg.title, tg.title) == ("lvl", "lvl")


EDITS = [
    "MOVE RIGHT", "PUT WALL", "NEXT EDIT COLOR", "PUT LIFE",
    "TOGGLE FROZEN", "GOALS PUT WALL", "MOVE FORWARD", "MOVE BACKWARD",
    "PREVIOUS EDIT COLOR", "PREVIOUS EDIT COLOR", "PUT HARD SPAWNER",
    "APPLY EDIT COLOR", "MOVE DOWN", "PUT AGENT", "MOVE LEFT", "PUT CRATE",
    "TOGGLE PUSHABLE", "GOALS APPLY EDIT COLOR", "TELEPORT", "PUT NOTHING",
    "MOVE UP", "PUT EXIT", "NEXT EDIT COLOR", "GOALS PUT TREE",
    "MOVE LEFT", "PUT EMPTY", "TOGGLE AGENT",
]


def test_edits_with_reference_quirks():
    """The edit DSL on both games, the cursor quirks included: FORWARD and
    BACKWARD jump 3 and 5 rows down, an unknown direction raises KeyError,
    unknown commands are ignored; then REVERT and the end-of-level
    commands."""
    gs = games(0)
    for g in gs:
        g.edit_loc = (3, 3)
    for cmd in EDITS:
        outs = both(gs, lambda g: g.execute_edit(cmd))
        assert outs[0] == outs[1], cmd
    h, _ = gs[1].board.shape
    # The quirks themselves, as tests/test_game_cli.py:100 pins them.
    for g in gs:
        g.edit_loc = (3, 3)
        g.execute_edit("MOVE FORWARD")
        assert g.edit_loc == ((3 + 3) % h, 3)
        g.execute_edit("MOVE BACKWARD")
        assert g.edit_loc == ((3 + 3 + 5) % h, 3)
        with pytest.raises(KeyError):
            g.execute_edit("MOVE SIDEWAYS")
    assert_same(*gs, "after quirks")
    assert gs[1].edit_color_name == gs[0].edit_color_name
    outs = both(gs, lambda g: g.execute_edit("REVERT"))
    assert outs[0] == outs[1]
    for cmd in ("ABORT LEVEL", "PREV LEVEL", "NEXT LEVEL"):
        both(gs, lambda g: g.execute_edit(cmd))
        assert gs[1].game_over == cmd
    fresh = [G.SafeLifeGame((6, 7)) for G in (JG, TG)]
    assert_same(*fresh, "fresh")
    for g in fresh:
        del g._init_data
    outs = both(fresh, lambda g: g.execute_edit("REVERT"))
    assert outs[0] == outs[1] == "No saved state; cannot revert."


def test_revert_and_board_edits():
    """revert after steps, then shift, resize (growing, shrinking, dropping
    agents out of bounds) and clip, and their errors."""
    gs = games(5)
    for _ in range(5):
        both(gs, lambda g: g.execute_actions(2))
        both(gs, lambda g: g.advance_board())
    outs = both(gs, lambda g: g.revert())
    assert outs == [True, True] and gs[1].num_steps == 0
    both(gs, lambda g: g.shift_board(2, 3))
    both(gs, lambda g: g.shift_board(-5, 1))
    both(gs, lambda g: g.resize_board(2, -1))
    both(gs, lambda g: g.clip_board(left=1, top=2, right=1))
    both(gs, lambda g: g.resize_board(-6, -5))
    assert len(gs[1].agent_locs) == len(gs[0].agent_locs)
    for g in gs:
        with pytest.raises(ValueError):
            g.resize_board(-g.width, 0)
        with pytest.raises(ValueError):
            g.clip_board(top=g.height)
    blank = [G.SafeLifeGame((8, 10)) for G in (JG, TG)]
    for g in blank:
        g.agent_locs = np.array([[6, 9]])
    both(blank, lambda g: g.resize_board(-4, -4))
    assert len(blank[1].agent_locs) == 0


@pytest.mark.parametrize("seed", [7, 9])
def test_advance_with_spawners_under_equal_seeds(seed):
    """20 steps on a level with spawners (and goals that evolve): the
    seeded generators of both games draw the same stream, spawns included,
    and each advance leaves the same state."""
    gs = games(seed, size=(14, 11), spawners=True)
    for g in gs:
        g.goals[3, 3] = C.SPAWNER | C.COLOR_G
        g.seed = 1000 + seed
    assert gs[1].is_stochastic
    rng = np.random.default_rng(seed)
    for t in range(20):
        a = int(rng.integers(0, 9))
        both(gs, lambda g: g.execute_actions(a))
        both(gs, lambda g: g.advance_board())
        both(gs, lambda g: g.update_exit_colors())
    assert gs[0]._static_goals == gs[1]._static_goals is False
    # A global-generator game (no seed) draws from each package's own
    # utils.rng; swapping in equal generators gives equal steps too.
    from safelife_tpu.utils import rng as JR
    from safelife_tpu_torch.utils import rng as TR

    gs = games(seed, size=(9, 9), spawners=True)
    with JR.set_rng(np.random.default_rng(seed)), \
            TR.set_rng(np.random.default_rng(seed)):
        for _ in range(20):
            both(gs, lambda g: g.advance_board())


def test_game_against_the_ports_env():
    """The port's game and the port's batched env (CPU plain path) evolve a
    deterministic level identically (the counterpart of
    tests/test_game_cli.py:36-61)."""
    from safelife_tpu_torch.env import env as E
    from safelife_tpu_torch.env.state import pack_levels

    g = TG.SafeLifeGame(board_size=None)
    g.deserialize(level(TL, 3))
    pool = pack_levels([g.level], device="cpu")
    cfg = E.EnvConfig(auto_reset=False)
    state, _ = E.reset(cfg, pool, 1)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    for t in range(20):
        a = int(rng.integers(0, 9))
        g.execute_actions(a)
        g.advance_board()
        g.update_exit_colors()
        state, _, _, _, _ = E.step(
            cfg, pool, state, torch.tensor([[a]], dtype=torch.int32), gen)
        np.testing.assert_array_equal(state.board[0].numpy(), g.board,
                                      err_msg=str(t))
        np.testing.assert_array_equal(state.agent_locs[0].numpy(),
                                      g.agent_locs)
