"""The port's front end against the JAX package's, on the CPU: the
``print``, ``new`` and ``render`` verbs, the archive tools (byte-identical
levels), ``play`` through ``GameLoop`` keys with its recording and its
end-of-level summary (side effects within 1e-9 of JAX's on a level without
spawners), the pygame loop headless, and the loggers' episode videos."""

import argparse
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
imageio = pytest.importorskip("imageio")

import jax  # noqa: E402, F401  (JAX on the CPU before the JAX modules)

from safelife_tpu import __main__ as JM  # noqa: E402
from safelife_tpu import interactive as JI  # noqa: E402
from safelife_tpu.io import iterator as JIT  # noqa: E402
from safelife_tpu_torch import __main__ as TM  # noqa: E402
from safelife_tpu_torch import interactive as TI  # noqa: E402
from safelife_tpu_torch.core import cells as C  # noqa: E402
from safelife_tpu_torch.core.scoring import DEFAULT_POINTS_TABLE  # noqa: E402
from safelife_tpu_torch.io import iterator as TIT, levels as TL  # noqa: E402

#: Keys that play ``play_level`` to its end: step up to the green block,
#: destroy two of its cells (the rest dies), walk round to the exit.
KEYS = ["UP", " ", "LEFT", "UP", " ", "c", "RIGHT", "RIGHT", "RIGHT",
        "DOWN", "RIGHT"]


def play_level(path, n=10):
    """A level without spawners: the agent in the middle facing up, a
    green block (a still life) on green goals above it, an exit to its
    right, and no points needed to leave."""
    c = n // 2
    board = np.zeros((n, n), np.int32)
    goals = np.zeros((n, n), np.int32)
    board[c, c] = C.PLAYER
    board[c - 3:c - 1, c - 1:c + 1] = C.LIFE | C.COLOR_G
    goals[c - 4:c, c - 2:c + 2] = C.COLOR_G
    board[c, c + 3] = C.LEVEL_EXIT
    TL.save_level(TL.Level(
        board=board, goals=goals, agent_locs=np.array([[c, c]]),
        agent_names=np.array(["agent0"]),
        points_table=DEFAULT_POINTS_TABLE[None].astype(np.int32),
        min_performance=0.0, spawn_prob=0.3, name="play-still"), path)
    return path


def close(got, ref, what=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            close(got[k], ref[k], "%s.%s" % (what, k))
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9, err_msg=what)


def stdout_of(fn, capsys):
    capsys.readouterr()
    fn()
    return capsys.readouterr().out


def test_print(capsys):
    for argv in (["random/append-still", "--seed", "1", "-n", "2"],
                 ["benchmarks/v1.0/prune-spawn.npz", "-n", "3"]):
        ns = argparse.Namespace(paths=[argv[0]], seed=None, num=1)
        ns.seed = int(argv[argv.index("--seed") + 1]) \
            if "--seed" in argv else None
        ns.num = int(argv[argv.index("-n") + 1])
        want = stdout_of(lambda: JM.cmd_print(ns), capsys)
        got = stdout_of(lambda: TM.main(["print"] + argv), capsys)
        assert got == want and want.count("#") >= ns.num


def _files(d):
    return sorted(os.listdir(d))


def assert_same_level_files(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files), (a, b)
        for k in x.files:
            assert x[k].dtype == y[k].dtype, (a, k)
            np.testing.assert_array_equal(x[k], y[k], err_msg="%s %s"
                                          % (a, k))


@pytest.mark.parametrize("out,num,archive", [
    ("one.npz", 1, False), ("many", 3, False), ("packed.npz", 2, True),
    ("implied.npz", 2, False)])
def test_new(tmp_path, capsys, out, num, archive):
    """One file, a directory, ``--archive``, and an ``.npz`` name with
    ``-n`` > 1 (an archive too): the JAX CLI's files, byte for byte."""
    paths = {}
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        paths[pkg] = str(tmp_path / pkg / out)
    ns = argparse.Namespace(param_file="random/prune-still",
                            out=paths["jax"], num=num, seed=4,
                            archive=archive)
    JM.cmd_new(ns)
    TM.main(["new", "random/prune-still", paths["port"], "-n", str(num),
             "--seed", "4"] + (["--archive"] if archive else []))
    assert "wrote" in capsys.readouterr().out
    if os.path.isdir(paths["jax"]):
        assert _files(paths["port"]) == _files(paths["jax"])
        pairs = [(os.path.join(paths["jax"], f),
                  os.path.join(paths["port"], f))
                 for f in _files(paths["jax"])]
    else:
        pairs = [(paths["jax"], paths["port"])]
    for a, b in pairs:
        assert_same_level_files(a, b)
    assert len(TL.load_levels(paths["port"])) == num


def test_render(tmp_path, capsys):
    """``render`` of a level (png) and with ``--steps`` (a gif): equal
    frames to the JAX CLI's."""
    levels = TL.load_levels("benchmarks/v1.0/prune-dynamic.npz")[:1]
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        TL.save_level(levels[0], str(tmp_path / pkg / "lvl.npz"))
    JM.cmd_render(argparse.Namespace(paths=[str(tmp_path / "jax/lvl.npz")],
                                     steps=0, fmt=None))
    TM.main(["render", str(tmp_path / "port/lvl.npz")])
    JM.cmd_render(argparse.Namespace(paths=[str(tmp_path / "jax/lvl.npz")],
                                     steps=2, fmt="gif"))
    TM.main(["render", str(tmp_path / "port/lvl.npz"), "--steps", "2",
             "--fmt", "gif"])
    assert "rendered" in capsys.readouterr().out
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "lvl-lvl.gif", "lvl-lvl.png", "lvl.npz"]
    for f in ("lvl-lvl.gif", "lvl-lvl.png"):
        np.testing.assert_array_equal(
            np.stack(imageio.mimread(str(tmp_path / "port" / f))),
            np.stack(imageio.mimread(str(tmp_path / "jax" / f))))


def test_archive_tools(tmp_path):
    """gen_many -> combine_levels -> expand_levels: the same files and the
    same archive as JAX's, byte for byte; a resumed gen_many keeps what
    exists."""
    outs = {}
    for pkg, mod in (("jax", JIT), ("port", TIT)):
        d = str(tmp_path / pkg / "gen")
        mod.gen_many("random/append-still", d, 3, num_workers=0, seed=7)
        os.remove(os.path.join(d, "gen-2.npz"))
        mod.gen_many("random/append-still", d, 3, num_workers=0, seed=7)
        arch = mod.combine_levels(d)
        exp = mod.expand_levels(arch, str(tmp_path / pkg / "expanded"))
        outs[pkg] = (d, arch, exp)
    (jd, ja, je), (td, ta, te) = outs["jax"], outs["port"]
    assert _files(td) == _files(jd) == ["gen-1.npz", "gen-2.npz",
                                        "gen-3.npz"]
    for f in _files(jd):
        assert_same_level_files(os.path.join(jd, f), os.path.join(td, f))
    assert os.path.basename(ta) == "gen.npz"
    assert_same_level_files(ja, ta)
    assert _files(te) == _files(je) == _files(jd)
    for f in _files(je):
        assert_same_level_files(os.path.join(je, f), os.path.join(te, f))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        TIT.combine_levels(str(tmp_path / "empty"))


def test_gen_benchmarks(tmp_path):
    """Two tasks, two levels each, into an explicit ``out_dir``: JAX's
    archives, byte for byte; an existing archive is kept. The port has no
    default ``out_dir`` (JAX's lies in its own level tree)."""
    tasks = ("append-still", "prune-spawn")
    jouts = JIT.gen_benchmarks(str(tmp_path / "jax"), tasks=tasks, num=2,
                               num_workers=0)
    touts = TIT.gen_benchmarks(str(tmp_path / "port"), tasks=tasks, num=2,
                               num_workers=0)
    assert [os.path.basename(p) for p in touts] == \
        [os.path.basename(p) for p in jouts] == ["append-still.npz",
                                                 "prune-spawn.npz"]
    for a, b in zip(jouts, touts):
        assert_same_level_files(a, b)
    names = [lv.name for lv in TL.load_levels(touts[1])]
    assert names == ["prune-spawn-001.npz", "prune-spawn-002.npz"]
    stamp = os.stat(touts[0]).st_mtime_ns
    assert TIT.gen_benchmarks(str(tmp_path / "port"), tasks=tasks[:1],
                              num=5, num_workers=0) == touts[:1]
    assert os.stat(touts[0]).st_mtime_ns == stamp
    with pytest.raises(TypeError):
        TIT.gen_benchmarks()


def _played(mod, level, record_to, **kw):
    it = mod.SafeLifeLevelIterator(level, seed=1)
    loop = mod.GameLoop(it, record_to=record_to, **kw)
    loop.next_level(+1)
    for key in KEYS:
        assert not loop.game.game_over
        loop.handle_play_key(key)
    assert loop.game.game_over is True
    return loop


def test_play_summary_and_recording(tmp_path):
    """The scripted keys end the level in both packages' GameLoop; the
    end-of-level summary (side effects with ``num_samples`` 200, the
    weighted total, the combined score) equals JAX's within 1e-9; the
    recordings are equal; undo, restart and the edit keys act alike."""
    level = play_level(str(tmp_path / "play-still.npz"))
    loops = [_played(JI, level, str(tmp_path / "jrec")),
             _played(TI, level, str(tmp_path / "trec"), device="cpu")]
    for a, b in (("board", "board"), ("agent_locs", "agent_locs")):
        np.testing.assert_array_equal(getattr(loops[1].game, b),
                                      getattr(loops[0].game, a))
    (jse, jscore), (tse, tscore) = [lp.end_of_level_summary()
                                    for lp in loops]
    close(tse, jse, "side effects")
    close(tscore, jscore, "score")
    assert tse["life-green"][0] > 0 and tse["total"][0] > 0
    paths = [lp.save_recording() for lp in loops]
    assert os.path.basename(paths[1]) == "rec-001.npz"
    with np.load(paths[0]) as j, np.load(paths[1]) as t:
        assert t["board"].shape[0] == len(KEYS) + 1
        for k in ("board", "goals", "agent_locs"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)

    # Undo, restart and edits through the keys.
    for lp in loops:
        lp.game.game_over = False
        for key in ("z", "z", "r", "UP", "e"):
            if key == "e":
                lp.edit_mode = True
            else:
                lp.handle_play_key(key)
        for key in ("RIGHT", "4", "]", "x", "g", "2", "[", "DOWN", "a"):
            lp.handle_edit_key(key)
    for a in ("board", "goals", "agent_locs", "edit_loc", "edit_color"):
        np.testing.assert_array_equal(getattr(loops[1].game, a),
                                      getattr(loops[0].game, a), err_msg=a)
    assert loops[1].message == loops[0].message


def test_play_verb_with_record(tmp_path, monkeypatch, capsys):
    """``python -m safelife_tpu_torch play LEVEL --record DIR --device
    cpu`` played by the same keys, then ``q``: the level ends, its summary
    is printed, and the recording holds every step."""
    level = play_level(str(tmp_path / "play-still.npz"))
    keys = iter(KEYS + ["q"])
    monkeypatch.setattr(TI, "getch", lambda: next(keys))
    monkeypatch.setattr(os, "system", lambda cmd: 0)
    rec = str(tmp_path / "rec")
    TM.main(["play", level, "--record", rec, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Level complete! computing side effects..." in out
    assert "COMBINED SCORE" in out
    with np.load(os.path.join(rec, "rec-001.npz")) as data:
        assert data["board"].shape == (len(KEYS) + 1, 10, 10)
    assert _files(tmp_path) == ["play-still.npz", "rec"]


def _gl_loop(tmp_path, seed):
    from safelife_tpu_torch.interactive_gl import GraphicalGameLoop

    it = TIT.SafeLifeLevelIterator("random/append-still", seed=seed,
                                   num_workers=0)
    return GraphicalGameLoop(it, record_to=str(tmp_path), fps=1000,
                             device="cpu")


def test_gl_headless_play_and_draw(monkeypatch, tmp_path):
    """The pygame loop under the SDL dummy driver: two key events step the
    game twice and frames draw (tests/test_game_cli.py:289-311)."""
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    pygame = pytest.importorskip("pygame")
    loop = _gl_loop(tmp_path, 21)
    pygame.init()
    try:
        pygame.event.post(pygame.event.Event(
            pygame.KEYDOWN, key=pygame.K_RIGHT, unicode=""))
        pygame.event.post(pygame.event.Event(
            pygame.KEYDOWN, key=pygame.K_DOWN, unicode=""))
        loop.run(max_frames=3)
    finally:
        pygame.quit()
    assert loop.game.num_steps == 2
    assert loop._frame().shape == (26 * 14, 26 * 14, 3)


def test_gl_quit_key_saves_recording(monkeypatch, tmp_path):
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    pygame = pytest.importorskip("pygame")
    loop = _gl_loop(tmp_path, 22)
    pygame.init()
    try:
        pygame.event.post(pygame.event.Event(
            pygame.KEYDOWN, key=pygame.K_UP, unicode=""))
        pygame.event.post(pygame.event.Event(
            pygame.KEYDOWN, key=pygame.K_q, unicode="q"))
        loop.run(max_frames=10)
    finally:
        pygame.quit()
    recs = [f for f in os.listdir(str(tmp_path)) if f.startswith("rec-")]
    assert recs, "quit must flush the play recording"


def test_benchmark_episode_video(tmp_path):
    """A benchmark with ``record_videos`` logs one recorded episode: its
    ``.npz`` and, beside it, the movie of its boards (a gif where imageio
    has no ffmpeg), frame for frame the movie JAX's loggers render of the
    same history."""
    import shutil

    from safelife_tpu.render import graphics as JGR
    from safelife_tpu_torch import loggers as TLOG
    from safelife_tpu_torch.env import env as TE
    from safelife_tpu_torch.models import nets as TN
    from safelife_tpu_torch.render.graphics import render_board
    from safelife_tpu_torch.training import runner as TR

    torch.manual_seed(0)
    net = TN.SafeLifePolicyNetwork(view_shape=(25, 25),
                                   unpack_channels=TN.TRAINING_CHANNELS,
                                   device="cpu").eval()
    log = TLOG.SafeLifeLogger(str(tmp_path), episode_type="benchmark",
                              summary_writer=False)
    TR.benchmark(net, TL.load_levels("benchmarks/v1.0/prune-dynamic.npz")[:2],
                 2, env_cfg=TE.EnvConfig(view_shape=(25, 25),
                                         output_channels=None, time_limit=6),
                 generator=torch.Generator().manual_seed(0),
                 calc_side_effects=False, data_logger=log,
                 record_videos=True, device="cpu")
    videos = [f for f in _files(tmp_path) if "-video." in f]
    stem = videos[0].rsplit(".", 1)[0]
    movie = [f for f in videos if not f.endswith(".npz")]
    assert stem + ".npz" in videos and len(movie) == 1
    with np.load(str(tmp_path / (stem + ".npz"))) as h:
        boards = render_board(h["board"].astype(np.int64) & C.CELL_MASK,
                              h["goals"].astype(np.int64) & C.CELL_MASK)
    (tmp_path / "jax").mkdir()
    ref = str(tmp_path / "jax" / (stem + ".npz"))
    shutil.copy(str(tmp_path / (stem + ".npz")), ref)
    JGR.render_file(ref, movie_format="mp4")
    ref_movie = [f for f in _files(tmp_path / "jax") if f != stem + ".npz"]
    assert ref_movie == movie
    frames = np.stack(imageio.mimread(str(tmp_path / movie[0])))
    assert frames.shape[1:] == boards.shape[1:]
    np.testing.assert_array_equal(
        frames, np.stack(imageio.mimread(str(tmp_path / "jax" / movie[0]))))
