"""The port's renderers against the JAX package's, on the CPU: the ANSI and
plain text boards as equal strings, the sprite frames as equal uint8
arrays (single boards, batches, torch tensors, movies under equal seeds),
and the png/gif files ``render_file`` writes decoding to equal frames."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
imageio = pytest.importorskip("imageio")

from conftest import random_board  # noqa: E402
from safelife_tpu.io import levels as JL  # noqa: E402
from safelife_tpu.render import graphics as JGR, text as JT  # noqa: E402
from safelife_tpu_torch.core import cells as C  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402
from safelife_tpu_torch.render import graphics as TGR, text as TT  # noqa: E402


def boards(seed, shape=(3, 11, 13)):
    """Soups with spawners, agents in every orientation and colour,
    coloured empty cells, every named cell type and cells of no type."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape[:-2]))
    b = np.stack([random_board(rng, shape[-2:], spawners=True)
                  for _ in range(n)]).reshape(shape)
    g = (rng.integers(0, 8, shape) << C.COLOR_BIT).astype(np.int64)
    names = [C.EMPTY, C.LIFE, C.ALIVE, C.WALL, C.CRATE, C.PLANT, C.TREE,
             C.ICE_CUBE, C.PARASITE, C.WEED, C.SPAWNER, C.HARD_SPAWNER,
             C.LEVEL_EXIT, C.FOUNTAIN]
    flat = b.reshape(-1)
    for i, cell in enumerate(names):
        flat[i] = cell | (i % 8) << C.COLOR_BIT
    for d in range(4):
        flat[20 + d] = C.PLAYER | d << C.ORIENTATION_BIT | d << C.COLOR_BIT
    flat[30] = C.COLOR_G                 # coloured empty
    flat[31] = C.EXIT | C.AGENT          # an agent on an exit
    flat[32] = 1 << 14                   # no type
    flat[33] = C.LEVEL_EXIT | C.ORIENTATION_MASK
    return b, g


@pytest.mark.parametrize("seed", [0, 1])
def test_text_boards(seed):
    b, g = boards(seed, (11, 13))
    for ansi in (True, False):
        want = JT.render_board(b, g, ansi=ansi)
        assert TT.render_board(b, g, ansi=ansi) == want
        assert TT.render_board(torch.from_numpy(b), torch.from_numpy(g),
                               ansi=ansi) == want
        assert TT.render_board(b, ansi=ansi) == JT.render_board(b, ansi=ansi)
    for cell, goal in zip(b.reshape(-1)[:40], g.reshape(-1)[:40]):
        assert TT.render_cell(cell, goal) == JT.render_cell(cell, goal)
        assert TT._plain_glyph(cell) == JT._plain_glyph(cell)
    lv_j = JL.Level(board=b, goals=g, agent_locs=np.zeros((0, 2), int),
                    agent_names=np.array([]),
                    points_table=np.zeros((0, 8, 9)))
    lv_t = TL.Level(board=b, goals=g, agent_locs=np.zeros((0, 2), int),
                    agent_names=np.array([]),
                    points_table=np.zeros((0, 8, 9)))
    for ansi in (True, False):
        assert TT.render_game(lv_t, ansi=ansi) == \
            JT.render_game(lv_j, ansi=ansi)
        assert TT.render_game(b, ansi=ansi) == JT.render_game(b, ansi=ansi)


@pytest.mark.parametrize("shape", [(11, 13), (3, 11, 13), (2, 2, 5, 4)])
def test_sprite_frames(shape):
    """``render_board`` on single and batched boards, with and without
    goals, from NumPy and from torch tensors: JAX's bytes."""
    b, g = boards(2, shape)
    want = JGR.render_board(b, g)
    got = TGR.render_board(b, g)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    on = TGR.render_board(torch.from_numpy(b).to(torch.int32),
                          torch.from_numpy(g).to(torch.int32))
    assert isinstance(on, torch.Tensor) and on.dtype == torch.uint8
    np.testing.assert_array_equal(on.numpy(), want)
    np.testing.assert_array_equal(TGR.render_board(b), JGR.render_board(b))
    np.testing.assert_array_equal(
        TGR.render_board(torch.from_numpy(b)).numpy(), JGR.render_board(b))
    lv = TL.Level(board=b[..., :, :] if b.ndim == 2 else b.reshape(
        (-1,) + b.shape[-2:])[0], goals=g.reshape((-1,) + g.shape[-2:])[0],
        agent_locs=np.zeros((0, 2), int), agent_names=np.array([]),
        points_table=np.zeros((0, 8, 9)))
    np.testing.assert_array_equal(
        TGR.render_game(lv), JGR.render_board(lv.board, lv.goals))


def test_sprites_are_the_same():
    assert list(TGR._SPRITES) == list(JGR._SPRITES)
    np.testing.assert_array_equal(TGR._SPRITE_STACK, JGR._SPRITE_STACK)
    np.testing.assert_array_equal(TGR.FG_COLORS, JGR.FG_COLORS)
    np.testing.assert_array_equal(TGR.BG_COLORS, JGR.BG_COLORS)


def test_movie_under_equal_seeds():
    b, g = boards(3, (12, 12))
    want = JGR.render_mov(b, g, 6, 0.4, rng=np.random.default_rng(5))
    got = TGR.render_mov(b, g, 6, 0.4, rng=np.random.default_rng(5))
    assert got.shape == (7, 12 * 14, 12 * 14, 3)
    np.testing.assert_array_equal(got, want)


def _decode(path):
    if path.endswith(".png"):
        return np.asarray(imageio.v2.imread(path))[None]
    return np.stack(imageio.mimread(path))


def _render_both(tmp_path, src, **kw):
    """``render_file`` of copies of ``src`` in a jax/ and a port/
    directory; the outputs' names (relative) and decoded frames."""
    outs = []
    for name, mod in (("jax", JGR), ("port", TGR)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        path = str(d / os.path.basename(src))
        shutil.copy(src, path)
        files = mod.render_file(path, **kw)
        # JAX names an mp4 it wrote as gif (no ffmpeg) by the mp4's name;
        # the port returns the gif's.
        files = [f if os.path.exists(f) or mod is TGR else f[:-4] + ".gif"
                 for f in files]
        assert files and all(os.path.exists(f) for f in files)
        outs.append(([os.path.relpath(f, str(d)) for f in files],
                     [_decode(f) for f in files]))
    (jnames, jframes), (tnames, tframes) = outs
    assert tnames == jnames
    for a, b in zip(jframes, tframes):
        np.testing.assert_array_equal(b, a)
    return tnames, tframes


def test_render_file_level_archive_trajectory(tmp_path):
    """A level file (png), an archive with and without ``steps`` (a png or
    a gif a level), and a recorded trajectory (a gif; mp4 asked for, and
    written as gif on a host without ffmpeg, as in JAX)."""
    # Levels without spawners: render_file evolves a level under an
    # unseeded generator.
    archive = TL.load_levels("benchmarks/v1.0/prune-dynamic.npz")[:2]
    TL.save_level(archive[0], str(tmp_path / "one.npz"))
    names, frames = _render_both(tmp_path, str(tmp_path / "one.npz"))
    assert names == ["one-one.png"] and frames[0].shape == (1, 26 * 14,
                                                            26 * 14, 3)
    TL.save_archive(archive, str(tmp_path / "two.npz"))
    names, _ = _render_both(tmp_path, str(tmp_path / "two.npz"))
    assert len(names) == 2 and all(n.endswith(".png") for n in names)
    names, frames = _render_both(tmp_path, str(tmp_path / "two.npz"),
                                 steps=3)
    assert len(names) == 2 and all(n.endswith(".gif") for n in names)
    assert frames[0].shape[1:] == (26 * 14, 26 * 14, 3)
    b, g = boards(4, (5, 9, 10))
    np.savez_compressed(str(tmp_path / "traj.npz"), board=b, goals=g)
    names, frames = _render_both(tmp_path, str(tmp_path / "traj.npz"))
    assert names == ["traj.gif"] and frames[0].shape[0] == 5
    names, _ = _render_both(tmp_path, str(tmp_path / "traj.npz"),
                            movie_format="mp4")
    assert names[0] in ("traj.mp4", "traj.gif")
    if not shutil.which("ffmpeg"):
        assert os.path.exists(str(tmp_path / "port" / "traj.gif"))
