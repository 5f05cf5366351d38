"""Plain version of kernel K3 (recenter_views) against the JAX package:
the Pallas kernel in interpret mode and the XLA formulation
``get_obs_batch(output_channels=None)``, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from safelife_tpu import ops as jops  # noqa: E402
from safelife_tpu.env import env as JE  # noqa: E402
from safelife_tpu_torch import ops  # noqa: E402
from safelife_tpu_torch.env import env as TE  # noqa: E402


def _case(rng, b, a, n_exits, h=26, w=26):
    board = rng.integers(0, 2 ** 16, (b, h, w)).astype(np.int32)
    goals = rng.integers(0, 2 ** 16, (b, h, w)).astype(np.int32)
    locs = rng.integers(0, min(h, w), (b, a, 2)).astype(np.int32)
    mask = rng.random((b, a)) < 0.8
    el = rng.integers(0, min(h, w), (b, n_exits, 2)).astype(np.int32)
    ev = rng.random((b, n_exits)) < 0.7
    return board, goals, locs, mask, el, ev


def _both(view, board, goals, locs, mask, el, ev, remove_white=True):
    """(JAX XLA views, JAX Pallas-interpret views, port views)."""
    cfg = JE.EnvConfig(view_shape=view, output_channels=None,
                       remove_white_goals=remove_white)
    j = [jnp.asarray(x) for x in (board, goals, locs, mask, el, ev)]
    ref = np.asarray(JE.get_obs_batch(cfg, *j))
    center = np.where(mask[..., None], locs, 0).astype(np.int32)
    pallas = np.asarray(jops.recenter_views_pallas(
        j[0], j[1], jnp.asarray(center[..., 0]), jnp.asarray(center[..., 1]),
        j[4], j[5], view_shape=view, remove_white_goals=remove_white,
        interpret=True))
    t = torch.from_numpy
    got = ops.recenter_views(
        t(board), t(goals), t(np.ascontiguousarray(center[..., 0])),
        t(np.ascontiguousarray(center[..., 1])), t(el), t(ev),
        view_shape=view, remove_white_goals=remove_white)
    return ref, pallas, got.numpy()


@pytest.mark.parametrize("view", [(25, 25), (15, 15), (26, 26), (7, 9)])
@pytest.mark.parametrize("a,n_exits", [(1, 1), (3, 2)])
def test_matches_jax_views(view, a, n_exits):
    rng = np.random.default_rng(hash((view, a, n_exits)) % 2 ** 31)
    ref, pallas, got = _both(view, *_case(rng, 8, a, n_exits))
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)


def test_no_exits():
    rng = np.random.default_rng(11)
    board, goals, locs, mask, _, _ = _case(rng, 8, 1, 1)
    el0 = np.zeros((8, 0, 2), np.int32)
    ev0 = np.zeros((8, 0), bool)
    ref, pallas, got = _both((25, 25), board, goals, locs, mask, el0, ev0)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)


def test_keep_white_goals():
    rng = np.random.default_rng(7)
    ref, pallas, got = _both((25, 25), *_case(rng, 8, 1, 1),
                             remove_white=False)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)


def test_channel_unpack_matches_jax():
    rng = np.random.default_rng(13)
    views = rng.integers(0, 2 ** 28, (4, 2, 7, 9)).astype(np.int32)
    tcfg = TE.EnvConfig(view_shape=(7, 9))
    got = TE.unpack_view_channels(tcfg, torch.from_numpy(views)).numpy()
    assert got.dtype == np.uint8
    # JAX's flat layout (a TPU tiling aid) is the port's views reshaped.
    for flat, out in ((False, got), (True, got.reshape(4, 2, -1))):
        jcfg = JE.EnvConfig(view_shape=(7, 9), flat_obs=flat)
        ref = np.asarray(JE.unpack_view_channels(jcfg, jnp.asarray(views)))
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape,view", [
    ((6, 6), (7, 6)), ((3, 3), (25, 25)), ((10, 12), (15, 15)),
    ((4, 9), (25, 25))])
@pytest.mark.parametrize("a", [1, 3])
@pytest.mark.parametrize("n_exits", [0, 2])
def test_view_larger_than_board_matches_jax(shape, view, a, n_exits):
    """Views larger than the board tile it, as JAX's XLA formulation
    ``get_obs_batch`` does (the Pallas kernel is not used there)."""
    rng = np.random.default_rng(hash((shape, view, a, n_exits)) % 2 ** 31)
    h, w = shape
    board, goals, locs, mask, el, ev = _case(rng, 8, a, n_exits, h=h, w=w)
    cfg = JE.EnvConfig(view_shape=view, output_channels=None)
    ref = np.asarray(JE.get_obs_batch(
        cfg, *[jnp.asarray(x) for x in (board, goals, locs, mask, el, ev)]))
    center = np.where(mask[..., None], locs, 0).astype(np.int32)
    t = torch.from_numpy
    got = ops.recenter_views(
        t(board), t(goals), t(np.ascontiguousarray(center[..., 0])),
        t(np.ascontiguousarray(center[..., 1])), t(el), t(ev),
        view_shape=view).numpy()
    assert got.shape == ref.shape == (8, a) + view
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("args,expected", [
    # The main path: 26x26 prune-dynamic boards, one agent, 25x25 views.
    ((4096, 1, 26, 26, 25, 25), (16, 1024, (2 * 16 * 676 + 16 * 50) * 4)),
    ((512, 1, 26, 26, 25, 25), (2, 192, (2 * 2 * 676 + 2 * 50) * 4)),
    ((8, 3, 26, 26, 15, 15), (1, 96, (2 * 676 + 3 * 30) * 4)),
    # Views larger than the board: the threads follow the elements.
    ((4096, 3, 3, 3, 25, 25), (16, 1024, (144 + 144 + 16 * 3 * 50) * 4)),
    ((4, 3, 26, 26, 200, 200), (1, 1024, (2 * 676 + 3 * 400) * 4)),
    # One lane above 48 KB opts in; above 227 KB it takes the global-memory
    # form.
    ((64, 1, 96, 128, 25, 25), (1, 1024, (2 * 12288 + 50) * 4)),
    ((64, 1, 192, 192, 25, 25), (0, 256, 0)),
    # The boards of a block are padded to 16 bytes before the goals.
    ((1, 1, 1, 1, 1, 1), (1, 32, (4 + 1 + 2) * 4)),
])
def test_view_launch_shape(args, expected):
    """Lanes a block, threads and shared bytes of K3 launches: the most
    lanes (of 1, 2, 4, 8, 16) that leave 256 blocks, a thread for 8
    elements or cells, and the global-memory form for lanes too large to
    stage."""
    from safelife_tpu_torch.ops import obs as O

    assert O.view_launch_shape(*args) == expected
