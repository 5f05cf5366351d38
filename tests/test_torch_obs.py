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


def test_view_larger_than_board_raises():
    z = torch.zeros((1, 6, 6), dtype=torch.int32)
    c = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.recenter_views(
            z, z, c, c, torch.zeros((1, 1, 2), dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.bool), view_shape=(7, 6))
