"""The port's level pool manager and checkpoints, on the CPU.

``LevelPoolManager`` against the JAX package's under the same level
sequence and ``in_use`` sets: pool tensors, the slots chosen, the levels
waiting and dropped, and ``level_meta`` must all be equal; a restored pool
too. ``CheckpointManager``: a PPO learner, a wrapped env state and a pool
come back exactly, and the last three checkpoints are kept."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from safelife_tpu.core import cells as JC  # noqa: E402
from safelife_tpu.env import state as JST  # noqa: E402
from safelife_tpu.io import iterator as JIT  # noqa: E402
from safelife_tpu.io import levels as JL  # noqa: E402
from safelife_tpu.training import runner as JR  # noqa: E402
from safelife_tpu_torch.env import env as TE, state as TST  # noqa: E402
from safelife_tpu_torch.env import wrappers as TW  # noqa: E402
from safelife_tpu_torch.io import iterator as TIT  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.training import ppo as TP  # noqa: E402
from safelife_tpu_torch.training.checkpoints import (  # noqa: E402
    CheckpointManager)

DYNAMIC = "benchmarks/v1.0/prune-dynamic.npz"  # no spawners, goals evolve
SPAWN = "benchmarks/v1.0/prune-spawn.npz"      # spawners
STILL = "benchmarks/v1.0/append-still.npz"     # no spawners, static goals


class ListIterator:
    """A level iterator over a fixed list, with no workers."""

    num_workers = 0

    def __init__(self, levels):
        self.levels = list(levels)
        self.closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if not self.levels:
            raise StopIteration
        return self.levels.pop(0)

    def close(self):
        self.closed = True


def level_stream(load):
    """Prune-dynamic levels with spawner levels (incompatible with the
    pool) and append-still levels (compatible) among them."""
    dyn, spawn, still = (load(p) for p in (DYNAMIC, SPAWN, STILL))
    seq = dyn[:4]
    for i in range(4, 16):
        seq.append(dyn[i])
        if i % 4 == 1:
            seq.append(spawn[i])
        if i % 5 == 2:
            seq.append(still[i])
    return seq


def pool_fields(pool):
    return [f.name for f in dataclasses.fields(pool)
            if isinstance(getattr(pool, f.name), torch.Tensor)]


def assert_pools_equal(tpool, jpool):
    for name in pool_fields(tpool):
        np.testing.assert_array_equal(
            getattr(tpool, name).numpy(), np.asarray(getattr(jpool, name)),
            err_msg=name)
    assert tpool.all_goals_static == jpool.all_goals_static
    assert tpool.spawner_free == jpool.spawner_free


def assert_managers_equal(tm, jm):
    assert_pools_equal(tm.pool, jm.pool)
    assert tm._slot == jm._slot
    assert [lv.name for lv in tm._host_levels] == \
        [lv.name for lv in jm._host_levels]
    assert [lv.name for lv in tm._pending] == \
        [lv.name for lv in jm._pending]
    assert tm.level_meta() == jm.level_meta()


def test_pool_manager_matches_jax():
    jm = JIT.LevelPoolManager(ListIterator(level_stream(JL.load_levels)),
                              pool_size=4)
    it = ListIterator(level_stream(TL.load_levels))
    tm = TIT.LevelPoolManager(it, pool_size=4, device="cpu")
    assert tm.pool.spawner_free and not tm.pool.all_goals_static
    assert_managers_equal(tm, jm)
    pool = tm.pool
    # (max_new, in_use): no guard, busy slots, every slot busy (the levels
    # wait), a tensor of slots, and the iterator running dry; spawner
    # levels among the new ones are dropped.
    swapped = []
    for max_new, in_use in ((2, None), (3, [1, 2]), (2, [0, 1, 2, 3]),
                            (1, torch.tensor([3, 3, 0])), (4, [2]),
                            (8, []), (8, None)):
        before = [lv.name for lv in tm._host_levels]
        busy = [] if in_use is None else np.asarray(in_use).tolist()
        got = tm.refresh(max_new, in_use=in_use)
        ref = jm.refresh(max_new,
                         in_use=None if in_use is None else np.asarray(busy))
        assert got == ref, (max_new, busy)
        assert_managers_equal(tm, jm)
        after = [lv.name for lv in tm._host_levels]
        for s in busy:
            assert after[s] == before[s]
        swapped.append(got)
    assert swapped == [2, 2, 0, 2, 3, 4, 1]
    assert tm.pool is pool  # swapped in place
    assert all(lv.name.startswith("prune-dynamic") or
               lv.name.startswith("append-still") for lv in tm._host_levels)
    # Pool rows equal the levels now in the slots.
    assert_pools_equal(tm.pool, JST.pack_levels(
        [JL.load_levels(DYNAMIC if n.startswith("prune") else STILL)
         [int(n[-7:-4]) - 1] for n in after]))
    tm.close()
    assert it.closed


@pytest.mark.parametrize("field", ["agents", "exits"])
def test_pool_manager_refuses_a_level_past_its_pad(field):
    """A level with more agents or exits than an explicit pad is refused,
    as the JAX package's manager refuses it."""
    def widened(load):
        lv = load(DYNAMIC)[0].copy()
        if field == "agents":
            lv.agent_locs = np.concatenate([lv.agent_locs, lv.agent_locs])
            lv.agent_names = np.concatenate([lv.agent_names,
                                             lv.agent_names])
            lv.points_table = np.concatenate([lv.points_table,
                                              lv.points_table])
        else:
            lv.board[tuple(np.argwhere(lv.board == 0)[0])] = JC.EXIT
        return [lv]

    pads = {"pad_" + field: 1}
    with pytest.raises(ValueError, match="pad_" + field):
        JIT.LevelPoolManager(ListIterator(widened(JL.load_levels)),
                             pool_size=1, **pads)
    with pytest.raises(ValueError, match="2 %s > pad_%s=1" % (field, field)):
        TIT.LevelPoolManager(ListIterator(widened(TL.load_levels)),
                             pool_size=1, device="cpu", **pads)
    # Without a pad the manager widens its own.
    tm = TIT.LevelPoolManager(ListIterator(widened(TL.load_levels)),
                              pool_size=1, device="cpu")
    assert (tm.pool.num_agents, tm.pool.exit_locs.shape[1]) == \
        ((2, 1) if field == "agents" else (1, 2))


def test_restored_pool_matches_jax(tmp_path):
    levels = TL.load_levels(DYNAMIC)
    jlevels = JL.load_levels(DYNAMIC)
    tm = TIT.LevelPoolManager(ListIterator(levels[:4] + levels[20:24]),
                              pool_size=4, device="cpu")
    jm = JIT.LevelPoolManager(ListIterator(jlevels[:4] + jlevels[20:24]),
                              pool_size=4)
    tm.level_meta()
    jm.level_meta()
    # A pool from another run of the same shape, saved and restored.
    saved = TST.pack_levels(levels[40:44],
                            pad_exits=tm.pool.exit_locs.shape[1],
                            device="cpu")
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(10, {"pool": saved})
    restored, _, _ = ckpt.restore(device="cpu")
    tpool = tm.restore_pool(restored["pool"])
    jsaved = JST.pack_levels(jlevels[40:44],
                             pad_exits=jm.pool.exit_locs.shape[1])
    jpool = jm.restore_pool({k: np.asarray(v) for k, v in
                             dataclasses.asdict(jsaved).items()
                             if not isinstance(v, bool)})
    assert_pools_equal(tpool, jpool)
    assert tm.level_meta() == jm.level_meta()
    assert tm.level_meta()[1]["name"] == "restored/slot-1"
    # A refresh puts known levels back into restored slots.
    assert tm.refresh(2, in_use=[0]) == jm.refresh(2, in_use=np.array([0]))
    assert_managers_equal(tm, jm)
    with pytest.raises(ValueError, match="pool_size"):
        tm.restore_pool(TST.pack_levels(levels[:3], device="cpu"))


@pytest.mark.parametrize("path", [DYNAMIC, SPAWN, STILL])
def test_level_metadata_matches_jax(path):
    """The records' metadata read from a packed pool equals the JAX
    package's, which packs each level alone."""
    levels = TL.load_levels(path)[:5]
    got = TST.level_metadata(levels, TST.pack_levels(levels, device="cpu"))
    assert got == JR.level_metadata(JL.load_levels(path)[:5])
    assert [m["name"] for m in got.values()] == [lv.name for lv in levels]


def test_checkpoint_round_trip_is_exact(tmp_path):
    """A learner after two Adam steps, a wrapped env state mid-episode and
    a pool: restored exactly, and the learner steps on identically."""
    levels = TL.load_levels(STILL)[:3]
    pool = TST.pack_levels(levels, device="cpu")
    cfg = TE.EnvConfig(view_shape=(17, 17), output_channels=None)
    wcfg = TW.WrapperConfig(se_baseline="inaction")
    ws, _ = TW.reset(cfg, wcfg, pool, 4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        ws, *_ = TW.step(cfg, wcfg, pool, ws,
                         torch.randint(0, 9, (4, 1), generator=gen), gen)

    def learner():
        torch.manual_seed(0)
        net = TN.SafeLifePolicyNetwork(view_shape=(17, 17),
                                       unpack_channels=TN.TRAINING_CHANNELS,
                                       device="cpu")
        return TP.init_ppo_state(TP.PPOConfig(), net, device="cpu")

    obs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2 ** 28, (6, 17, 17)).astype(np.int32))

    def adam_step(ps):
        values, policy = ps.model(obs)
        ps.optimizer.zero_grad()
        (values.sum() + policy[:, 1].sum()).backward()
        ps.optimizer.step()

    ps = learner()
    adam_step(ps)
    adam_step(ps)
    ps.num_steps = 123
    ckpt = CheckpointManager(str(tmp_path), interval=100)
    state = {"params": ps.model.state_dict(),
             "opt_state": ps.optimizer.state_dict(),
             "num_steps": ps.num_steps, "env_state": ws, "pool": pool}
    for step in (50, 99, 100, 150, 230, 310, 405):
        ckpt.save_if_needed(step, state, {"training_steps": step})
    assert ckpt.steps() == [230, 310, 405]
    assert ckpt.latest_step() == 405

    restored, extra, step = ckpt.restore(device="cpu")
    assert step == 405 and extra == {"training_steps": 405}
    assert isinstance(restored["env_state"], TW.WrappedState)
    assert isinstance(restored["pool"], TST.LevelBatch)
    assert restored["pool"].spawner_free == pool.spawner_free

    def same(a, b, what):
        if dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                same(getattr(a, f.name), getattr(b, f.name),
                     what + "." + f.name)
        elif isinstance(a, dict):
            assert set(a) == set(b), what
            for k in a:
                same(a[k], b[k], "%s[%s]" % (what, k))
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), what
        else:
            assert a == b, what

    same(restored, state, "state")
    ps2 = learner()
    ps2.model.load_state_dict(restored["params"])
    ps2.optimizer.load_state_dict(restored["opt_state"])
    adam_step(ps)
    adam_step(ps2)
    same(ps2.model.state_dict(), ps.model.state_dict(), "params")
    same(ps2.optimizer.state_dict(), ps.optimizer.state_dict(), "adam")
    assert CheckpointManager(str(tmp_path / "empty")).restore("cpu") == \
        (None, None, None)
