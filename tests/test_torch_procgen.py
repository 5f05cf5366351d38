"""The port's level generator against the JAX package's, on the CPU.

Generation draws from NumPy on both sides, so equal seeds must give equal
levels byte for byte: whole levels through ``_level_from_data`` (native
annealer on both sides), the annealer's pieces (native, and the Python
annealer called directly on 8x8 masks), regions, fences, lattices and
stability masks; level files and specs resolve and round-trip alike, and
the level iterators pick the same levels."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from safelife_tpu.io import iterator as JIT  # noqa: E402
from safelife_tpu.io import levels as JL  # noqa: E402
from safelife_tpu.procgen import generate as JG  # noqa: E402
from safelife_tpu.procgen import pattern as JP  # noqa: E402
from safelife_tpu.procgen import regions as JR  # noqa: E402
from safelife_tpu.training import env_factory as JF  # noqa: E402
from safelife_tpu.utils import rng as JRNG  # noqa: E402
from safelife_tpu_torch.io import iterator as TIT  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402
from safelife_tpu_torch.procgen import generate as TG  # noqa: E402
from safelife_tpu_torch.procgen import pattern as TP  # noqa: E402
from safelife_tpu_torch.procgen import regions as TR  # noqa: E402
from safelife_tpu_torch.training import env_factory as TF  # noqa: E402
from safelife_tpu_torch.utils import rng as TRNG  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = ("append-still-easy", "append-still", "append-spawn",
         "append-dynamic", "prune-still", "prune-spawn", "prune-dynamic",
         "navigation", "multi-agent/asym1", "multi-agent/build-coop")

LEVEL_FIELDS = ("board", "goals", "agent_locs", "agent_names",
                "points_table")


def assert_levels_equal(a, b):
    for k in LEVEL_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k
    assert a.min_performance == b.min_performance
    assert a.spawn_prob == b.spawn_prob
    assert a.name == b.name


@pytest.mark.parametrize("spec", SPECS)
def test_levels_match_jax(spec):
    """Whole generated levels, byte for byte, native on both sides."""
    jd = JIT.load_files(["random/" + spec])[0]
    td = TIT.load_files(["random/" + spec])[0]
    assert json.dumps(jd[2], sort_keys=True) == \
        json.dumps(td[2], sort_keys=True)
    for seed in (1, 2):
        # The third child: spawn_key (2,), the name's "-e2".
        s = np.random.SeedSequence(seed).spawn(3)[-1]
        a = JIT._level_from_data(*jd, seed=s)
        b = TIT._level_from_data(*td, seed=s)
        assert a.name.endswith("-e2")
        assert_levels_equal(a, b)


def _masks(seed):
    rng = np.random.default_rng(seed)
    mask = np.full((8, 8), 7, np.int32)
    mask[rng.random((8, 8)) < 0.15] = 4
    board = np.zeros((8, 8), np.uint16)
    board[0, :] = 16  # a wall row the annealer may not change
    mask[0, :] = 0
    return board, mask


@pytest.mark.parametrize("period", (1, 2))
def test_gen_pattern_native_matches_jax(period):
    board, mask = _masks(period)
    for seed in range(3):
        kw = dict(period=period, min_fill=0.15, max_iter=40)
        try:
            a = JP.gen_pattern(board, mask, rng=np.random.default_rng(seed),
                               **kw)
        except JP.MaxIterException:
            with pytest.raises(TP.MaxIterException):
                TP.gen_pattern(board, mask, rng=np.random.default_rng(seed),
                               **kw)
            continue
        b = TP.gen_pattern(board, mask, rng=np.random.default_rng(seed),
                           native=True, **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(TP.InsufficientAreaException):
        TP.gen_pattern(board, np.zeros_like(mask),
                       rng=np.random.default_rng(0))


def test_gen_pattern_python_matches_jax():
    """The Python annealer, called directly on the same inputs."""
    board, mask = _masks(0)
    penalties = np.array([0., 0., 100., 100., 0., 0., 100., 100.])
    for seed, period in ((0, 1), (1, 1), (3, 2), (8, 2)):
        layers = TP._pre_evolve(board, period)
        assert np.array_equal(layers, JP._pre_evolve(board, period))
        args = (mask, mask, 40, 0.1, 0.5, 0.3, penalties)
        outs = []
        for mod in (JP, TP):
            try:
                outs.append(mod._gen_pattern_python(
                    layers.copy(), *args, np.random.default_rng(seed)))
            except mod.MaxIterException:
                outs.append("max-iter")
        if isinstance(outs[0], str):
            assert outs[1] == "max-iter"
        else:
            assert np.array_equal(outs[0], outs[1])


def test_gen_pattern_python_on_request(monkeypatch):
    """The Python annealer runs only when asked: by argument or by the
    SAFELIFE_TPU_TORCH_NO_NATIVE variable, with the JAX package's stream
    (``default_rng`` of the drawn seed)."""
    from safelife_tpu import native as JN
    from safelife_tpu_torch import native

    board, mask = _masks(3)
    kw = dict(period=1, min_fill=0.1, max_iter=40)
    want = TP.gen_pattern(board, mask, rng=np.random.default_rng(5),
                          native=False, **kw)
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    assert not native.requested()
    got = TP.gen_pattern(board, mask, rng=np.random.default_rng(5), **kw)
    assert np.array_equal(want, got)
    monkeypatch.setenv("SAFELIFE_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(JN, "_lib", None)
    ref = JP.gen_pattern(board, mask, rng=np.random.default_rng(5), **kw)
    assert np.array_equal(ref, got)
    assert (np.asarray(ref) != 0).any()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build raises; nothing falls back to the Python
    annealer."""
    from safelife_tpu_torch import native

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "GXX_FLAGS",
                        native.GXX_FLAGS + ("-DSAFELIFE_NO_SUCH", "-x",
                                            "no-such-language"))
    board, mask = _masks(0)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        TP.gen_pattern(board, mask, rng=np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        TP.wrapped_label(mask)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("name", ["annealer", "emd"])
def test_native_library_built_at_first_use_and_reused(name, tmp_path,
                                                       monkeypatch):
    """Each native library is built by g++ at its first load, named by its
    source's name and a hash of the source and the flags, and loaded again
    from that file without a second build."""
    import hashlib

    from safelife_tpu_torch import native

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    builds = []
    run = subprocess.run

    def recorded(cmd, *args, **kwargs):
        builds.append(cmd)
        return run(cmd, *args, **kwargs)
    monkeypatch.setattr(native.subprocess, "run", recorded)

    h = hashlib.sha256(" ".join(native.GXX_FLAGS).encode())
    with open(os.path.join(os.path.dirname(native.__file__),
                           name + ".cpp"), "rb") as f:
        h.update(f.read())
    want = "%s-%s.so" % (name, h.hexdigest()[:16])
    assert native.library_path(name) == str(tmp_path / want)

    lib = native.load(name)
    assert [c[0] for c in builds] == ["g++"]
    assert os.listdir(tmp_path) == [want]
    for fn in native.PROTOTYPES[name]:
        assert getattr(lib, fn).restype is native.PROTOTYPES[name][fn][0]
    assert native.load(name) is lib  # cached in the process
    monkeypatch.setattr(native, "_libs", {})
    native.load(name)  # a new process: the file, no build
    assert len(builds) == 1 and os.listdir(tmp_path) == [want]


@pytest.mark.parametrize("seed", range(3))
def test_wrapped_label_matches_jax(seed):
    data = (np.random.default_rng(seed).random((10, 13)) < 0.4)
    want, n = JP.wrapped_label(data)
    got, m = TP.wrapped_label(data)
    assert n == m and np.array_equal(want, got)
    pw, pn = JP._wrapped_label_python(data.astype(np.int32))
    pg, pm = TP._wrapped_label_python(data.astype(np.int32))
    assert pn == pm == n and np.array_equal(pw, pg)
    got_py, k = TP.wrapped_label(data, native=False)
    assert k == n and np.array_equal(got_py, pg)


def test_regions_fences_lattices_match_jax():
    for seed in range(4):
        kw = dict(alpha=1.0, max_regions=4, min_regions=2)
        with JRNG.set_rng(np.random.default_rng(seed)):
            a = JR.make_partitioned_regions((26, 26), **kw)
        with TRNG.set_rng(np.random.default_rng(seed)):
            b = TR.make_partitioned_regions((26, 26), **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        mask = b == b.max()
        with JRNG.set_rng(np.random.default_rng(seed)):
            fa = JR.build_fence(mask)
        with TRNG.set_rng(np.random.default_rng(seed)):
            fb = TR.build_fence(mask)
        assert np.array_equal(fa, fb) and fb.any()
    for args in ((26, 26, 3, 3, 1), (26, 26, 13, 1, 5), (12, 20, 6, 3, 3),
                 (10, 10, 5.0, 5.0, 0)):
        assert np.array_equal(JR.make_lattice(*args), TR.make_lattice(*args))


def test_stability_mask_matches_jax():
    for spec, seed in (("append-spawn", 3), ("prune-dynamic", 4)):
        lv = TIT._level_from_data(*TIT.load_files(["random/" + spec])[0],
                                  seed=np.random.SeedSequence(seed))
        for period in (1, 2, 6):
            for remove in (True, False):
                a = JG.stability_mask(lv.board, period, remove)
                b = TG.stability_mask(lv.board, period, remove)
                assert np.array_equal(a, b)


def test_fix_random_values_matches_jax():
    spec = {"a": {"uniform": [0, 2]}, "b": {"choices": ["x", "y", "z"]},
            "c": {"choices": {"p": 1, "q": 3}},
            "d": {"choices": [1, 2], "weights": [0.2, 0.8]}, "e": 7}
    with JRNG.set_rng(np.random.default_rng(9)):
        a = [JG.fix_random_values(spec) for _ in range(20)]
    with TRNG.set_rng(np.random.default_rng(9)):
        b = [TG.fix_random_values(spec) for _ in range(20)]
    assert a == b


def test_find_and_load_files_match_jax(tmp_path):
    params = JIT._load_param_file(os.path.join(
        JL.LEVEL_DIRECTORY, "random", "append-still.yaml"))
    (tmp_path / "spec.json").write_text(json.dumps({
        "board_shape": [12, 12], "named_regions": params["named_regions"],
        "later_regions": "append easy", "min_performance": 0.25}))
    levels = JL.load_levels("benchmarks/v1.0/append-still.npz")[:3]
    JL.save_level(levels[0], str(tmp_path / "one"))
    sub = tmp_path / "sub"
    sub.mkdir()
    JL.save_level(levels[1], str(sub / "two.npz"))
    cases = [("random/append-still",), ("random/multi-agent",),
             ("benchmarks/v1.0/navigation",),
             (str(tmp_path / "spec.json"),), (str(tmp_path / "spec"),),
             (str(tmp_path / "one"),), (str(sub),), ("random/*spawn*",)]
    for paths in cases:
        assert JL.find_files(*paths) == TL.find_files(*paths), paths
    assert JL.find_files("two", level_dirs=[str(sub)]) == \
        TL.find_files("two", level_dirs=[str(sub)])
    with pytest.raises(FileNotFoundError):
        TL.find_files("no/such/level")
    for paths in (["random/multi-agent/build-coop", str(tmp_path / "spec")],
                  ["benchmarks/v1.0/navigation"], [str(sub)]):
        ja, tb = JIT.load_files(paths), TIT.load_files(paths)
        assert [(n, k) for n, k, _ in ja] == [(n, k) for n, k, _ in tb]
        for (_, kind, x), (_, _, y) in zip(ja, tb):
            if kind == "procgen":
                assert json.dumps(x, sort_keys=True) == \
                    json.dumps(y, sort_keys=True)
            else:
                assert_levels_equal(x, y)
    got = TL.load_levels("two", level_dirs=[str(sub)])
    assert_levels_equal(got[0], JL.load_levels(str(sub / "two"))[0])


def test_save_round_trips_through_both_loaders(tmp_path):
    """``save_level`` and ``save_archive`` of either package load back
    through both packages' loaders."""
    # An archive holds levels of one shape and agent count.
    levels = [TIT._level_from_data(*TIT.load_files([
        "random/multi-agent/asym1"])[0], seed=np.random.SeedSequence(s))
        for s in range(2)]
    levels.append(levels[0].copy())
    levels[-1].name = ""  # saved as "level-002"
    for i, (save_l, save_a) in enumerate(((TL.save_level, TL.save_archive),
                                          (JL.save_level, JL.save_archive))):
        arch = str(tmp_path / ("arch%d" % i))
        save_a(levels, arch)
        for load in (TL.load_levels, JL.load_levels):
            back = load(arch + ".npz")
            assert len(back) == len(levels)
            for a, b in zip(levels, back):
                for k in LEVEL_FIELDS:
                    assert np.array_equal(getattr(a, k), getattr(b, k)), k
                assert b.name == (a.name or "level-002")
                assert (b.min_performance, b.spawn_prob) == \
                    (a.min_performance, a.spawn_prob)
        one = str(tmp_path / ("one%d" % i))
        save_l(TL.load_levels("benchmarks/v1.0/append-still.npz")[5], one)
        a, b = TL.load_levels(one)[0], JL.load_levels(one)[0]
        assert_levels_equal(a, b)
        c = a.copy()
        c.board[0, 0] += 1
        assert not np.array_equal(c.board, a.board)


def test_level_iterator_matches_jax():
    """``distinct_levels`` and ``repeat_levels``: the same sequence,
    cached levels included, and the same stop."""
    kw = dict(seed=4, distinct_levels=2)
    a = JIT.SafeLifeLevelIterator("random/append-still-easy",
                                  "benchmarks/v1.0/append-still.npz", **kw)
    b = TIT.SafeLifeLevelIterator("random/append-still-easy",
                                  "benchmarks/v1.0/append-still.npz", **kw)
    for _ in range(5):
        assert_levels_equal(next(a), next(b))
    kw = dict(seed=5, repeat_levels=False, distinct_levels=3)
    a = JIT.SafeLifeLevelIterator("benchmarks/v1.0/navigation.npz", **kw)
    b = TIT.SafeLifeLevelIterator("benchmarks/v1.0/navigation.npz", **kw)
    assert [x.name for x in a] == [y.name for y in b]
    # device_batch anneals on the device asked for; without a card the
    # default "cuda" raises rather than falling back to the CPU.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TIT.SafeLifeLevelIterator("random/append-still", device_batch=2)
    it = TIT.SafeLifeLevelIterator("random/append-still-easy", seed=0,
                                   device_batch=2, device="cpu")
    made = [next(it) for _ in range(2)]
    assert [lv.name for lv in made] == ["append-still-easy-e0",
                                        "append-still-easy-e1"]
    for lv in made:
        assert len(lv.agent_locs) == 1 and lv.board.shape == (26, 26)


class _Logger:
    """The curriculum's logger: a fed ``last_data``, logged scalars kept."""

    def __init__(self):
        self.last_data = None
        self.logged = []
        self.cumulative_stats = {}

    def log_scalars(self, data, global_step=None, tag=None):
        self.logged.append((tag, {k: float(v) for k, v in data.items()}))


def _picks(iterator, set_rng, feed):
    names = []
    with set_rng(np.random.default_rng(17)):
        for i in range(200):
            if feed is not None:
                iterator.logger.last_data = feed[i]
            names.append(os.path.basename(
                iterator.get_next_parameters()[0]))
    return names


def test_switching_and_curricular_iterators_match_jax():
    """200 picks under ``set_rng`` with equal seeds and the same fed
    ``last_data``: the same levels and the same curriculum scalars."""
    p = [0.0]
    ja = JF.SwitchingLevelIterator("random/append-still-easy",
                                   "random/append-spawn", lambda: p[0])
    tb = TF.SwitchingLevelIterator("random/append-still-easy",
                                   "random/append-spawn", lambda: p[0])
    p[0] = 0.3
    a, b = _picks(ja, JRNG.set_rng, None), _picks(tb, TRNG.set_rng, None)
    assert a == b and len(set(a)) == 2

    rng = np.random.default_rng(3)
    stages = ("asym1-e%d", "asym1-pretrain-cyanonly-e%d",
              "asym1-pretrain-redonly-e%d")
    feed = [{"reward": float(rng.integers(0, 10)) * (1 + i / 50),
             "reward_possible": 10.0 + rng.integers(0, 3),
             "level_name": stages[rng.integers(0, 3)] % i}
            for i in range(200)]
    specs = ["random/multi-agent/asym1",
             "random/multi-agent/asym1-pretrain-cyanonly",
             "random/multi-agent/asym1-pretrain-redonly"]
    ja = JF.CurricularLevelIterator(*specs, logger=_Logger())
    tb = TF.CurricularLevelIterator(*specs, logger=_Logger())
    a = _picks(ja, JRNG.set_rng, feed)
    b = _picks(tb, TRNG.set_rng, feed)
    assert a == b and len(set(a)) == 3
    assert len(ja.logger.logged) == len(tb.logger.logged) == 200
    for (ta, da), (tb_, db) in zip(ja.logger.logged, tb.logger.logged):
        assert ta == tb_ == "curriculum" and da.keys() == db.keys()
        for k in da:
            assert da[k] == db[k] or (np.isnan(da[k]) and np.isnan(db[k]))
    assert ja.pop_best_improvement() == tb.pop_best_improvement()


_WORKERS = r"""
import sys
import numpy as np
from safelife_tpu_torch.io.iterator import SafeLifeLevelIterator
with_workers = SafeLifeLevelIterator(
    "random/append-still", seed=np.random.SeedSequence(23), num_workers=2)
serial = SafeLifeLevelIterator(
    "random/append-still", seed=np.random.SeedSequence(23), num_workers=0)
a = [next(with_workers) for _ in range(4)]
workers = [p.pid for p in with_workers.pool._pool]
with_workers.close()
b = [next(serial) for _ in range(4)]
same = all(x.board.tobytes() == y.board.tobytes()
           and x.goals.tobytes() == y.goals.tobytes() and x.name == y.name
           for x, y in zip(a, b))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "safelife_tpu"))
print(same, len(workers), [x.name for x in a], bad)
"""


def test_workers_match_serial_generation():
    """4 levels from 2 forked workers equal 4 generated in the process, in
    a subprocess that imports only the port."""
    out = subprocess.run([sys.executable, "-c", _WORKERS], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == (
        "True 2 ['append-still-e0', 'append-still-e1', 'append-still-e2', "
        "'append-still-e3'] []")
