"""The port's episode loggers against the JAX package's, on the CPU: fed the
same records, both write the same JSON apart from each entry's ``time``,
each package's summaries read the other's files to the same numbers, the
episode collectors give the same episodes, and a history is saved as the
same ``.npz``."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from safelife_tpu import loggers as JLOG  # noqa: E402
from safelife_tpu_torch import loggers as TLOG  # noqa: E402

WEIGHTS = {"life-green": 1.0, "spawner-yellow": 2.0}


def records(seed=0, n=7):
    """Benchmark-like records: single and multi-agent, with and without a
    weighted side-effect total, numpy scalars among them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rec = {
            "level_name": "level-%03d.npz" % i,
            "reward": float(rng.integers(-2, 30)),
            "length": int(rng.integers(1, 1001)),
            "success": bool(rng.random() < 0.5),
            "reward_possible": float(rng.integers(1, 40)),
            "reward_needed": np.int64(rng.integers(0, 20)),
            "side_effects": {
                "life-green": [float(rng.random() * 5), 20.0],
                "crate-gray": [np.float64(rng.random()), 3.0],
                "spawner-yellow": [0.0, float(rng.integers(0, 4))],
            },
        }
        rec["side_effects"]["total"] = [
            rec["side_effects"]["life-green"][0]
            + 2 * rec["side_effects"]["spawner-yellow"][0], 20.0]
        if i % 3 == 2:
            rec["reward_agents"] = np.float32([1.0, 2.5])
            rec["success_agents"] = [True, False]
        if i % 4 == 3:
            rec["min_performance"] = 0.5
        out.append(rec)
    return out


def _entries(path):
    with open(path) as f:
        data = json.load(f)
    for entry in data:
        assert "time" in entry
        entry.pop("time")
    return data


@pytest.mark.parametrize("episode_type,name", [
    ("benchmark", "benchmark-data.json"),
    ("validation", "validation-log.json"),
    ("training", "training-log.json")])
def test_loggers_write_the_same_json(tmp_path, episode_type, name):
    dirs = {}
    for pkg, mod in (("jax", JLOG), ("port", TLOG)):
        d = str(tmp_path / pkg)
        lg = mod.SafeLifeLogger(d, episode_type=episode_type,
                                summary_writer=False)
        before = lg.cumulative_stats[episode_type + "_episodes"]
        recs = records()
        for rec in recs:
            lg.log_episode(rec)
        assert lg.cumulative_stats[episode_type + "_episodes"] \
            == before + len(recs)
        assert lg.last_data["level_name"] == recs[-1]["level_name"]
        dirs[pkg] = d
    jdata = _entries(os.path.join(dirs["jax"], name))
    tdata = _entries(os.path.join(dirs["port"], name))
    assert tdata == jdata and len(tdata) == 7

    # Each package's summary of either file is the same.
    for weights in (None, WEIGHTS):
        ref = JLOG.summarize_run_file(os.path.join(dirs["jax"], name),
                                      weights)
        for d in dirs.values():
            path = os.path.join(d, name)
            assert JLOG.summarize_run_file(path, weights) == ref
            assert TLOG.summarize_run_file(path, weights) == ref
    assert TLOG.summarize_run(dirs["port"]) == \
        JLOG.summarize_run(dirs["jax"])


def test_loaded_logs_and_scores_match_jax(tmp_path):
    path = str(tmp_path / "benchmark-data.json")
    w = TLOG.StreamingJSONWriter(path)
    for rec in records(1):
        w.dump(TLOG._jsonable(rec))
    w.close()
    # Resuming a log appends to the same list; a broken file is rewritten.
    w = TLOG.StreamingJSONWriter(path)
    w.dump({"reward": 1.0, "reward_possible": 2.0, "length": 3})
    w.close()
    got, ref = TLOG.load_safelife_log(path), JLOG.load_safelife_log(path)
    assert set(got) == set(ref) and "side_effects.life-green" in got
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for weights in (None, WEIGHTS):
        for a, b in zip(TLOG.combined_score(got, weights),
                        JLOG.combined_score(ref, weights)):
            np.testing.assert_array_equal(a, b)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("[{\"a\": 1},")
    TLOG.StreamingJSONWriter(bad).close()
    with open(bad) as f:
        assert json.load(f) == []


def test_episode_collectors_match_jax(tmp_path):
    """Finished lanes of batched step records, single- and multi-agent,
    with slot metadata and per-lane score denominators."""
    rng = np.random.default_rng(2)
    meta = {i: {"name": "slot-%d" % i, "reward_possible": 10.0 + i,
                "reward_needed": i} for i in range(4)}
    infos = []
    for a in (1, 2):
        b = 6
        info = {
            "lane_done": rng.random(b) < 0.6,
            "level_idx": rng.integers(0, 4, b),
            "episode_length": rng.integers(1, 50, (b, a)),
            "episode_reward": rng.normal(size=(b, a)).astype(np.float32),
            "success": rng.random((b, a)) < 0.5,
        }
        infos.append(info)
        infos.append(dict(info, agent_mask=np.arange(a) < np.ones((b, 1)),
                          reward_possible=rng.random((b, a)) * 9,
                          reward_needed=rng.integers(0, 5, (b, a))))
    eps = {}
    for pkg, mod in (("jax", JLOG), ("port", TLOG)):
        lg = mod.SafeLifeLogger(str(tmp_path / pkg),
                                episode_type="validation",
                                summary_writer=False)
        steps = lg.cumulative_stats["validation_steps"]
        se = (lambda lane, info: {"total": [float(lane), 2.0]})
        col = mod.EpisodeCollector(lg, level_meta=meta, side_effects_fn=se)
        eps[pkg] = [col.observe(info, batch_steps=11) for info in infos]
        eps[pkg].append(col.observe(infos[0], record_only=True))
        assert lg.last_data == eps[pkg][-1][-1]
        assert lg.cumulative_stats["validation_steps"] == steps + 44
        assert mod.EpisodeCollector(None).observe(infos[0]) == []
    assert eps["port"] == eps["jax"]
    assert sum(len(e) for e in eps["port"]) > 5
    assert _entries(tmp_path / "port" / "validation-log.json") == \
        _entries(tmp_path / "jax" / "validation-log.json")


def test_history_and_scalars(tmp_path):
    """A history is saved once under its video name; scalars average with
    the polyak weight and the shared cumulative stats come along."""
    rng = np.random.default_rng(3)
    history = {"board": rng.integers(0, 1 << 16, (5, 6, 7)).astype(np.uint16),
               "goals": rng.integers(0, 1 << 16, (5, 6, 7)).astype(np.uint16)}
    lg = TLOG.SafeLifeLogger(str(tmp_path), episode_type="benchmark",
                             summary_writer=False)
    rec = dict(records()[0], level_name="lvl-001.npz")
    lg.log_episode(rec, history=history)
    lg.log_episode(rec, history={"board": history["board"][:1]})
    with np.load(tmp_path / "benchmark-lvl-001.npz") as saved:
        for k in history:
            np.testing.assert_array_equal(saved[k], history[k])
    assert lg.last_history["board"].shape == (1, 6, 7)

    sums = []
    for mod in (JLOG, TLOG):
        lg = mod.SafeLifeLogger(None, episode_type="training",
                                summary_writer="auto")
        for x in (1.0, 3.0, float("nan"), 2.0):
            lg.log_scalars({"x": x, "y": 2 * x}, tag="ppo")
        assert lg.summary_writer is False
        sums.append(dict(lg.summary_stats))
    assert sums[0] == sums[1] and 1.0 < sums[1]["ppo/x"] < 3.0
    with pytest.raises(ValueError, match="Unrecognized"):
        TLOG.SafeLifeLogger(None, no_such_option=1)
