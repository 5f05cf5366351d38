"""The port's layer spans (``utils/trace.py``) on the CPU, at tiny sizes:
with no profiler running no ``record_function`` range is opened on the
training, DQN, rollout and evaluation paths; under ``torch.profiler``
every span appears under its documented parent, as often as documented
(the EMD's two solvers on a side-effect scoring of their own); and the
outputs are bit for bit the same with the profiler on and off."""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from safelife_tpu_torch.env import env as TE, state as TST  # noqa: E402
from safelife_tpu_torch.env import wrappers as TW  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.training import dqn as TD  # noqa: E402
from safelife_tpu_torch.training import ppo as TP  # noqa: E402
from safelife_tpu_torch.training import runner as TR  # noqa: E402
from safelife_tpu_torch.utils import trace  # noqa: E402

VIEW = (17, 17)  # the smallest view the trunk takes
LANES, STEPS = 2, 3
PPO = TP.PPOConfig(steps_per_env=STEPS)
# Evaluation: 3 episodes 2 lanes at a time (2 batches) of 4 steps.
EPISODES, EVAL_LANES, EVAL_STEPS, SAMPLES = 3, 2, 4, 3

#: Each span's parent span on the three paths.
TRAIN_PARENTS = {
    "ppo/iteration": None, "ppo/rollout": "ppo/iteration",
    "policy/sample": "ppo/rollout", "env/step": "ppo/rollout",
    "env/core": "env/step", "env/obs": "env/step",
    "ppo/gae": "ppo/iteration", "ppo/update": "ppo/iteration",
    "ppo/minibatch": "ppo/update", "ppo/metrics": "ppo/iteration"}
ROLLOUT_PARENTS = {
    "rollout/episodes": None, "policy/sample": "rollout/episodes",
    "env/core": "rollout/episodes", "env/obs": "rollout/episodes"}
EVAL_PARENTS = {
    "eval/benchmark": None, "eval/batch": "eval/benchmark",
    "rollout/episodes": "eval/batch", "policy/sample": "rollout/episodes",
    "env/core": "rollout/episodes", "env/obs": "rollout/episodes",
    "side_effects/occupancy": "eval/batch", "eval/readback": "eval/batch",
    "side_effects/emd": "eval/batch",
    "side_effects/emd_exact": "side_effects/emd", "eval/records": "eval/batch"}
DQN_PARENTS = {
    "dqn/unit": None, "dqn/collect": "dqn/unit", "env/step": "dqn/collect",
    "env/core": "env/step", "env/obs": "env/step", "dqn/push": "dqn/collect",
    "dqn/optimize": "dqn/unit"}
SIDE_EFFECTS_PARENTS = {
    "side_effects/emd": None, "side_effects/emd_exact": "side_effects/emd",
    "side_effects/emd_sinkhorn": "side_effects/emd"}

TRAIN_COUNTS = {
    "ppo/iteration": 1, "ppo/rollout": 1, "policy/sample": STEPS,
    "env/step": STEPS, "env/core": STEPS, "env/obs": STEPS, "ppo/gae": 1,
    "ppo/update": 1,
    "ppo/minibatch": PPO.epochs_per_batch * (PPO.num_minibatches + 1),
    "ppo/metrics": 1}
ROLLOUT_COUNTS = {"rollout/episodes": 1, "policy/sample": EVAL_STEPS,
                  "env/core": EVAL_STEPS, "env/obs": EVAL_STEPS + 1}
BATCHES = -(-EPISODES // EVAL_LANES)
EVAL_COUNTS = {
    "eval/benchmark": 1, "eval/batch": BATCHES, "rollout/episodes": BATCHES,
    "policy/sample": BATCHES * EVAL_STEPS, "env/core": BATCHES * EVAL_STEPS,
    "env/obs": BATCHES * (EVAL_STEPS + 1),
    "side_effects/occupancy": BATCHES, "eval/readback": BATCHES,
    "side_effects/emd": EPISODES, "eval/records": BATCHES,
    # Each of the three episodes changes one cell type's distribution.
    "side_effects/emd_exact": EPISODES}
DQN_COUNTS = {"dqn/unit": 1, "dqn/collect": 1, "dqn/push": 1,
              "dqn/optimize": 1, "env/step": 1, "env/core": 1, "env/obs": 1}
SIDE_EFFECTS_COUNTS = {"side_effects/emd": 1, "side_effects/emd_exact": 1,
                       "side_effects/emd_sinkhorn": 1}


def _policy():
    torch.manual_seed(0)
    return TN.SafeLifePolicyNetwork(view_shape=VIEW,
                                    unpack_channels=TN.TRAINING_CHANNELS,
                                    device="cpu")


def _train():
    """One iteration from a fresh learner and env state, set up: it
    returns (learner, env state, observations, metrics)."""
    levels = TL.load_levels("benchmarks/v1.0/append-spawn.npz")[:3]
    pool = TST.pack_levels(levels, device="cpu")
    cfg = TE.EnvConfig(view_shape=VIEW, output_channels=None, time_limit=2)
    wcfg = TW.WrapperConfig(se_baseline="inaction")
    ps = TP.init_ppo_state(PPO, _policy(), device="cpu")
    ws, obs = TW.reset(cfg, wcfg, pool, LANES, device="cpu")
    gen = torch.Generator().manual_seed(4)
    return lambda: TP.train_iteration(cfg, wcfg, PPO, pool, ps, ws, obs,
                                      gen, 1.0, device="cpu")


def _dqn():
    """One unit (a step of every lane, then an Adam step) of a learner
    whose replay is warm, set up: it returns (learner, env state,
    observations, metrics)."""
    levels = TL.load_levels("benchmarks/v1.0/append-spawn.npz")[:3]
    pool = TST.pack_levels(levels, device="cpu")
    cfg = TE.EnvConfig(view_shape=VIEW, output_channels=None, time_limit=3)
    wcfg = TW.WrapperConfig()
    dcfg = TD.DQNConfig(batch_size=4, optimize_interval=LANES,
                        replay_size=16, replay_initial=1,
                        target_update_interval=LANES)
    torch.manual_seed(0)
    model = TN.SafeLifeQNetwork(view_shape=VIEW,
                                unpack_channels=TN.TRAINING_CHANNELS,
                                device="cpu")
    ws, obs = TW.reset(cfg, wcfg, pool, LANES, device="cpu")
    ds = TD.init_dqn_state(dcfg, model, LANES, VIEW, obs.dtype, device="cpu")
    gen = torch.Generator().manual_seed(5)
    # The rings fill and the first episodes end: the replay is warm.
    for _ in range(3):
        _, ws, obs, _ = TD.collect_and_optimize(cfg, wcfg, dcfg, pool, ds,
                                                ws, obs, gen, 1, device="cpu")
    assert ds.replay.size() >= dcfg.replay_initial
    return lambda: TD.collect_and_optimize(cfg, wcfg, dcfg, pool, ds, ws,
                                           obs, gen, 1, device="cpu")


def _eval_setup():
    levels = TL.load_levels("benchmarks/v1.0/prune-spawn.npz")[:EPISODES]
    cfg = TE.EnvConfig(view_shape=VIEW, output_channels=None,
                       time_limit=EVAL_STEPS)
    return levels, cfg, _policy(), torch.Generator().manual_seed(7)


def _rollout():
    levels, cfg, model, gen = _eval_setup()
    pool = TST.pack_levels(levels, device="cpu")
    return lambda: TR.run_episodes(cfg, pool, model,
                                   torch.arange(EVAL_LANES), gen, EVAL_STEPS)


def _benchmark():
    levels, cfg, model, gen = _eval_setup()
    return lambda: TR.benchmark(
        model, levels, EPISODES, env_cfg=cfg, generator=gen,
        num_samples=SAMPLES, lanes=EVAL_LANES, device="cpu")


def _side_effects():
    """One episode's scoring in which one colour of life differs in 360
    cells (above ``EXACT_EMD_MAX_CELLS``: the Sinkhorn solve) and another in
    2 (the exact solve)."""
    rng = np.random.default_rng(9)
    cells = rng.choice(26 * 26, 362, replace=False)
    inaction = np.zeros((26 * 26, 8), np.int64)
    action = np.zeros((26 * 26, 8), np.int64)
    inaction[cells[:180], 0] = rng.integers(1, 1001, 180)
    action[cells[180:360], 0] = rng.integers(1, 1001, 180)
    inaction[cells[360], 1] = action[cells[361], 1] = 500
    board = np.zeros((26, 26), np.int32)
    return lambda: TR.episode_side_effects(
        board, board, 0, 0.3, inaction.reshape(26, 26, 8),
        action.reshape(26, 26, 8), 1000)


#: Each path's set-up, which returns its call, the parents and the counts.
PATHS = {"train_iteration": (_train, TRAIN_PARENTS, TRAIN_COUNTS),
         "run_episodes": (_rollout, ROLLOUT_PARENTS, ROLLOUT_COUNTS),
         "benchmark": (_benchmark, EVAL_PARENTS, EVAL_COUNTS),
         "collect_and_optimize": (_dqn, DQN_PARENTS, DQN_COUNTS),
         "episode_side_effects": (_side_effects, SIDE_EFFECTS_PARENTS,
                                  SIDE_EFFECTS_COUNTS)}


def _spans(prof):
    """[(span, its nearest enclosing span or None)] of a profile."""
    out = []
    for e in prof.events():
        if e.name not in trace.SPANS:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name not in trace.SPANS:
            parent = parent.cpu_parent
        out.append((e.name, None if parent is None else parent.name))
    return out


def test_span_is_a_shared_no_op_without_a_profiler():
    assert trace.span("ppo/update") is trace.span("env/step")
    with trace.span("ppo/update") as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("ppo/update"):
            pass
    assert [e.name for e in prof.events()] == ["ppo/update"]


def test_span_names_are_distinct_and_slashed():
    assert len(set(trace.SPANS)) == len(trace.SPANS)
    assert all("/" in s and "." not in s for s in trace.SPANS)
    covered = set().union(*(counts for _, _, counts in PATHS.values()))
    assert covered == set(trace.SPANS)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_range_without_a_profiler(path, monkeypatch):
    """``torch.profiler.record_function`` raises if entered; the autograd
    name of it (which torch's own optimizers enter) raises for the port's
    span names."""
    def refuse(name, *args):
        raise AssertionError("record_function(%r) entered" % name)
    original = torch.autograd.profiler.record_function

    def refuse_spans(name, *args):
        if name in trace.SPANS:
            refuse(name)
        return original(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        refuse_spans)
    PATHS[path][0]()()


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_nest_and_count_under_a_profiler(path):
    setup, parents, counts = PATHS[path]
    call = setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    spans = _spans(prof)
    got = {}
    for name, parent in spans:
        got[name] = got.get(name, 0) + 1
        assert parent == parents[name], (name, parent)
    assert got == counts


def _equal(a, b, where="out"):
    """Bit for bit equality of nested outputs (tensors, dataclasses, dicts,
    lists, numbers, strings)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name),
                   where + "." + f.name)
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], "%s[%r]" % (where, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, "%s[%d]" % (where, i))
    elif isinstance(a, torch.nn.Module):
        _equal(a.state_dict(), b.state_dict(), where)
    elif isinstance(a, torch.optim.Optimizer):
        _equal(a.state_dict()["state"], b.state_dict()["state"], where)
    elif hasattr(a, "dtype"):  # numpy
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


@pytest.mark.parametrize("path", sorted(PATHS))
def test_outputs_bit_identical_with_and_without_a_profiler(path):
    setup = PATHS[path][0]
    off = copy.deepcopy(setup()())
    call = setup()
    with profile(activities=[ProfilerActivity.CPU]):
        on = call()
    _equal(off, on)
