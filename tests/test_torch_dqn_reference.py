"""The port's DQN unit (``training/dqn.py``: ``collect``, then ``optimize``)
against the benchmark's plain reference (``perfbench/reference/dqn.py``, which
imports nothing of the port), on the CPU at a small size: 4 lanes, 25x25 packed
views, a replay of 64 entries, 8 samples an Adam step.

The units run long enough to hold episode ends (a time limit of 9 steps), ring
flushes, replay wraps and target syncs; the test asserts it saw each. Integer
results are held bit for bit: every step's views, boards and locations, the
n-step rings (which clear where a step ends its episode), every pushed row and
its slot, and the replay's whole contents. The rewards are float32 results
computed the same way on both sides (a float64 sum rounded once) and are held
bit for bit too. The network's results are float32 ones of one Adam step from
the same parameters: the Q-values and the TD loss within 1e-5 relative (the
port's trunk and the reference's run the same float32 convolutions; the dueling
sum and the linear layers may sum in another order, ~1e-7), each gradient
within 1e-4 of its largest magnitude (a gradient sums 8 samples' products,
whose rounding differs more near zero), and Adam's change within 1e-3 of its
own norm (a rounding difference in a gradient near zero moves a weight by up to
the learning rate, and the norm over all weights keeps such weights' share
small). The target network equals the online network bit for bit at each sync,
and is otherwise unchanged."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from perfbench.reference import dqn as RD  # noqa: E402
from perfbench.reference import env as R  # noqa: E402
from perfbench.reference import policy as RP  # noqa: E402
from safelife_tpu_torch.env import env as TE, state as TST  # noqa: E402
from safelife_tpu_torch.env import wrappers as TW  # noqa: E402
from safelife_tpu_torch.io import levels as TL  # noqa: E402
from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.training import dqn as TD  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = "benchmarks/v1.0/append-spawn.npz"
VIEW = (25, 25)
LANES, CAP, BATCH, UNITS, TIME_LIMIT = 4, 64, 8, 40, 9
CFG = TD.DQNConfig(batch_size=BATCH, optimize_interval=LANES,
                   replay_size=CAP, replay_initial=16,
                   target_update_interval=3 * LANES)
WRAPPER = dict(movement_bonus=0.1, movement_bonus_period=4,
               movement_bonus_power=1e-100, movement_as_penalty=True,
               single_agent=True, exit_bonus=0.5,
               se_baseline="starting-state", ignore_reward_cells=False,
               continuing=False)
NET = {"channels": list(TN.TRAINING_CHANNELS),
       "convs": [{"name": "cnn.conv%d" % i, "stride": s}
                 for i, s in enumerate((2, 2, 1))],
       "adv_hidden": "adv_hidden", "adv": "adv",
       "value_hidden": "value_hidden", "value": "value"}
FIELDS = ("obs", "action", "reward", "next_obs", "done")


def _model(seed):
    torch.manual_seed(seed)
    return TN.flax_init_(TN.SafeLifeQNetwork(
        view_shape=VIEW, unpack_channels=TN.TRAINING_CHANNELS, device="cpu"))


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _rel(got, ref):
    return float((got.double() - ref.double()).norm()
                 / max(float(ref.double().norm()), 1e-30))


def test_q_forward_matches_reference():
    model = _model(3)
    views = torch.randint(-2 ** 31, 2 ** 31 - 1, (16,) + VIEW,
                          dtype=torch.int32,
                          generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = model(views)
    assert _rel(got, RD.forward(NET, _params(model), views)) < 1e-5


class _Recorded:
    """The env's draws of one step (its seed words and reset picks), kept
    where the port's step makes them."""

    def __init__(self, monkeypatch):
        self.words, self.picks = [], []
        for name, out in (("seed_words", self.words),
                          ("reset_picks", self.picks)):
            orig = getattr(TE, name)

            def call(*a, _orig=orig, _out=out, **k):
                r = _orig(*a, **k)
                _out.append(r.clone())
                return r
            monkeypatch.setattr(TE, name, call)

    def take(self):
        draws = R.Draws(torch.cat(self.words) if self.words else None,
                        torch.cat(self.picks) if self.picks else None)
        self.words.clear()
        self.picks.clear()
        return draws


@pytest.mark.parametrize("seed", [0, 1])
def test_units_match_reference(seed, monkeypatch):
    recorded = _Recorded(monkeypatch)
    rng = np.random.default_rng(seed)
    levels = TL.load_levels(LEVELS)
    pool = TST.pack_levels(levels, device="cpu")
    env_cfg = TE.EnvConfig(view_shape=VIEW, output_channels=None,
                           time_limit=TIME_LIMIT)
    wcfg = TW.WrapperConfig(**WRAPPER)
    model = _model(seed)
    ws, obs = TW.reset(env_cfg, wcfg, pool, LANES, device="cpu")
    dstate = TD.init_dqn_state(CFG, model, LANES, VIEW, torch.int32,
                               device="cpu")
    gen = torch.Generator().manual_seed(seed)

    rpool = R.pack(R.read_levels(os.path.join(
        ROOT, "safelife_tpu", "levels", *LEVELS.split("/"))), "cpu")
    rwcfg = R.WrapperConfig(**WRAPPER)
    rws = R.wrap(rwcfg, R.reset(rpool, torch.arange(LANES)
                                % rpool.num_levels, 1.0))
    rings = RD.Rings(obs=torch.zeros((LANES, CFG.multi_step) + VIEW,
                                     dtype=torch.int32),
                     action=torch.zeros((LANES, CFG.multi_step),
                                        dtype=torch.int32),
                     reward=torch.zeros((LANES, CFG.multi_step)),
                     filled=torch.zeros((LANES, CFG.multi_step),
                                        dtype=torch.bool))
    replay = {"obs": torch.zeros((CAP,) + VIEW, dtype=torch.int32),
              "next_obs": torch.zeros((CAP,) + VIEW, dtype=torch.int32),
              "action": torch.zeros(CAP, dtype=torch.int32),
              "reward": torch.zeros(CAP), "done": torch.zeros(
                  CAP, dtype=torch.bool)}
    idx, num_steps = 0, 0
    target = _params(model)
    adam = RP.Adam(_params(model), CFG.learning_rate)
    seen = dict(done=0, flushed=0, wrapped=0, synced=0, stepped=0)
    rviews = R.views(rpool, rws.env, VIEW)
    assert torch.equal(obs, rviews)

    kept = {}
    model.register_forward_hook(
        lambda m, a, out: kept.__setitem__("q", out.detach().clone()))
    dstate.optimizer.register_step_pre_hook(
        lambda o, a, k: kept.__setitem__("grads", {
            n: p.grad.clone() for n, p in model.named_parameters()}))
    for _ in range(UNITS):
        acts = torch.as_tensor(rng.integers(0, 9, (1, LANES, 1)))
        ws, obs, _ = TD.collect(env_cfg, wcfg, CFG, pool, dstate, ws, obs,
                                gen, 1, actions=acts)
        # The reference's step, its rings and its push.
        flat = rviews.reshape((-1,) + VIEW)
        valid = (rws.env.is_active
                 & rpool.agent_mask[rws.env.level_idx]).reshape(-1)
        rws, reward, done, _ = R.wrapped_step(
            rpool, rwcfg, rws, acts[0], recorded.take(), TIME_LIMIT, 0.0,
            1.0)
        rviews = R.views(rpool, rws.env, VIEW)
        assert torch.equal(obs, rviews)
        assert torch.equal(ws.env.board, rws.env.board)
        assert torch.equal(ws.env.agent_locs, rws.env.agent_locs)
        rings, cand = RD.ring_step(
            CFG.gamma, rings, flat, acts[0].reshape(-1), reward.reshape(-1),
            rviews.reshape((-1,) + VIEW), done.reshape(-1), valid)
        for k in ("obs", "action", "reward", "filled"):
            assert torch.equal(getattr(dstate.traj, k), getattr(rings, k)), k
        rows, slots, new_idx = RD.push(cand, idx, CAP)
        seen["done"] += int(done.any())
        seen["flushed"] += int(cand["valid"][2:].any())
        seen["wrapped"] += int(new_idx // CAP > idx // CAP)
        idx = new_idx
        for k in FIELDS:
            replay[k][slots] = rows[k].to(replay[k].dtype)
            assert torch.equal(getattr(dstate.replay, k), replay[k]), k
        assert dstate.replay.idx == idx
        num_steps += LANES
        assert dstate.num_steps == num_steps

        # The program's Adam step and the reference's, from the same
        # parameters and moments.
        size = min(idx, CAP)
        sample = torch.as_tensor(rng.integers(0, max(size, 1), BATCH))
        before = _params(model)
        kept.pop("grads", None)
        metrics = TD.optimize(CFG, dstate, gen, LANES, sample_idx=sample)
        batch = {k: v[sample] for k, v in replay.items()}
        loss, q, grads = RD.grads(CFG.gamma, CFG.multi_step, NET, before,
                                  target, batch)
        assert _rel(kept["q"], q) < 1e-5
        assert abs(float(metrics["loss"]) - loss) <= 1e-5 * abs(loss)
        if size >= CFG.replay_initial:
            seen["stepped"] += 1
            for k, g in grads.items():
                tol = 1e-4 * max(float(g.abs().max()), 1e-30)
                assert float((kept["grads"][k] - g).abs().max()) <= tol, k
            # Adam from the program's own moments, as they were before.
            ref = adam.step(before, kept["grads"])
            for k in ref:
                change = ref[k] - before[k]
                got = _params(model)[k] - before[k]
                assert _rel(got, change) < 1e-3, k
            adam.m = {k: dstate.optimizer.state[p]["exp_avg"].clone()
                      for k, p in model.named_parameters()}
            adam.v = {k: dstate.optimizer.state[p]["exp_avg_sq"].clone()
                      for k, p in model.named_parameters()}
        else:
            assert all(torch.equal(v, before[k])
                       for k, v in _params(model).items())
        if RD.syncs(num_steps, LANES, CFG.target_update_interval):
            target = _params(model)
            seen["synced"] += 1
        for k, v in dstate.target_model.named_parameters():
            assert torch.equal(v, target[k]), k
    assert all(seen.values()), seen
