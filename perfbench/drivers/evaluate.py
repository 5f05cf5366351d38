"""Driver of the evaluation cells: ``training/runner.py::benchmark`` with
side effects, scoring a policy on a level suite cut into parts of
``episodes`` levels, one call a part. The window runs whole rounds of the
suite (every part once, in turn from one the seed picks) until the
window's time has passed, so that every seed scores the same levels.

Set-up builds the policy with the cell's weights (from its
``weights_seed``: a policy's own behaviour sets how many cells an episode
changes and so the EMD's work, which the run's seed may not vary), loads
the suite and
warms every shape up with one call of a part at ``warmup_steps`` steps and
``warmup_samples`` occupancy samples. The window's calls keep what they
drew and produced: each step's actions, the env's and the occupancy's seed
words, the episodes' end states, the occupancy counts and the records.

After the window one call, drawn from the seed, is judged: the plain
reference replays its episodes with its actions and seed words, counts the
occupancy with its seed words and scores every episode in float64, and
compares

* ``eval_mismatches``: elements of the final boards, end steps, episode
  rewards and lengths, successes and occupancy counts that differ, and of
  the records' rewards, lengths, successes and side-effect keys (exact);
* ``side_effect_rel``: the side-effect scores, the largest gap over the
  larger of the reference's score and 1.

The control (``ctx.control``) puts the reference's scores in float32 in
the program's place.
"""

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from perfbench import capture, compare, program
from perfbench.reference import env as R, side_effects as RS


def _call(run, part, env_cfg=None, num_samples=None):
    ctx, p, wl = run["ctx"], run["p"], run["ctx"].wl
    return p.runner.benchmark(
        run["model"], run["parts"][part], num_episodes=wl["episodes"],
        env_cfg=env_cfg or run["env_cfg"], generator=run["gen"],
        num_samples=num_samples or ctx.cfg["side_effects"]["num_samples"],
        side_effect_weights=ctx.cfg["side_effect_weights"],
        lanes=wl["episodes"], device=ctx.device)


def setup(ctx):
    p, cfg, wl, dev = ctx.port, ctx.cfg, ctx.wl, ctx.device
    view = tuple(cfg["view_shape"])
    weights = program.policy_weights(cfg["policy"], view,
                                     wl["weights_seed"], dev)
    levels = p.levels.load_levels(program.levels_path(ctx.root, cfg))
    n = wl["episodes"]
    parts = [levels[i:i + n] for i in range(0, len(levels), n)]
    first = int(ctx.rng("order").integers(len(parts)))
    run = dict(
        ctx=ctx, p=p, parts=parts, env_cfg=program.env_config(p, cfg),
        model=program.policy(p, cfg, weights, dev,
                             cfg["policy"]["precision"]),
        gen=torch.Generator(device=dev).manual_seed(
            ctx.seed_for("generator")),
        order=[(first + i) % len(parts) for i in range(len(parts))],
        calls=[], stack=contextlib.ExitStack())
    ctx.phase("weights, policy and levels")
    _call(run, run["order"][0],
          dataclasses.replace(run["env_cfg"], time_limit=wl["warmup_steps"]),
          wl["warmup_samples"])

    def keep(key, many=True):
        def fn(args, kwargs, out):
            if run["calls"]:
                if many:
                    run["calls"][-1][key].append(out)
                else:
                    run["calls"][-1][key] = out
        return fn

    st = run["stack"]
    st.enter_context(capture.after(p.env, "seed_words", keep("env_words")))
    st.enter_context(capture.after(p.side_effects, "seed_words",
                                   keep("occ_words")))
    st.enter_context(capture.after(p.runner, "_policy_sample",
                                   keep("actions")))
    st.enter_context(capture.after(p.runner, "run_episodes",
                                   keep("out", False)))
    st.enter_context(capture.after(p.runner, "batched_occupancy",
                                   keep("occ", False)))
    return run


def window(run, seconds):
    ctx = run["ctx"]
    ctx.sync()
    n, t0 = 0, time.perf_counter()
    while True:
        for part in run["order"]:
            run["calls"].append(dict(part=part, env_words=[], occ_words=[],
                                     actions=[]))
            run["calls"][-1]["records"] = _call(run, part)[0]
            n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    ctx.sync()
    # What the window kept; the wrappers keep nothing after it.
    run["kept"], run["calls"] = run["calls"], []
    episodes = n * ctx.wl["episodes"]
    return {"attempted": episodes, "episodes": episodes, "calls": n,
            "seconds": time.perf_counter() - t0}


def spans(run):
    p = run["p"]
    return [(p.runner, "run_episodes", "runner.run_episodes", True),
            (p.runner, "batched_occupancy", "runner.batched_occupancy", True),
            (p.runner, "episode_side_effects", "runner.episode_side_effects",
             True)]


def ranges(run):
    return [(m, a, n) for m, a, n, _ in spans(run)]


def profiled(run):
    """One call at the window's sizes, keeping nothing."""
    _call(run, run["order"][0])


def check(run):
    ctx = run["ctx"]
    run["stack"].close()
    calls = run.pop("kept")
    call = calls[int(ctx.rng("check").integers(len(calls)))]
    del calls
    for key in ("model", "gen", "parts"):
        run.pop(key)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return judge(ctx, call)


def judge(ctx, call):
    cfg, wl, dev = ctx.cfg, ctx.wl, ctx.device
    n = wl["episodes"]
    levels = R.read_levels(program.levels_path(ctx.root, cfg))
    part = levels[call["part"] * n:(call["part"] + 1) * n]
    pool = R.pack(part, dev)
    idx = torch.arange(n, device=dev) % len(part)
    limit = cfg["time_limit"]
    s = R.reset(pool, idx, 1.0)
    draws = R.Draws(torch.cat(call["env_words"]).to(dev)
                    if call["env_words"] else None)
    final_board = s.board
    final_steps = torch.full((n,), limit, dtype=torch.int32, device=dev)
    finished = torch.zeros(n, dtype=torch.bool, device=dev)
    for t in range(limit):
        s, _, _, info = R.step_core(pool, s, call["actions"][t].to(dev),
                                    draws, limit)
        new = info["lane_done"] & ~finished
        final_board = torch.where(new[:, None, None], s.board, final_board)
        final_steps = torch.where(new, s.num_steps, final_steps)
        finished = finished | info["lane_done"]
    final_board = torch.where(finished[:, None, None], final_board, s.board)
    success = R.has_exited(pool, s)
    out = call["out"]
    diff = compare.mismatches
    mism = (diff(out["final_board"], final_board)
            + diff(out["final_steps"], final_steps)
            + diff(out["episode_reward"], s.episode_reward)
            + diff(out["episode_length"], s.episode_length)
            + diff(out["success"], success))

    init = pool.board[idx]
    samples = cfg["side_effects"]["num_samples"]
    inaction, action = RS.occupancy(
        init, final_board, final_steps, pool.spawn_prob[idx],
        torch.cat(call["occ_words"]).to(dev), samples, limit)
    mism += diff(call["occ"][0], inaction) + diff(call["occ"][1], action)

    mask = pool.agent_mask[idx].cpu().numpy()
    ep_r = s.episode_reward.cpu().numpy()
    ep_l = s.episode_length.cpu().numpy()
    suc = success.cpu().numpy()
    ina, act = inaction.cpu().numpy(), action.cpu().numpy()
    init, fin = init.cpu().numpy(), final_board.cpu().numpy()
    gap = 0.0
    for lane, rec in enumerate(call["records"]):
        nag = max(int(mask[lane].sum()), 1)
        mism += int(rec["reward"] != float(ep_r[lane][:nag].sum()))
        mism += int(rec["length"] != int(ep_l[lane][:nag].max()))
        mism += int(rec["success"] != bool(suc[lane][:nag].all()))
        ref = RS.episode_scores(init[lane], fin[lane], ina[lane], act[lane],
                                samples, cfg["side_effect_weights"])
        prog = rec["side_effects"]
        if ctx.control:
            prog = RS.episode_scores(init[lane], fin[lane], ina[lane],
                                     act[lane], samples,
                                     cfg["side_effect_weights"], np.float32)
        mism += len(set(prog) ^ set(ref))
        for key in set(prog) & set(ref):
            for a, b in zip(prog[key], ref[key]):
                gap = max(gap, abs(a - b) / max(abs(b), 1.0))
    return {"eval_mismatches": mism, "side_effect_rel": gap}


# ---------------------------------------------------------------------------
# Faults planted in the program


@contextlib.contextmanager
def _unchanged(ctx):
    """The env step returns the state it was given."""
    def make(orig):
        def step(cfg, pool, state, *a, **k):
            _, reward, done, info = orig(cfg, pool, state, *a, **k)
            return state, reward, done, info
        return step
    with capture.patched(ctx.port.env, "step_core", make):
        yield


@contextlib.contextmanager
def _token(ctx):
    """Each episode's first side-effect score altered where it is
    produced."""
    def alter(args, kwargs, out):
        key = sorted(out)[0]
        out[key] = [out[key][0] + 0.5, out[key][1]]
    with capture.after(ctx.port.runner, "episode_side_effects", alter):
        yield


FAULTS = {"unchanged": _unchanged, "token": _token}
