"""Driver of the rollout cells: ``training/runner.py::run_episodes``, one
policy-driven episode a lane for ``steps`` lockstep steps, lane j on level
j mod L of the configuration's suite, with no side-effect scoring.

Set-up builds the policy with the benchmark's weights and the pool, and
warms every shape up with one call of ``warmup_steps`` steps. The window's
calls keep each step's actions and seed words, the views and the policy's
outputs at ``sampled`` steps drawn from the seed (the first and the last
among them), and the episodes' end states.

After the window one call, drawn from the seed, is judged: the plain
reference replays ``judged`` of its lanes, drawn from the seed (all of
them without the key), with their actions and the call's seed words, and
compares

* ``rollout_mismatches``: elements of the views at the sampled steps, the
  final boards, end steps, episode rewards and lengths and successes that
  differ, and actions outside the policy's range (exact);
* ``policy_rel``: the policy's values and probabilities at the sampled
  steps against the reference network's on the reference's views, gap
  norm over reference norm, the larger.

The control (``ctx.control``) runs the program's policy in TF32.
"""

import contextlib
import gc
import time

import torch

from perfbench import capture, compare, peaks, program
from perfbench.reference import env as R, policy as RP


def _call(run, steps):
    return run["p"].runner.run_episodes(
        run["env_cfg"], run["pool"], run["model"], run["idx"], run["gen"],
        steps)


def setup(ctx):
    p, cfg, wl, dev = ctx.port, ctx.cfg, ctx.wl, ctx.device
    view = tuple(cfg["view_shape"])
    weights = program.policy_weights(cfg["policy"], view,
                                     ctx.seed_for("weights"), dev)
    pool = p.state.pack_levels(
        p.levels.load_levels(program.levels_path(ctx.root, cfg)), device=dev)
    model = program.policy(p, cfg, weights, dev, "tensorfloat32"
                           if ctx.control else cfg["policy"]["precision"])
    steps = wl["steps"]
    sampled = ctx.rng("sampled").choice(steps - 1, wl["sampled"] - 2,
                                        replace=False) + 1
    run = dict(
        ctx=ctx, p=p, pool=pool, model=model,
        env_cfg=program.env_config(p, cfg),
        idx=torch.arange(wl["lanes"], device=dev) % pool.num_levels,
        gen=torch.Generator(device=dev).manual_seed(
            ctx.seed_for("generator")),
        weights={k: v.to("cpu", copy=True) for k, v in weights.items()},
        sampled=sorted({0, steps - 1, *map(int, sampled)}),
        calls=[], stack=contextlib.ExitStack())
    ctx.phase("weights, policy and pool")
    _call(run, wl["warmup_steps"])
    ctx.sync()

    want = set(run["sampled"])
    forward = model.forward

    def policy_sample(orig):
        def fn(model_, obs, generator):
            call = run["calls"][-1] if run["calls"] else None
            if call is not None and len(call["actions"]) in want:
                call["views"].append(obs.clone())
                call["grab"] = True
            out = orig(model_, obs, generator)
            if call is not None:
                call["actions"].append(out)
                call["grab"] = False
            return out
        return fn

    def grab(obs):
        out = forward(obs)
        call = run["calls"][-1] if run["calls"] else None
        if call is not None and call.get("grab"):
            call["policy"].append(tuple(x.clone() for x in out))
        return out

    def keep(key):
        def fn(args, kwargs, out):
            if run["calls"]:
                call = run["calls"][-1]
                if key == "out":
                    call["out"] = out
                else:
                    call[key].append(out)
        return fn

    st = run["stack"]
    st.enter_context(capture.after(p.env, "seed_words", keep("words")))
    st.enter_context(capture.patched(p.runner, "_policy_sample",
                                     policy_sample))
    st.enter_context(capture.after(p.runner, "run_episodes", keep("out")))
    model.forward = grab
    st.callback(lambda: setattr(model, "forward", forward))
    return run


def window(run, seconds):
    ctx, wl = run["ctx"], run["ctx"].wl
    ctx.sync()
    n, t0 = 0, time.perf_counter()
    while True:
        run["calls"].append(dict(actions=[], words=[], views=[], policy=[]))
        _call(run, wl["steps"])
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    ctx.sync()
    elapsed = time.perf_counter() - t0
    # What the window kept; the wrappers keep nothing after it.
    run["kept"], run["calls"] = run["calls"], []
    nbytes, nops = step_work(run)
    macs, _ = peaks.policy_macs(ctx.cfg["policy"],
                                tuple(ctx.cfg["view_shape"]))
    env_steps = n * wl["lanes"] * wl["steps"]
    return {"attempted": n, "calls": n, "seconds": elapsed,
            "env_steps": env_steps, "step_bytes": nbytes, "step_ops": nops,
            "policy_flops": env_steps * run["pool"].num_agents * 2 * macs}


def spans(run):
    p = run["p"]
    return [(p.env, "step_core", "env.step_core", False)]


def ranges(run):
    p = run["p"]
    return [(p.env, "step_core", "env.step"),
            (p.env, "_batch_obs", "env.step"),
            (p.runner, "_policy_sample", "runner._policy_sample")]


def ranged(run):
    """The env step's two calls as ranges that wait for the device."""
    p = run["p"]
    return [(p.env, "step_core", "env.step"),
            (p.env, "_batch_obs", "env.step")]


def profiled(run):
    """``profile_steps`` steps at the window's lanes, keeping nothing."""
    _call(run, run["ctx"].wl["profile_steps"])


def step_work(run):
    """(bytes, int32 operations) of one env step at the window's lanes:
    the agents' actions and the CA step of every board (and of goals that
    evolve), and the views, at the lanes' starting agents and exits (a
    view's work does not depend on where its centre lies)."""
    pool, idx = run["pool"], run["idx"]
    b = idx.shape[0]
    h, w = pool.board_shape
    a = pool.num_agents
    nbytes, nops = peaks.board_step_work(b, h, w, a)
    if not pool.all_goals_static:
        gb, go = peaks.goals_step_work(b, h, w)
        nbytes, nops = nbytes + gb, nops + go
    locs = pool.agent_locs.index_select(0, idx)
    mask = pool.agent_mask.index_select(0, idx)
    centre = torch.where(mask[..., None], locs, 0)
    vb, vo = peaks.view_work(h, w, centre[..., 0], centre[..., 1],
                             pool.exit_locs.index_select(0, idx),
                             pool.exit_locs_valid.index_select(0, idx),
                             tuple(run["ctx"].cfg["view_shape"]))
    return nbytes + vb, nops + vo


def check(run):
    ctx = run["ctx"]
    run["stack"].close()
    calls = run.pop("kept")
    call = calls[int(ctx.rng("check").integers(len(calls)))]
    del calls
    for key in ("model", "gen", "pool", "idx"):
        run.pop(key)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    with RP.strict_float32():
        return _judge(run, call)


def judged_lanes(ctx):
    """The lanes the reference replays, int64 on the device: ``judged``
    lanes drawn from the seed, in order (each lane's episode is its own,
    its coins numbered by its lane), or every lane."""
    n, k = ctx.wl["lanes"], ctx.wl.get("judged")
    lanes = (range(n) if not k or k >= n else
             sorted(ctx.rng("judged").choice(n, k, replace=False)))
    return torch.tensor(list(lanes), dtype=torch.int64, device=ctx.device)


def _judge(run, call):
    ctx = run["ctx"]
    cfg, wl, dev = ctx.cfg, ctx.wl, ctx.device
    view = tuple(cfg["view_shape"])
    pool = R.pack(R.read_levels(program.levels_path(ctx.root, cfg)), dev)
    lanes = judged_lanes(ctx)
    n = lanes.shape[0]
    idx = lanes % pool.num_levels
    params = {k: v.to(dev) for k, v in run["weights"].items()}
    s = R.reset(pool, idx, 1.0)
    draws = R.Draws(torch.cat(call["words"]).to(dev)
                    if call["words"] else None)
    steps = wl["steps"]
    final_board = s.board
    final_steps = torch.full((n,), steps, dtype=torch.int32, device=dev)
    finished = torch.zeros(n, dtype=torch.bool, device=dev)
    diff = compare.mismatches
    mism, pol = 0, []
    sampled = iter(zip(call["views"], call["policy"]))
    for t in range(steps):
        act = call["actions"][t].to(dev)
        mism += int(((act < 0) | (act >= cfg["policy"]["actions"])).sum())
        act = act.index_select(0, lanes)
        if t in run["sampled"]:
            views, (value, probs) = next(sampled)
            ref = R.views(pool, s, view)
            mism += diff(views.index_select(0, lanes), ref)
            b, a = ref.shape[:2]
            rows = (lanes[:, None] * a
                    + torch.arange(a, device=dev)).reshape(-1)
            rv, rp = RP.forward(cfg["policy"], params,
                                ref.reshape((b * a,) + view))
            pol.append(max(compare.rel(value.index_select(0, rows), rv),
                           compare.rel(probs.index_select(0, rows), rp)))
        s, _, _, info = R.step_core(pool, s, act, draws, cfg["time_limit"],
                                    lanes)
        new = info["lane_done"] & ~finished
        final_board = torch.where(new[:, None, None], s.board, final_board)
        final_steps = torch.where(new, s.num_steps, final_steps)
        finished = finished | info["lane_done"]
    final_board = torch.where(finished[:, None, None], final_board, s.board)
    out = {k: v.index_select(0, lanes) for k, v in call["out"].items()}
    mism += (diff(out["final_board"], final_board)
             + diff(out["final_steps"], final_steps)
             + diff(out["episode_reward"], s.episode_reward)
             + diff(out["episode_length"], s.episode_length)
             + diff(out["success"], R.has_exited(pool, s)))
    if len(pol) != len(run["sampled"]):
        mism += 1
    return {"rollout_mismatches": mism, "policy_rel": max(pol)}


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
    """One element of every lane's views altered where it is produced."""
    def alter(args, kwargs, out):
        out.view(out.shape[0], -1)[:, 0] ^= 1
    with capture.after(ctx.port.env, "_batch_obs", alter):
        yield


FAULTS = {"unchanged": _unchanged, "token": _token}
