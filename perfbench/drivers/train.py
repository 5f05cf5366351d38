"""Driver of the PPO training cells: ``training/ppo.py::train_iteration``
repeated on one learner, its env state and its level pool.

Set-up builds the learner (the policy with the benchmark's weights, Adam,
``PPOConfig`` of the configuration), the pool of the configuration's
levels and ``lanes`` lanes, and drives them through ``checked`` iterations
of the window's own call: these warm up every shape, and the harness keeps
what they produced. Their permutations come from the seed (``perms=``);
the actions are the policy's own draws, the coins' seed words and the
reset picks the run's, all kept. The same learner then trains through the
window.

After the window the plain reference (``perfbench/reference``) replays
those iterations from the same weights and levels, with the kept actions,
seed words and reset picks, and the numbers below are compared:

* ``env_mismatches``: elements of every checked step's views, boards,
  agent locations, dones and live-agent masks, and of each iteration's
  end state, that differ (exact);
* ``reward_max_abs``: the largest gap of a shaped reward;
* ``policy_rel``: the first iteration's values and taken actions'
  probabilities, gap norm over reference norm, the larger;
* ``gae_rel``: the same of its returns and advantages;
* ``loss_rel``: the losses of the first ``adam_steps`` minibatches, the
  largest relative gap;
* ``grad_leaf``: the first Adam step's gradient (from Adam's first moment
  after it), by the worst leaf: the gap of the leaf's norms over the
  larger of the reference's norm and the median leaf's;
* ``update_median``: the parameters' change over the first
  ``adam_steps`` Adam steps, the gap of norms as ``grad_leaf`` by the
  median leaf; leaves whose first gradient in the reference is under a
  thousandth of the median leaf's are left out.

The learner's numbers stop at the first Adam steps, and the change is
taken by the median leaf: a sample whose clip or sign branch flips on a
rounding difference moves the parameters by a step of Adam's, and sound
runs read the change after all checked iterations, by the worst leaf,
from 1e-7 to 1e-3 by seed (PERF.md).
"""

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from perfbench import capture, compare, peaks, program
from perfbench.reference import env as R, policy as RP


def _iteration(run, perms=None):
    p = run["p"]
    c = run["ctx"].cfg
    run["state"], run["ws"], run["obs"], metrics = p.ppo.train_iteration(
        run["env_cfg"], run["wcfg"], run["ppo_cfg"], run["pool"],
        run["state"], run["ws"], run["obs"], run["gen"],
        c["se_penalty_coef"], c["min_perf_fraction"], perms=perms,
        device=run["ctx"].device)
    return metrics


def setup(ctx):
    p, cfg, wl, dev = ctx.port, ctx.cfg, ctx.wl, ctx.device
    view = tuple(cfg["view_shape"])
    weights = program.policy_weights(cfg["policy"], view,
                                     ctx.seed_for("weights"), dev)
    model = program.policy(p, cfg, weights, dev, "tensorfloat32"
                           if ctx.control else cfg["policy"]["precision"])
    pool = p.state.pack_levels(
        p.levels.load_levels(program.levels_path(ctx.root, cfg)), device=dev)
    ppo_cfg = p.ppo.PPOConfig(**cfg["ppo"])
    ctx.phase("weights, policy and pool")
    run = dict(
        ctx=ctx, p=p, pool=pool, ppo_cfg=ppo_cfg,
        env_cfg=program.env_config(p, cfg),
        wcfg=program.wrapper_config(p, cfg),
        state=p.ppo.init_ppo_state(ppo_cfg, model, device=dev),
        gen=torch.Generator(device=dev).manual_seed(
            ctx.seed_for("generator")),
        weights={k: v.to("cpu", copy=True) for k, v in weights.items()})
    run["ws"], run["obs"] = p.wrappers.reset(
        run["env_cfg"], run["wcfg"], pool, wl["lanes"],
        min_perf_fraction=cfg["min_perf_fraction"], device=dev)

    n = ppo_cfg.steps_per_env * wl["lanes"] * pool.num_agents
    rng = ctx.rng("perms")
    run["perms"] = [np.stack([rng.permutation(n) for _ in range(
        ppo_cfg.epochs_per_batch)]) for _ in range(wl["checked"])]
    kept = run["kept"] = dict(words=[], picks=[], steps=[], rollouts=[],
                              gae=[], losses=[], ends=[])
    names = dict(model.named_parameters())
    adam = wl["adam_steps"]

    def adam_step(opt, args, kwargs):
        kept["adam"] = kept.get("adam", 0) + 1
        if kept["adam"] == 1:
            kept["grad1"] = {k: program.host(opt.state[v]["exp_avg"])
                             / (1 - opt.defaults["betas"][0])
                             for k, v in names.items()}
        if kept["adam"] == adam:
            kept["params"] = {k: program.host(v) for k, v in names.items()}

    def loss(args, kwargs, out):
        if len(kept["losses"]) < adam:
            kept["losses"].append(float(out[0].detach()))

    with contextlib.ExitStack() as stack:
        stack.enter_context(capture.after(
            p.env, "seed_words",
            lambda a, k, out: kept["words"].append(program.host(out))))
        stack.enter_context(capture.after(
            p.env, "reset_picks",
            lambda a, k, out: kept["picks"].append(program.host(out))))
        stack.enter_context(capture.after(
            p.wrappers, "step", lambda a, k, out: kept["steps"].append(
                program.host((out[0].env.board, out[0].env.agent_locs)))))
        stack.enter_context(capture.after(
            p.ppo, "rollout", lambda a, k, out: kept["rollouts"].append(
                program.host({key: out[0][key] for key in (
                    "obs", "actions", "action_prob", "rewards", "values",
                    "done", "weight")}))))
        stack.enter_context(capture.after(
            p.ppo, "compute_gae",
            lambda a, k, out: kept["gae"].append(program.host(out))))
        stack.enter_context(capture.after(p.ppo, "calculate_loss", loss))
        hook = run["state"].optimizer.register_step_post_hook(adam_step)
        stack.callback(hook.remove)
        for i in range(wl["checked"]):
            _iteration(run, torch.as_tensor(run["perms"][i], device=dev))
            kept["ends"].append(program.host(run["ws"]))
            ctx.phase("checked iteration %d" % (i + 1))
    return run


def window(run, seconds):
    ctx = run["ctx"]
    ctx.sync()
    n, t0 = 0, time.perf_counter()
    while True:
        _iteration(run)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    ctx.sync()
    elapsed = time.perf_counter() - t0
    lanes, steps = ctx.wl["lanes"], run["ppo_cfg"].steps_per_env
    return {"attempted": n, "seconds": elapsed, "iterations": n,
            "env_steps": n * steps * lanes,
            "flops_per_iteration": flops(run)}


def flops(run):
    """Model FLOPs of one iteration (``peaks.ppo_iteration_flops``)."""
    lanes, steps = run["ctx"].wl["lanes"], run["ppo_cfg"].steps_per_env
    agents = run["pool"].num_agents
    return peaks.ppo_iteration_flops(
        run["ctx"].cfg["policy"], tuple(run["ctx"].cfg["view_shape"]),
        {"rollout": (steps + 1) * lanes * agents,
         "batch": steps * lanes * agents}, run["ppo_cfg"].epochs_per_batch)


def spans(run):
    p = run["p"]
    return [(p.ppo, "rollout", "ppo.rollout", True),
            (p.ppo, "train_on_batch", "ppo.train_on_batch", True)]


def ranges(run):
    p = run["p"]
    return [(p.ppo, "rollout", "ppo.rollout"),
            (p.ppo, "compute_gae", "ppo.compute_gae"),
            (p.ppo, "train_on_batch", "ppo.train_on_batch"),
            (p.wrappers, "step", "wrappers.step")]


def profiled(run):
    """One iteration, or as many as make 0.25 s."""
    t0 = time.perf_counter()
    while True:
        _iteration(run)
        run["ctx"].sync()
        if time.perf_counter() - t0 >= 0.25:
            break


# ---------------------------------------------------------------------------
# The check


def check(run):
    ctx, kept = run["ctx"], run["kept"]
    for key in ("state", "ws", "obs", "pool", "gen"):
        run.pop(key, None)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    cfg, dev = ctx.cfg, ctx.device
    net = cfg["policy"]
    pcfg = dataclasses.asdict(run["ppo_cfg"])
    wcfg = R.WrapperConfig(**cfg["wrapper"])
    lanes = ctx.wl["lanes"]
    view = tuple(cfg["view_shape"])
    with RP.strict_float32():
        return _replay(run, kept, cfg, dev, net, pcfg, wcfg, lanes, view)


def _replay(run, kept, cfg, dev, net, pcfg, wcfg, lanes, view):
    pool = R.pack(R.read_levels(program.levels_path(run["ctx"].root, cfg)),
                  dev)
    draws = R.Draws(torch.cat(kept["words"]).to(dev),
                    torch.cat(kept["picks"]).to(dev))
    mpf = cfg["min_perf_fraction"]
    ws = R.wrap(wcfg, R.reset(pool, torch.arange(lanes, device=dev)
                              % pool.num_levels, mpf))
    params = {k: v.to(dev) for k, v in run["weights"].items()}
    diff = compare.mismatches
    mism, rew = 0, 0.0
    T = pcfg["steps_per_env"]
    traj = {k: [] for k in ("obs", "actions", "action_prob", "rewards",
                            "values", "done", "weight")}
    for it, roll in enumerate(kept["rollouts"]):
        for t in range(T):
            s = ws.env
            obs = R.views(pool, s, view)
            b, a = obs.shape[:2]
            flat = obs.reshape((b * a,) + view)
            mism += diff(roll["obs"][t], flat)
            act = roll["actions"][t].to(dev)
            weight = (s.is_active & pool.agent_mask[s.level_idx]).reshape(
                -1).to(torch.float32)
            ws, reward, done, _ = R.wrapped_step(
                pool, wcfg, ws, act.reshape(b, a), draws, cfg["time_limit"],
                cfg["se_penalty_coef"], mpf)
            board, locs = kept["steps"][it * T + t]
            mism += diff(board, ws.env.board) + diff(locs, ws.env.agent_locs)
            mism += diff(roll["done"][t], done.reshape(-1))
            mism += diff(roll["weight"][t], weight)
            rew = max(rew, float((roll["rewards"][t].to(dev)
                                  - reward.reshape(-1)).abs().max()))
            if it:
                continue
            values, probs = RP.forward(net, params, flat)
            for k, v in (("obs", flat), ("actions", act),
                         ("action_prob", probs.gather(-1, act[:, None])[:, 0]),
                         ("rewards", reward.reshape(-1)), ("values", values),
                         ("done", done.reshape(-1)), ("weight", weight)):
                traj[k].append(v)
        end = kept["ends"][it]
        for k in ("board", "goals", "agent_locs", "num_steps", "old_value",
                  "episode_reward", "episode_length", "is_active",
                  "level_idx"):
            mism += diff(end["env"][k], getattr(ws.env, k))
        mism += diff(end["last_side_effect"], ws.last_se)
        mism += diff(end["prior_positions"], ws.ring)
        mism += diff(end["prior_count"], ws.count)
        if it:
            continue
        traj = {k: torch.stack(v) for k, v in traj.items()}
        final_values, _ = RP.forward(
            net, params, R.views(pool, ws.env, view).reshape((-1,) + view))
        ret, adv = RP.gae(pcfg, traj["rewards"], traj["values"], traj["done"],
                          final_values)
        batch = {k: traj[k].reshape((-1,) + tuple(traj[k].shape[2:]))
                 for k in ("obs", "actions", "action_prob", "values",
                           "weight")}
        batch["returns"] = ret.reshape(-1)
        batch["advantages"] = adv.reshape(-1)
        policy_rel = max(
            compare.rel(roll["values"], traj["values"]),
            compare.rel(roll["action_prob"], traj["action_prob"]))
        gae_rel = max(compare.rel(kept["gae"][0][0], ret),
                      compare.rel(kept["gae"][0][1], adv))
        record = {}
        steps = run["ctx"].wl["adam_steps"]
        early = RP.update(pcfg, net, params,
                          RP.Adam(params, pcfg["learning_rate"]), batch,
                          torch.as_tensor(run["perms"][0], device=dev),
                          steps, record)

    grad1 = record["grad1"]
    med = float(np.median([compare.norm(g) for g in grad1.values()]))
    moved = [k for k, g in grad1.items() if compare.norm(g) >= 1e-3 * med]
    init = run["weights"]
    ref_early = {k: early[k].cpu() - init[k] for k in init}
    # Where the program took fewer Adam steps than that, it has no
    # parameters or gradient to compare: the check fails.
    missing = float("inf")
    return {
        "env_mismatches": mism,
        "reward_max_abs": rew,
        "policy_rel": policy_rel,
        "gae_rel": gae_rel,
        "loss_rel": (max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
            kept["losses"], record["losses"]))
            if len(kept["losses"]) == steps else missing),
        "grad_leaf": (max(compare.leaf_gaps(kept["grad1"], grad1))
                      if "grad1" in kept else missing),
        "update_median": (float(np.median(compare.leaf_gaps(
            {k: kept["params"][k] - init[k] for k in init}, ref_early,
            moved))) if "params" in kept else missing),
    }


# ---------------------------------------------------------------------------
# Faults planted in the program (the check has to read them as wrong)


@contextlib.contextmanager
def _unchanged(ctx):
    """The update returns the learner unchanged."""
    with capture.patched(ctx.port.ppo, "train_on_batch",
                         lambda orig: lambda cfg, state, *a, **k: state):
        yield


@contextlib.contextmanager
def _half_batch(ctx):
    """Each minibatch's loss leaves out its second half and takes the mean
    over the rest."""
    def make(orig):
        def loss(*args, **kwargs):
            args = list(args)
            weight = args[8] if len(args) > 8 else kwargs.get("weight")
            weight = weight.clone()
            weight[weight.shape[0] // 2:] = 0
            if len(args) > 8:
                args[8] = weight
            else:
                kwargs["weight"] = weight
            return orig(*args, **kwargs)
        return loss
    with capture.patched(ctx.port.ppo, "calculate_loss", make):
        yield


@contextlib.contextmanager
def _token(ctx):
    """One reward of each rollout altered where it is produced."""
    def alter(args, kwargs, out):
        out[0]["rewards"][out[0]["rewards"].shape[0] // 2, 0] += 1.0
    with capture.after(ctx.port.ppo, "rollout", alter):
        yield


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "token": _token}
