"""Driver of the DQN training cells: ``training/dqn.py::collect_and_optimize``
repeated on one learner, its replay, its env state and its level pool, a
unit as ``training/train.py::train_dqn`` runs it (``optimize_interval //
num_envs`` steps of every lane, then one Adam step once the replay is
warm).

Set-up builds the Q network with the benchmark's weights, its target,
Adam, the replay of ``replay_size`` entries and the n-step rings on the
device, the pool of the configuration's levels and ``num_envs`` lanes. It
runs units until the replay holds ``replay_initial`` entries, then warm
units until the second of the ``checked`` units that follow crosses a
target sync, then the checked units, through the same functions as the
window: every shape is warm before the window. While the replay fills,
the unit after the replay first holds each of ``fill_checked`` sizes
drawn from the seed below ``replay_initial`` is a fill unit: its steps,
rings and push are kept as a checked unit's are (it takes no Adam
step). The checked units' sample indices come from the seed
(``sample_idx=``, as the training cells' permutations do); the actions
are the program's ε-greedy draws, the coins' seed words and the reset
picks the run's, all kept, with the state before the first checked (or
fill) unit and what each unit produced.

After the window the plain reference (``perfbench/reference``) replays the
fill units and the checked units, each from its own kept state, with the
kept draws, and the numbers below are compared:

* ``env_mismatches``: elements of every checked or fill step's views,
  boards, agent locations and dones that differ (exact);
* ``ring_mismatches``: elements of the n-step rings after each unit and
  of each step's candidates (actions, dones, validity) (exact);
* ``push_mismatches``: elements of every pushed row (view, next view,
  action, done) and of its slot, and of the replay's count (exact);
* ``target_mismatches``: elements of the target network's parameters
  after the checked units that differ from the online network's after
  the unit whose steps crossed the last sync (exact);
* ``reward_max_abs``: the largest gap of a shaped reward, of a ring's or
  a candidate's discounted reward and of a pushed row's (each is one
  float64 sum rounded once on both sides, so exact);
* ``q_rel``: the batch's Q-values, gap norm over the reference's norm, the
  largest over the checked units;
* ``loss_rel``: the TD losses of the checked units, the largest relative
  gap;
* ``grad_leaf``: the first checked Adam step's gradient by the worst leaf:
  the gap of the leaf's norms over the larger of the reference's norm and
  the median leaf's;
* ``update_median``: the parameters' change over the checked units, the
  gap of norms as ``grad_leaf`` by the median leaf; leaves whose first
  gradient in the reference is under a thousandth of the median leaf's
  are left out.

The reference's batches are the program's replay rows at the sampled
indices as they were when sampled, each row that a checked unit pushed
replaced by the reference's own; the fill units hold a sample of the
pushes that wrote the other rows.
"""

import contextlib
import gc
import importlib
import time

import numpy as np
import torch

from perfbench import capture, compare, program, qnetwork
from perfbench.reference import dqn as RD, env as R, policy as RP

#: Seconds of units in a profiled call.
PROFILE_S = 0.25
_ROW_FIELDS = ("obs", "action", "reward", "next_obs", "done")


def _dqn():
    """The port's DQN module (``program.port`` checked the package)."""
    return importlib.import_module(program.PACKAGE + ".training.dqn")


def _unit(run):
    run["dstate"], run["ws"], run["obs"], _ = run["dqn"].collect_and_optimize(
        run["env_cfg"], run["wcfg"], run["dqn_cfg"], run["pool"],
        run["dstate"], run["ws"], run["obs"], run["gen"], run["steps"],
        device=run["ctx"].device)


def _config(dqn, cfg):
    return dqn.DQNConfig(
        gamma=cfg["gamma"], multi_step=cfg["multi_step"],
        batch_size=cfg["batch_size"],
        optimize_interval=cfg["optimize_interval"],
        learning_rate=cfg["learning_rate"],
        epsilon_points=tuple(tuple(p) for p in cfg["epsilon_points"]),
        replay_initial=cfg["replay_initial"], replay_size=cfg["replay_size"],
        target_update_interval=cfg["target_update_interval"])


def setup(ctx):
    p, cfg, wl, dev = ctx.port, ctx.cfg, ctx.wl, ctx.device
    dqn = _dqn()
    view = tuple(cfg["view_shape"])
    params = qnetwork.weights(cfg["q_network"], view,
                              ctx.seed_for("weights"), dev)
    model = qnetwork.model(p.nets, cfg, params, dev, "tensorfloat32"
                           if ctx.control else cfg["q_network"]["precision"])
    pool = p.state.pack_levels(
        p.levels.load_levels(program.levels_path(ctx.root, cfg)), device=dev)
    dqn_cfg = _config(dqn, cfg)
    lanes = cfg["num_envs"]
    env_cfg = program.env_config(p, cfg)
    wcfg = program.wrapper_config(p, cfg)
    ws, obs = p.wrappers.reset(env_cfg, wcfg, pool, lanes,
                               min_perf_fraction=cfg["min_perf_fraction"],
                               device=dev)
    dstate = dqn.init_dqn_state(dqn_cfg, model, lanes * pool.num_agents,
                                tuple(obs.shape[2:]), obs.dtype, device=dev)
    run = dict(
        ctx=ctx, p=p, dqn=dqn, pool=pool, dqn_cfg=dqn_cfg, env_cfg=env_cfg,
        wcfg=wcfg, ws=ws, obs=obs, dstate=dstate,
        steps=max(dqn_cfg.optimize_interval // lanes, 1),
        gen=torch.Generator(device=dev).manual_seed(
            ctx.seed_for("generator")))
    run["unit_steps"] = run["steps"] * lanes
    ctx.phase("weights, Q network, pool and replay")

    fill = sorted(int(x) for x in ctx.rng("fill").integers(
        0, dqn_cfg.replay_initial, wl["fill_checked"]))
    run["fills"] = []
    while dstate.replay.size() < dqn_cfg.replay_initial:
        size = dstate.replay.size()
        if fill and size >= fill[0]:
            fill = [f for f in fill if f > size]
            run["fills"].append(_checked(run, 1, learner=False))
        else:
            _unit(run)
    ctx.phase("replay filled to replay_initial")
    # Warm units until the second checked unit's steps cross a sync.
    every, u = dqn_cfg.target_update_interval, run["unit_steps"]
    ahead = 2
    while not RD.syncs(dstate.num_steps + ahead * u, u, every):
        ahead += 1
    for _ in range(ahead - 2):
        _unit(run)
    ctx.phase("warm units")
    run["kept"] = _checked(run, wl["checked"])
    ctx.phase("checked units")
    return run


def _checked(run, units, learner=True):
    """Run ``units`` units keeping what the check needs (without
    ``learner``, only their steps, rings and pushes)."""
    ctx, p, dqn, dstate = run["ctx"], run["p"], run["dqn"], run["dstate"]
    model, opt = dstate.model, dstate.optimizer
    names = dict(model.named_parameters())
    kept = dict(
        words=[], picks=[], actions=[], steps=[], rings=[], cands=[],
        pushed=[], samples=[], batches=[], losses=[], q=[], params=[],
        start=dict(ws=program.host(run["ws"]), obs=program.host(run["obs"]),
                   traj=program.host(dstate.traj),
                   idx=dstate.replay.idx, num_steps=dstate.num_steps))
    if learner:
        kept["start"].update(
            params=program.host(dict(names)),
            target=program.host(dict(
                dstate.target_model.named_parameters())),
            adam={k: _adam_state(opt, v) for k, v in names.items()})
    rng = ctx.rng("samples")

    def pushed(orig):
        def call(buf, emissions):
            idx0 = buf.idx
            out = orig(buf, emissions)
            count = out.idx - idx0
            first = max(count - out.capacity, 0)
            slots = (idx0 + torch.arange(first, count, device=out.obs.device)
                     ) % out.capacity
            kept["pushed"].append(dict(
                idx=out.idx, slots=program.host(slots),
                rows={k: program.host(getattr(out, k).index_select(0, slots))
                      for k in _ROW_FIELDS}))
            return out
        return call

    def optimize(orig):
        def call(cfg, ds, generator, n_env_steps, sample_idx=None):
            idx = torch.as_tensor(rng.integers(
                0, max(ds.replay.size(), 1), cfg.batch_size),
                device=ds.replay.obs.device)
            kept["samples"].append(program.host(idx))
            kept["batches"].append({
                k: program.host(getattr(ds.replay, k).index_select(0, idx))
                for k in _ROW_FIELDS})
            return orig(cfg, ds, generator, n_env_steps, sample_idx=idx)
        return call

    def loss(orig):
        def call(cfg, net, target, batch):
            hook = net.register_forward_hook(
                lambda m, a, out: kept["q"].append(program.host(out)))
            try:
                out = orig(cfg, net, target, batch)
            finally:
                hook.remove()
            kept["losses"].append(float(out[0].detach()))
            return out
        return call

    def grads(o, args, kwargs):
        if "grad1" not in kept:
            kept["grad1"] = {k: program.host(v.grad)
                             for k, v in names.items()}

    def stepped(o, args, kwargs):
        kept["params"].append({k: program.host(v) for k, v in names.items()})

    with contextlib.ExitStack() as stack:
        stack.enter_context(capture.after(
            p.env, "seed_words",
            lambda a, k, out: kept["words"].append(program.host(out))))
        stack.enter_context(capture.after(
            p.env, "reset_picks",
            lambda a, k, out: kept["picks"].append(program.host(out))))
        stack.enter_context(capture.after(
            dqn, "act_epsilon_greedy",
            lambda a, k, out: kept["actions"].append(program.host(out))))
        stack.enter_context(capture.after(
            p.wrappers, "step", lambda a, k, out: kept["steps"].append(
                program.host((out[0].env.board, out[0].env.agent_locs,
                              out[1], out[2], out[3])))))
        stack.enter_context(capture.after(
            dqn, "step_trajectories",
            lambda a, k, out: kept["cands"].append(program.host(
                {key: out[1][key] for key in ("action", "reward", "done",
                                               "valid")}))))
        stack.enter_context(capture.patched(dqn, "push_emissions", pushed))
        if learner:
            stack.enter_context(capture.patched(dqn, "optimize", optimize))
            stack.enter_context(capture.patched(dqn, "td_loss", loss))
            for hook in (opt.register_step_pre_hook(grads),
                         opt.register_step_post_hook(stepped)):
                stack.callback(hook.remove)
        for _ in range(units):
            _unit(run)
            kept["rings"].append(program.host(run["dstate"].traj))
    if learner:
        kept["target"] = program.host(dict(
            run["dstate"].target_model.named_parameters()))
    return kept


def _adam_state(opt, param):
    """Adam's moments and step count of ``param``, on the host (zeros
    before its first step)."""
    st = opt.state.get(param, {})
    zero = torch.zeros_like(param)
    return {"m": program.host(st.get("exp_avg", zero)),
            "v": program.host(st.get("exp_avg_sq", zero)),
            "t": int(st.get("step", 0))}


def window(run, seconds):
    ctx, dqn = run["ctx"], run["dqn"]
    # A port older than the replay counters has none: the work leaves them
    # out.
    counts = getattr(dqn, "replay_counts", None)
    if counts is not None:
        dqn.reset_replay_counts()
    ctx.sync()
    n, t0 = 0, time.perf_counter()
    while True:
        _unit(run)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    ctx.sync()
    elapsed = time.perf_counter() - t0
    work = {"attempted": n, "seconds": elapsed, "iterations": n,
            "env_steps": n * run["unit_steps"],
            "flops_per_iteration": flops(run)}
    if counts is not None:
        work.update({"rows_" + k: v for k, v in counts().items()})
    return work


def flops(run):
    """Model FLOPs of one unit (``qnetwork.unit_flops``)."""
    cfg = run["ctx"].cfg
    return qnetwork.unit_flops(
        cfg["q_network"], tuple(cfg["view_shape"]),
        run["unit_steps"] * run["pool"].num_agents, cfg["batch_size"])


def spans(run):
    return []


def ranged(run):
    """The unit's layers as ranges that wait for the device."""
    dqn = run["dqn"]
    return [(dqn, "collect", "dqn.collect"),
            (dqn, "push_emissions", "dqn.push"),
            (dqn, "optimize", "dqn.optimize")]


def profiled(run):
    """Units for ``PROFILE_S`` seconds, then a wait for the device."""
    t0 = time.perf_counter()
    while True:
        _unit(run)
        if time.perf_counter() - t0 >= PROFILE_S:
            break
    run["ctx"].sync()


# ---------------------------------------------------------------------------
# The check


def check(run):
    ctx = run["ctx"]
    for key in ("dstate", "ws", "obs", "pool", "gen"):
        run.pop(key, None)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    with RP.strict_float32():
        return _replay(ctx, run["fills"], run["kept"], run["unit_steps"])


def _rel(prog, ref):
    """``compare.rel``, or infinite where the shapes differ."""
    if tuple(prog.shape) != tuple(ref.shape):
        return float("inf")
    return compare.rel(prog, ref)


def _collect(ctx, pool, kept, gaps):
    """Replay the units that ``kept`` holds (:func:`_checked`) from its
    start: their steps, rings and pushes, adding their mismatches and
    reward gaps to ``gaps``. Yields each unit's (rows, slots, num_steps)
    after its push."""
    cfg, dev = ctx.cfg, ctx.device
    view = tuple(cfg["view_shape"])
    gamma, cap = cfg["gamma"], cfg["replay_size"]
    wcfg = R.WrapperConfig(**cfg["wrapper"])
    draws = R.Draws(
        torch.cat(kept["words"]).to(dev) if kept["words"] else None,
        torch.cat(kept["picks"]).to(dev) if kept["picks"] else None)
    diff = compare.mismatches

    def dev_(x):
        return {k: v.to(dev) for k, v in x.items()}

    def reward(prog, ref):
        gaps["reward"] = max(gaps["reward"], _max_abs(prog, ref))

    start = kept["start"]
    sw = start["ws"]
    ws = R.Wrapped(env=R.State(**dev_(sw["env"])),
                   ring=sw["prior_positions"].to(dev),
                   count=sw["prior_count"].to(dev),
                   last_se=sw["last_side_effect"].to(dev),
                   baseline=sw["baseline_board"].to(dev),
                   start_board=sw["episode_start_board"].to(dev))
    rings = RD.Rings(**dev_(start["traj"]))
    idx, num_steps = start["idx"], start["num_steps"]
    obs = R.views(pool, ws.env, view)
    gaps["env"] += diff(start["obs"], obs)
    steps_per_unit = len(kept["steps"]) // len(kept["rings"])
    for u in range(len(kept["rings"])):
        cands = []
        for t in range(steps_per_unit):
            i = u * steps_per_unit + t
            b, a = obs.shape[:2]
            flat = obs.reshape((b * a,) + view)
            valid = (ws.env.is_active
                     & pool.agent_mask[ws.env.level_idx]).reshape(-1)
            act = kept["actions"][i].to(dev)
            ws, rew, done, _ = R.wrapped_step(
                pool, wcfg, ws, act.reshape(b, a), draws, cfg["time_limit"],
                cfg["se_penalty_coef"], cfg["min_perf_fraction"])
            obs = R.views(pool, ws.env, view)
            board, locs, p_obs, p_rew, p_done = kept["steps"][i]
            gaps["env"] += (diff(board, ws.env.board)
                            + diff(locs, ws.env.agent_locs)
                            + diff(p_obs, obs) + diff(p_done, done))
            reward(p_rew, rew)
            rings, cand = RD.ring_step(
                gamma, rings, flat, act, rew.reshape(-1),
                obs.reshape((b * a,) + view), done.reshape(-1), valid)
            pc = kept["cands"][i]
            gaps["ring"] += sum(diff(pc[k], cand[k])
                                for k in ("action", "done", "valid"))
            reward(pc["reward"], cand["reward"])
            cands.append(cand)
            num_steps += b
        ring = kept["rings"][u]
        gaps["ring"] += sum(diff(ring[k], getattr(rings, k))
                            for k in ("obs", "action", "filled"))
        reward(ring["reward"], rings.reward)
        # The push: the unit's candidates, [T, K, N] in arrival order.
        rows, slots, idx = RD.push(
            {k: torch.cat([c[k] for c in cands]) for k in cand}, idx, cap)
        pk = kept["pushed"][u]
        gaps["push"] += abs(pk["idx"] - idx) + diff(pk["slots"], slots)
        for k in ("obs", "next_obs", "action", "done"):
            gaps["push"] += diff(pk["rows"][k], rows[k].to(
                pk["rows"][k].dtype))
        reward(pk["rows"]["reward"], rows["reward"])
        yield rows, slots, num_steps


def _replay(ctx, fills, kept, unit_steps):
    cfg, dev = ctx.cfg, ctx.device
    net = cfg["q_network"]
    gamma, n = cfg["gamma"], cfg["multi_step"]
    cap, every = cfg["replay_size"], cfg["target_update_interval"]
    pool = R.pack(R.read_levels(program.levels_path(ctx.root, cfg)), dev)
    diff = compare.mismatches
    gaps = {"env": 0, "ring": 0, "push": 0, "reward": 0.0}
    for fill in fills:
        for _ in _collect(ctx, pool, fill, gaps):
            pass

    start = kept["start"]
    params = {k: v.to(dev) for k, v in start["params"].items()}
    target = {k: v.to(dev) for k, v in start["target"].items()}
    adam = RP.Adam(params, cfg["learning_rate"])
    for k, s in start["adam"].items():
        adam.m[k], adam.v[k] = s["m"].to(dev), s["v"].to(dev)
    adam.t = int(next(iter(start["adam"].values()))["t"])
    # The slots each checked unit wrote, and the rows it wrote there.
    written = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    own = {k: [] for k in _ROW_FIELDS}
    n_own = 0
    q_rel = loss_rel = 0.0
    sync_unit = None
    units = _collect(ctx, pool, kept, gaps)
    for u, (rows, slots, num_steps) in enumerate(units):
        written[slots] = n_own + torch.arange(slots.shape[0], device=dev)
        n_own += slots.shape[0]
        for k in _ROW_FIELDS:
            own[k].append(rows[k])
        # The Adam step on the sampled rows.
        sample = kept["samples"][u].to(dev)
        where = written[sample]
        hit = where >= 0
        batch = {}
        for k in _ROW_FIELDS:
            batch[k] = kept["batches"][u][k].to(dev)
            if n_own:
                mine = torch.cat(own[k]).to(batch[k].dtype)
                shape = (-1,) + (1,) * (mine.dim() - 1)
                batch[k] = torch.where(hit.reshape(shape),
                                       mine[where.clamp(min=0)], batch[k])
        loss, q, g = RD.grads(gamma, n, net, params, target, batch)
        if u == 0:
            grad1 = g
        q_rel = max(q_rel, _rel(kept["q"][u], q)
                    if u < len(kept["q"]) else float("inf"))
        loss_rel = max(loss_rel, abs(kept["losses"][u] - loss)
                       / max(abs(loss), 1e-30)
                       if u < len(kept["losses"]) else float("inf"))
        params = adam.step(params, g)
        if RD.syncs(num_steps, unit_steps, every):
            target = {k: v.clone() for k, v in params.items()}
            sync_unit = u

    # The target: the program's own online parameters at the last sync
    # (unchanged where no checked unit crossed one).
    if sync_unit is None:
        at_sync = start["target"]
    elif sync_unit < len(kept["params"]):
        at_sync = kept["params"][sync_unit]
    else:
        at_sync = None
    target_mism = (sum(diff(kept["target"][k], at_sync[k].to(dev))
                       for k in at_sync) if at_sync is not None
                   else float("inf"))
    med = float(np.median([compare.norm(v) for v in grad1.values()]))
    moved = [k for k, v in grad1.items() if compare.norm(v) >= 1e-3 * med]
    init = start["params"]
    missing = float("inf")
    last = kept["params"][-1] if len(kept["params"]) == len(
        kept["rings"]) else None
    return {
        "env_mismatches": gaps["env"],
        "ring_mismatches": gaps["ring"],
        "push_mismatches": gaps["push"],
        "target_mismatches": target_mism,
        "reward_max_abs": gaps["reward"],
        "q_rel": q_rel,
        "loss_rel": loss_rel,
        "grad_leaf": (max(compare.leaf_gaps(kept["grad1"], grad1))
                      if "grad1" in kept else missing),
        "update_median": (float(np.median(compare.leaf_gaps(
            {k: last[k] - init[k] for k in init},
            {k: params[k].cpu() - init[k] for k in init}, moved)))
            if last is not None else missing),
    }


def _max_abs(prog, ref):
    prog = torch.as_tensor(prog).to(ref.device)
    if prog.shape != ref.shape:
        return float("inf")
    return float((prog.double() - ref.double()).abs().max()) \
        if ref.numel() else 0.0


# ---------------------------------------------------------------------------
# Faults planted in the program (the check has to read them as wrong)


@contextlib.contextmanager
def _unchanged(ctx):
    """The learner's Adam step does nothing."""
    def make(orig):
        def build(cfg, model):
            opt = orig(cfg, model)
            opt.step = lambda *args, **kwargs: None
            return opt
        return build
    with capture.patched(_dqn(), "make_optimizer", make):
        yield


@contextlib.contextmanager
def _half_batch(ctx):
    """The TD loss is taken over the first half of each batch."""
    def make(orig):
        def loss(cfg, model, target, batch):
            half = batch["obs"].shape[0] // 2
            return orig(cfg, model, target,
                        {k: v[:half] for k, v in batch.items()})
        return loss
    with capture.patched(_dqn(), "td_loss", make):
        yield


@contextlib.contextmanager
def _push_row(ctx):
    """One word of the view of the last row each push writes altered."""
    def alter(args, kwargs, buf):
        if buf.idx:
            buf.obs[(buf.idx - 1) % buf.capacity].view(-1)[0] ^= 1
    with capture.after(_dqn(), "push_emissions", alter):
        yield


@contextlib.contextmanager
def _push_reward(ctx):
    """The reward of the last row each push writes moved to the next
    float32 up: the least change a stored reward can take."""
    def alter(args, kwargs, buf):
        if buf.idx:
            r = buf.reward[(buf.idx - 1) % buf.capacity]
            r.copy_(torch.nextafter(r, torch.full_like(r, float("inf"))))
    with capture.after(_dqn(), "push_emissions", alter):
        yield


@contextlib.contextmanager
def _stale_target(ctx):
    """The target network never takes the online parameters."""
    def make(orig):
        def call(cfg, dstate, *args, **kwargs):
            kept = {k: v.clone()
                    for k, v in dstate.target_model.state_dict().items()}
            out = orig(cfg, dstate, *args, **kwargs)
            dstate.target_model.load_state_dict(kept)
            return out
        return call
    with capture.patched(_dqn(), "optimize", make):
        yield


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "push_row": _push_row, "push_reward": _push_reward,
          "stale_target": _stale_target}
