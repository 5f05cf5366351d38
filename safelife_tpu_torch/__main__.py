"""Command-line interface: ``python -m safelife_tpu_torch <command>``.

Port of ``safelife_tpu/__main__.py``: ``main`` (``:35-121``) with the
verbs

* ``train``  — PPO or DQN training on a task (``--algo ppo|dqn``).
* ``print``  — generate or load levels and print them to the terminal.
* ``play``   — the interactive terminal (``--gl``: pygame) game.
* ``new``    — generate levels and save them to disk.
* ``render`` — render level files to png/gif/mp4.
* ``bench``  — the headline env-steps/s benchmark (:mod:`.bench`, the
  port of the root ``bench.py``, which JAX's verb runs, ``:99``,
  ``:117-121``).

``train``, ``play`` and ``bench`` take ``--device`` (``cuda`` unless
``cpu`` is asked for); ``_confirm_data_dir`` (``:124-159``), ``cmd_train``
(``:162-265``), ``_iter_levels``, ``cmd_print``, ``cmd_new`` and
``cmd_render`` (``:268-312``). Not ported: ``--wandb`` (ROADMAP.md).

Multi-process training replaces JAX's ``scripts/launch_multihost.py``
with ``torchrun``: ``torchrun --nproc-per-node N -m safelife_tpu_torch
train DIR ...`` runs N ranks, one card each (``cuda:LOCAL_RANK``; the CPU
with ``--device cpu``), ``--batch`` being the global lane count.
"""

import argparse
import json
import logging
import os
import sys
import types

from . import bench


def main(argv=None):
    """Parse ``argv`` and run the verb. Returns what the verb returns
    (``train``: the run's namespace; ``bench``: the results by mode; the
    others: None)."""
    parser = argparse.ArgumentParser(prog="safelife_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train", help="train an agent")
    p_train.add_argument("data_dir", nargs="?", default=None,
                         help="directory for logs/checkpoints")
    p_train.add_argument("--algo", choices=("ppo", "dqn"), default="ppo")
    p_train.add_argument("-e", "--env-type", default="append-still")
    p_train.add_argument("--steps", type=float, default=6e6)
    p_train.add_argument("--batch", type=int, default=64)
    p_train.add_argument("--seed", type=int, default=None)
    p_train.add_argument("--benchmark-episodes", type=int, default=1000)
    p_train.add_argument("--skip-benchmark", action="store_true")
    p_train.add_argument("-x", "--extra-params", default=None, help=(
        "JSON dict of config overrides, e.g. "
        "'{\"ppo.gamma\": 0.99, \"side_effect.penalty\": 0.5}'"))
    p_train.add_argument("--run-type", default="train",
                         choices=("train", "benchmark", "inspect"),
                         help="'benchmark' evaluates the latest checkpoint "
                              "in data_dir without training; 'inspect' "
                              "builds the environments and drops into an "
                              "interactive shell")
    p_train.add_argument("--port", type=int, default=None,
                         help="launch tensorboard on this port")
    p_train.add_argument("--device", choices=("cuda", "cpu"),
                         default="cuda",
                         help="where the environment and the learner run "
                              "(default: the CUDA card)")

    p_print = sub.add_parser("print", help="print levels to the terminal")
    p_print.add_argument("paths", nargs="+")
    p_print.add_argument("--seed", type=int, default=None)
    p_print.add_argument("-n", "--num", type=int, default=1)

    p_play = sub.add_parser("play", help="interactive terminal game")
    p_play.add_argument("paths", nargs="*", default=["random/append-still"])
    p_play.add_argument("--seed", type=int, default=None)
    p_play.add_argument("--centered", action="store_true")
    p_play.add_argument("--record", default=None, metavar="DIR",
                        help="save play history as rec-NNN.npz files "
                             "under DIR")
    p_play.add_argument("--gl", action="store_true",
                        help="graphical window (pygame) instead of the "
                             "terminal renderer")
    p_play.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="where the end-of-level side effects are "
                             "scored (default: the CUDA card)")

    p_new = sub.add_parser("new", help="generate and save levels")
    p_new.add_argument("param_file")
    p_new.add_argument("out", help="output file or directory")
    p_new.add_argument("-n", "--num", type=int, default=1)
    p_new.add_argument("--seed", type=int, default=None)
    p_new.add_argument("--archive", action="store_true",
                       help="pack all levels into one npz archive")

    p_render = sub.add_parser("render", help="render levels to images/video")
    p_render.add_argument("paths", nargs="+")
    p_render.add_argument("--steps", type=int, default=0,
                          help="evolve the board and render a movie")
    p_render.add_argument("--fmt", default=None,
                          choices=(None, "png", "gif", "mp4"))

    bench.add_arguments(sub.add_parser(
        "bench", help="headline env-steps/s on append-still (4096 lanes)"))

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")

    if args.cmd == "train":
        return cmd_train(args)
    if args.cmd == "print":
        return cmd_print(args)
    if args.cmd == "play":
        from .interactive import play_cmd
        return play_cmd(args)
    if args.cmd == "new":
        return cmd_new(args)
    if args.cmd == "bench":
        return bench.run(args)
    return cmd_render(args)


def _confirm_data_dir(data_dir):
    """Ask before reusing an existing training directory.

    Parity: start-training.py:126-140 — overwrite / append / abort, with
    ``tmp*``-named directories overwritten without asking. Runs without a
    tty (schedulers, tests) append: checkpoints resume and logs
    accumulate.
    """
    import shutil

    data_dir = os.path.realpath(data_dir)
    if not os.path.exists(data_dir):
        return
    if os.path.basename(data_dir).startswith("tmp"):
        response = "overwrite"
    elif not sys.stdin.isatty():
        # Before setup_logging configures handlers, so not a logger call.
        print("'%s' already exists; appending to it (no tty to ask)"
              % data_dir, file=sys.stderr)
        return
    else:
        print("The directory '%s' already exists." % data_dir)
        response = None
        while response not in ("overwrite", "append", "abort"):
            try:
                response = input("(overwrite / append / abort) > ").strip()
            except EOFError:  # stdin closed at the prompt
                response = "abort"
    if response == "overwrite":
        print("Overwriting old data.")
        shutil.rmtree(data_dir)
    elif response == "abort":
        print("Aborting.")
        sys.exit(0)


def cmd_train(args):
    """Train (or benchmark, or inspect) on ``args.device``. Returns a
    namespace of the run's ``bundle``, the ``model``, the learner's
    ``state`` (PPO's or DQN's; None unless trained) and the final
    benchmark's ``summary`` (None when skipped).

    Under ``torchrun`` every rank joins the process group first (``nccl``
    on the card, ``gloo`` on the CPU); rank 0 alone confirms or creates
    the data directory, writes the logs and runs the final benchmark, and
    the other ranks wait for it (JAX's ``__main__.py:165-190``)."""
    import torch

    from .parallel import mesh as M
    from .utils.device import resolve_device

    dev = resolve_device(args.device)
    joined = not torch.distributed.is_initialized()
    rank, world = M.initialize_distributed(device=dev)
    joined = joined and torch.distributed.is_initialized()
    try:
        if dev.index is not None:  # a rank's own card
            torch.cuda.set_device(dev)
        return _train_ranked(args, dev, rank, world)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train_ranked(args, dev, rank, world):
    import torch

    from .parallel import mesh as M
    from .training import train as T
    from .training.env_factory import build_environments
    from .training.global_config import config
    from .training.logging_setup import setup_logging

    if args.data_dir and args.run_type == "train" and rank == 0:
        _confirm_data_dir(args.data_dir)
    M.barrier()

    setup_logging(args.data_dir if rank == 0 else None,
                  rank=rank if world > 1 else None)
    if torch.distributed.is_initialized():
        logging.getLogger("safelife_tpu_torch.cli").info(
            "rank %d of %d, backend %s, device %s", rank, world,
            torch.distributed.get_backend(), dev)
    if args.extra_params:
        config.update(json.loads(args.extra_params))
    config["env_type"] = args.env_type
    config["run_type"] = args.run_type
    config.setdefault("run_type", args.run_type)  # mark as consumed
    if args.seed is not None:
        config["seed"] = args.seed

    tb_proc = None
    if args.port and args.data_dir:
        import subprocess
        try:
            tb_proc = subprocess.Popen(
                ["tensorboard", "--logdir", args.data_dir,
                 "--port", str(args.port)],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        except OSError as exc:
            logging.getLogger(__name__).warning(
                "could not launch tensorboard (%s); continuing without it",
                exc)

    bundle = None
    try:
        # The training logger writes rank 0's files only.
        bundle = build_environments(
            config, data_dir=args.data_dir if rank == 0 else None,
            num_envs=args.batch, device=dev)
        out = types.SimpleNamespace(bundle=bundle, model=None, state=None,
                                    summary=None)
        if args.run_type == "inspect":
            # Parity: start-training.py:282-285 — envs and config built,
            # then an interactive shell.
            ns = {"bundle": bundle, "config": config, "torch": torch,
                  "T": T}
            try:
                from IPython import embed
                embed(user_ns=ns)
            except ImportError:
                import code
                code.interact(
                    banner="safelife_tpu_torch inspect shell: bundle, "
                           "config, torch, T", local=ns)
            return out
        if args.run_type == "benchmark":
            out.model = T.load_for_eval(args.algo, bundle, args.data_dir,
                                        device=dev)
        else:
            train = T.train_ppo if args.algo == "ppo" else T.train_dqn
            out.model, out.state = train(
                bundle, total_steps=args.steps, batch_size=args.batch,
                seed=args.seed or 0, data_dir=args.data_dir, device=dev)
        if not args.skip_benchmark and (bundle.benchmark_levels
                                        or bundle.validation_levels):
            if rank == 0:
                out.summary = T.run_benchmark(
                    out.model, bundle, args.data_dir,
                    torch.Generator(device=dev).manual_seed(args.seed or 0),
                    num_episodes=args.benchmark_episodes, device=dev)
            M.barrier()
        config.check_for_unused()
        return out
    finally:
        if tb_proc is not None:
            tb_proc.terminate()
        if bundle is not None:
            bundle.pool_manager.close()  # the procgen workers


def _iter_levels(paths, seed, num):
    from .io.iterator import SafeLifeLevelIterator

    it = SafeLifeLevelIterator(*paths, seed=seed)
    for _ in range(num):
        try:
            yield next(it)
        except StopIteration:
            return


def cmd_print(args):
    from .render.text import render_board

    for lv in _iter_levels(args.paths, args.seed, args.num):
        print("#", lv.name)
        sys.stdout.write(render_board(lv.board, lv.goals))
        print()


def cmd_new(args):
    from .io.levels import save_archive, save_level

    levels = list(_iter_levels([args.param_file], args.seed, args.num))
    if args.archive or args.out.endswith(".npz") and args.num > 1:
        save_archive(levels, args.out)
        print("wrote %d levels to %s" % (len(levels), args.out))
    elif args.num == 1:
        save_level(levels[0], args.out)
        print("wrote %s" % args.out)
    else:
        os.makedirs(args.out, exist_ok=True)
        for i, lv in enumerate(levels):
            save_level(lv, os.path.join(args.out, "level-%03d.npz" % i))
        print("wrote %d levels to %s/" % (len(levels), args.out))


def cmd_render(args):
    from .render.graphics import render_file

    for path in args.paths:
        out = render_file(path, steps=args.steps, movie_format=args.fmt)
        print("rendered", out)


if __name__ == "__main__":
    main()
