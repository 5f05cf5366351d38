"""Level supply: the level iterator, and the training pool it refreshes.

Port of ``safelife_tpu/io/iterator.py``:
``_load_param_file`` (``:28-49``), ``load_files`` (``:52-66``),
``_level_from_data`` (``:69-82``), ``_init_worker`` (``:85-97``),
``SafeLifeLevelIterator`` (``:100-298``, with its ``device_batch`` path
``_fill_queue_batched``, ``:166-222``), and
``LevelPoolManager`` (``__init__`` ``:310-331``, ``close``,
``restore_pool`` ``:370-460``, ``level_meta`` ``:504-538``, ``refresh``
``:540-705``, ``_level_compatible`` ``:707-729``) with ``_swap_rows``
(``:822-833``), and the archive tools ``gen_many``, ``combine_levels``,
``expand_levels``, ``BENCHMARK_TASKS`` and ``gen_benchmarks``
(``:733-819``).

Levels are generated on the host with NumPy, SciPy and the native
annealer, in forked worker processes when ``num_workers`` > 0. A worker
never touches torch: the parent may hold a CUDA context when it forks.
Each level draws from its own ``SeedSequence.spawn``, so equal seeds give
the JAX package's levels byte for byte, with or without workers. With
``device_batch`` N the iterator instead generates N levels at a time with
the device annealer (:mod:`..procgen.batched`) on its ``device``, without
workers; those levels match the JAX package's in distribution.

In a multi-process run (:mod:`..parallel.mesh`) every rank generates its
own pool from its own level stream, and the manager's ``pool`` is the
concatenation of all of them, the same on every rank (JAX's
``iterator.py:327-364, :466-538, :594-702``): the ranks agree on the agent
and exit padding first, the static flags are ANDed, slot metadata and
the busy slots are gathered, and every refresh gathers the pool again.
Each of these collectives runs on every rank, in the same order.
"""

import dataclasses
import logging
import multiprocessing
import os
import queue
import signal
import threading

import numpy as np
import torch

from ..core import cells as C
from ..env.state import (LevelBatch, goals_are_static, level_metadata,
                         pack_levels, slot_metadata)
from ..parallel import mesh as M
from ..utils.device import resolve_device
from ..utils.rng import set_rng
from . import levels as L

logger = logging.getLogger(__name__)

#: The pool's flags, fixed when it is built (``LevelBatch`` fields that are
#: not tensors).
_FLAGS = ("all_goals_static", "spawner_free")


def _load_param_file(file_name):
    import yaml

    with open(file_name) as f:
        data = yaml.safe_load(f)

    # Merge with the defaults file beside the param file when one exists
    # (so reference level trees keep their own defaults); otherwise with
    # the shipped tree's defaults.
    candidates = [
        os.path.join(os.path.dirname(file_name), "_defaults.yaml"),
        os.path.join(L.LEVEL_DIRECTORY, "random", "_defaults.yaml"),
    ]
    defaults = {}
    for c in candidates:
        if os.path.exists(c) and os.path.abspath(c) != \
                os.path.abspath(file_name):
            with open(c) as f:
                defaults = yaml.safe_load(f) or {}
            break
    merged = {**defaults, **(data or {})}
    for key in ("named_regions", "agent_types"):
        merged[key] = {**defaults.get(key, {}), **(data or {}).get(key, {})}
    return merged


def load_files(paths):
    """Resolve paths into [(name, kind, data)] entries; kind is 'procgen'
    or 'static'."""
    if not paths:
        return [[None, "procgen", {}]]
    out = []
    for file_name in L.find_files(*paths):
        if file_name.endswith((".yaml", ".json")):
            out.append([file_name, "procgen", _load_param_file(file_name)])
        else:
            for lv in L.load_levels_npz(file_name):
                name = os.path.join(file_name[:-4], lv.name) \
                    if lv.name else file_name
                out.append([name, "static", lv])
    return out


def _level_from_data(file_name, data_type, data, seed=None):
    from ..procgen.generate import gen_game

    if data_type == "procgen":
        with set_rng(np.random.default_rng(seed)):
            lv = gen_game(**data)
    else:
        lv = data.copy()
    if file_name:
        lv.name = os.path.basename(str(file_name)).replace(".yaml", "") \
            .replace(".json", "")
        if seed is not None and getattr(seed, "spawn_key", None):
            lv.name += "-e" + str(seed.spawn_key[-1])
    return lv


def _init_worker():
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    # If the parent dies (even by SIGKILL), the kernel kills this worker
    # too: an orphaned worker holds the parent's pipes open and can wedge
    # whatever waits for their end.
    try:
        import ctypes

        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


class SafeLifeLevelIterator:
    """Yields :class:`~.levels.Level` objects from level files or procgen
    specs (reference ``safelife/level_iterator.py``): path resolution with
    the level-directory fallback, forked workers that generate ahead,
    one ``SeedSequence.spawn`` a level, the ``distinct_levels`` cache and
    the ``get_next_parameters`` hook of the curricula. With
    ``device_batch`` > 0 the procgen levels anneal ``device_batch`` at a
    time on ``device`` (no workers)."""

    def __init__(self, *paths, repeat_levels=None, distinct_levels=None,
                 num_workers=0, max_queue=10, seed=None, device_batch=0,
                 device="cuda"):
        self.device = resolve_device(device) if device_batch else None
        self.file_data = load_files(paths)
        self.level_cache = []

        if repeat_levels is None:
            repeat_levels = any(d[1] == "procgen" for d in self.file_data)
        self.repeat_levels = repeat_levels
        self.distinct_levels = distinct_levels
        self.device_batch = device_batch
        self.num_workers = 0 if device_batch else num_workers
        self.max_queue = max(max_queue if self.num_workers > 0 else 1,
                             device_batch)
        self.results = None
        self.pool = None
        self.idx = 0
        self.seed(seed)

    def seed(self, seed):
        if not isinstance(seed, np.random.SeedSequence):
            seed = np.random.SeedSequence(seed)
        self._seed = seed

    def get_next_parameters(self):
        """Parameters for the next level; override for curricula."""
        return self.file_data[self.idx % len(self.file_data)]

    def fill_queue(self):
        if self.device_batch:
            return self._fill_queue_batched()
        if self.results is None:
            self.results = queue.deque(maxlen=self.max_queue)
        if self.num_workers > 0 and self.pool is None:
            # Forked workers (spawn would run __main__ again in each). The
            # parent may hold a CUDA context; generation is NumPy and the
            # annealer only, and close() kills a wedged worker.
            self.pool = multiprocessing.get_context("fork").Pool(
                processes=self.num_workers, initializer=_init_worker)
        while len(self.results) < self.max_queue:
            if self.distinct_levels is not None \
                    and self.idx >= self.distinct_levels:
                break
            if not self.repeat_levels and self.idx >= len(self.file_data):
                break
            data = self.get_next_parameters()
            if data is None:
                break
            self.idx += 1
            kwargs = {"seed": self._seed.spawn(1)[0]}
            if self.num_workers > 0:
                result = self.pool.apply_async(
                    _level_from_data, data, kwargs)
            else:
                result = _level_from_data(*data, **kwargs)
            self.results.append((data, result))

    def _fill_queue_batched(self):
        """Refill the queue with one device-batched generation round, only
        once it is empty: topping it up on every ``__next__`` would anneal
        one chain a call after the first fill. The gating is the host
        path's (the ``distinct_levels`` cache, ``repeat_levels``, the
        curricula's ``get_next_parameters``); static entries pass
        through, and every procgen request of the round anneals in one
        call of :func:`..procgen.batched.gen_games_batched`."""
        from ..procgen.batched import gen_games_batched

        if self.results is None:
            self.results = queue.deque(maxlen=self.max_queue)
        if self.results:
            return
        pending = []
        while len(self.results) + len(pending) < self.max_queue:
            if self.distinct_levels is not None \
                    and self.idx >= self.distinct_levels:
                break
            if not self.repeat_levels and self.idx >= len(self.file_data):
                break
            data = self.get_next_parameters()
            if data is None:
                break
            self.idx += 1
            seed = self._seed.spawn(1)[0]
            if data[1] == "procgen":
                pending.append((data, seed))
            else:
                self.results.append(
                    (data, _level_from_data(*data, seed=seed)))
        if not pending:
            return
        # A dedicated spawn seeds the device chains, independent of the
        # levels' own host streams.
        generator = torch.Generator(device=self.device).manual_seed(int(
            self._seed.spawn(1)[0].generate_state(1, np.uint32)[0]))
        levels = gen_games_batched(
            [d[2] for d, _ in pending],
            [np.random.default_rng(s) for _, s in pending], generator)
        for (data, seed), lv in zip(pending, levels):
            if data[0]:
                lv.name = os.path.basename(str(data[0])) \
                    .replace(".yaml", "").replace(".json", "")
                if getattr(seed, "spawn_key", None):
                    lv.name += "-e" + str(seed.spawn_key[-1])
            self.results.append((data, lv))

    def close(self):
        """Terminate the worker processes (idempotent).

        Terminate and join run under a watchdog thread: a worker wedged at
        fork can hang ``Pool.terminate`` itself. Any worker still alive
        after the grace period is killed by pid.
        """
        pool, self.pool = getattr(self, "pool", None), None
        if pool is None:
            return
        workers = list(getattr(pool, "_pool", []))

        def _teardown():
            pool.terminate()
            pool.join()

        t = threading.Thread(target=_teardown, daemon=True)
        t.start()
        t.join(timeout=10)
        for worker in workers:
            if worker.is_alive():
                try:
                    os.kill(worker.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass

    def __del__(self):
        self.close()

    def __getstate__(self):
        state = self.__dict__.copy()
        if self.num_workers > 0:
            state["pool"] = None
            state["results"] = queue.deque(
                [r.get() if hasattr(r, "get") else r for r in self.results],
                maxlen=self.max_queue)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __iter__(self):
        return self

    def __next__(self):
        self.fill_queue()
        if not self.results and self.distinct_levels is not None:
            if not self.repeat_levels and self.idx >= self.distinct_levels:
                raise StopIteration
            data = self.level_cache[self.idx % self.distinct_levels]
            result = _level_from_data(*data)
            self.idx += 1
        elif not self.results:
            raise StopIteration
        else:
            data, result = self.results.popleft()
        if hasattr(result, "get"):
            result = result.get()
        if (self.distinct_levels is not None
                and len(self.level_cache) < self.distinct_levels):
            if data[1] == "procgen":
                data = (data[0], "static", result.copy())
            self.level_cache.append(data)
        return result


class LevelPoolManager:
    """A level pool on the device, refreshed from an iterator.

    Training lanes reset onto pool slots on the device; between training
    iterations :meth:`refresh` swaps newly generated levels into free slots
    (round-robin), keeping the levels diverse without waiting on the
    generator.

    In a multi-process run the rank's ``pool_size`` levels fill its slice
    ``[rank * pool_size, (rank + 1) * pool_size)`` of the gathered ``pool``,
    and the rank refreshes only the slots of its slice.
    """

    def __init__(self, iterator, pool_size=64, pad_agents=None,
                 pad_exits=None, device="cuda"):
        self.device = resolve_device(device)
        self.iterator = iterator
        levels = [next(iterator) for _ in range(pool_size)]
        self._host_levels = levels
        self._pending = []  # levels waiting for a free slot
        self._slot = 0
        self._starved = 0
        self._restored_meta = None
        self._meta = None  # the live per-slot metadata (level_meta)
        self._multi = M.process_count() > 1
        self._local_pool = None  # the rank's slice (multi-process)
        if not self._multi:
            self.pool = pack_levels(levels, pad_agents, pad_exits,
                                    device=self.device)
            return
        # The padding must agree before the pools can be gathered.
        agents = max([pad_agents or 1] + [lv.num_agents for lv in levels])
        exits = max([pad_exits or 1] + [_num_exits(lv) for lv in levels])
        pads = torch.stack(M.all_gather(torch.tensor(
            [agents, exits], device=self.device))).max(0).values.tolist()
        self._local_pool = pack_levels(levels, pads[0], pads[1],
                                       device=self.device)
        self.pool = M.allgather_level_pool(self._local_pool)

    def close(self):
        """Shut down the iterator's worker processes, if it has any."""
        close = getattr(self.iterator, "close", None)
        if close is not None:
            close()

    def restore_pool(self, arrays):
        """Install a checkpointed pool in place of the one built.

        Lanes resumed mid-episode look their level up by pool slot, so a
        restored training state is scored right only against the pool it
        was saved with. Slot names are not saved: records of restored slots
        carry ``restored/slot-N`` names (with reward metadata computed from
        the restored arrays) until :meth:`refresh` puts new levels there.

        ``arrays`` is the saved :class:`LevelBatch` or a dict of its fields.
        Its flags are recomputed from its content, not taken from the pool
        built for this run, whose levels may differ. Returns the pool.
        """
        if dataclasses.is_dataclass(arrays):
            arrays = {f.name: getattr(arrays, f.name)
                      for f in dataclasses.fields(arrays)}
        fields = {k: torch.as_tensor(v).to(self.device)
                  for k, v in arrays.items() if k not in _FLAGS}
        b, g = fields["board"], fields["goals"]
        n = len(self._host_levels)
        expect = n * M.process_count()
        if b.shape[0] != expect \
                or tuple(b.shape[-2:]) != self.pool.board_shape:
            raise ValueError(
                "checkpointed level pool is %s but this run built %s "
                "(pool_size, board size or process count changed); resume "
                "with matching settings or start a fresh data_dir"
                % (tuple(b.shape), (expect,) + self.pool.board_shape))
        packed = LevelBatch(
            **fields,
            all_goals_static=bool(fields["goals_static"].all()),
            spawner_free=not bool(((b | g) & C.SPAWNING).any()),
        )
        self._restored_meta = dict(enumerate(slot_metadata(
            packed, ["restored/slot-%d" % i for i in range(b.shape[0])])))
        if self._meta is not None:
            self._meta.update(self._restored_meta)
        self.pool = packed
        if self._multi:
            off = M.process_index() * n
            self._local_pool = LevelBatch(
                **{k: v[off:off + n].clone() for k, v in fields.items()},
                all_goals_static=packed.all_goals_static,
                spawner_free=packed.spawner_free)
        return self.pool

    def level_meta(self):
        """The live per-slot metadata, keyed by pool slot. The dict is the
        manager's own: :meth:`refresh` updates the entries of the slots it
        swaps, so a holder always sees the level now in each slot."""
        if self._meta is None:
            if self._multi:
                # Every rank's slots, in rank order (a collective).
                local = level_metadata(self._host_levels, self._local_pool)
                parts = [None] * M.process_count()
                torch.distributed.all_gather_object(
                    parts, [local[i] for i in range(len(local))])
                self._meta = dict(enumerate(m for p in parts for m in p))
            else:
                self._meta = level_metadata(self._host_levels, self.pool)
            if self._restored_meta:
                self._meta.update(self._restored_meta)
        return self._meta

    def refresh(self, max_new=8, in_use=None):
        """Take up to ``max_new`` new levels and swap them into the pool.
        Returns how many were swapped in.

        ``in_use`` holds the pool slots that live lanes reference (an
        ``EnvState.level_idx``, say; in a multi-process run the rank's own
        lanes', the busy slots being ORed over the ranks). Those slots are
        NEVER overwritten:
        every env step gathers a lane's points table, exits and required
        points by its slot, so a swap under a running episode would score
        the rest of it against another level. Levels with no free slot wait
        for a later refresh. ``in_use=None`` skips the guard (callers with
        no live lanes).

        The pool's flags (``all_goals_static``, ``spawner_free``) stay as
        they were built, since :func:`_swap_rows` never touches them: the
        step picks its work from them. A new level
        that breaks one of them, or the pool's agent or exit padding, is
        dropped.
        """
        n_slots = len(self._host_levels)
        new = []
        # Take no more than would fill the wait queue, so that a busy pool
        # does not consume and drop the generator's output.
        workers = getattr(self.iterator, "num_workers", 0) > 0
        for _ in range(max(0, max_new - len(self._pending))):
            if workers:
                self.iterator.fill_queue()
                if not self.iterator.results or not \
                        self.iterator.results[0][1].ready():
                    break
            try:
                new.append(next(self.iterator))
            except StopIteration:
                break
        kept = [lv for lv in new if self._level_compatible(lv)]
        if len(kept) < len(new):
            logger.warning("dropped %d generated level(s) violating the "
                           "pool's flags or padding", len(new) - len(kept))
        self._pending.extend(kept)
        cap = max(4 * max_new, 32)
        if len(self._pending) > cap:
            self._pending = self._pending[-cap:]

        world = M.process_count()
        off = M.process_index() * n_slots
        busy = np.zeros(n_slots * world, bool)
        if in_use is not None:
            if isinstance(in_use, torch.Tensor):
                in_use = in_use.cpu().numpy()
            busy[np.asarray(in_use, np.int64)] = True
        if self._multi:
            # Lanes on any rank may be on this rank's slots. Every rank
            # makes this collective, pending levels or not.
            busy = M.all_reduce_sum(torch.as_tensor(
                busy, dtype=torch.int32, device=self.device)).cpu().numpy() > 0

        # Slots round-robin from the last one filled, skipping busy ones.
        slots = []
        probe = self._slot
        for _ in range(n_slots):
            if len(slots) >= len(self._pending):
                break
            if not busy[off + probe]:
                slots.append(probe)
            probe = (probe + 1) % n_slots
        if self._pending and not slots:
            self._starved += 1
            log_fn = logger.warning if self._starved == 10 else logger.info
            log_fn("level pool refresh deferred (%d in a row): all %d slots "
                   "are in use by live lanes (%d level(s) pending). Raise the "
                   "pool size (>= ~2x the lane count) if level turnover "
                   "during training matters.",
                   self._starved, n_slots, len(self._pending))
        elif slots:
            self._starved = 0
        kept = self._pending[:len(slots)]
        self._pending = self._pending[len(slots):]
        updates = {}
        if kept:
            self._slot = (slots[-1] + 1) % n_slots
            for lv, s in zip(kept, slots):
                self._host_levels[s] = lv
            # The flags of ``fresh`` are its own; _swap_rows leaves the
            # pool's.
            fresh = pack_levels(kept, self.pool.num_agents,
                                self.pool.exit_locs.shape[-2],
                                device=self.device)
            _swap_rows(self._local_pool if self._multi else self.pool,
                       fresh, torch.as_tensor(slots, dtype=torch.int64,
                                              device=self.device))
            updates = dict(zip((off + s for s in slots), slot_metadata(
                fresh, [lv.name or ("level-%d" % s)
                        for lv, s in zip(kept, slots)])))
        if self._multi:
            # Every rank gathers the pool again, in place (holders of the
            # pool see the new levels), and every rank's swapped slots.
            _swap_rows(self.pool, M.allgather_level_pool(self._local_pool),
                       torch.arange(n_slots * world, device=self.device))
            parts = [None] * world
            torch.distributed.all_gather_object(parts, updates)
            updates = {k: v for p in parts for k, v in p.items()}
        for s in updates:
            if self._restored_meta:
                self._restored_meta.pop(s, None)
        if self._meta is not None:
            self._meta.update(updates)
        return len(kept)

    def _level_compatible(self, lv):
        """Whether a new level keeps the pool's flags and fits its agent and
        exit padding."""
        if lv.num_agents > self.pool.num_agents:
            return False
        if _num_exits(lv) > self.pool.exit_locs.shape[-2]:
            return False
        if self.pool.spawner_free and bool(
                ((lv.board | lv.goals) & C.SPAWNING).any()):
            return False
        if self.pool.all_goals_static and not goals_are_static(lv.goals):
            return False
        return True


# ---------------------------------------------------------------------------
# Archive tooling (parity: reference level_iterator.py:290-357)


def gen_many(param_file, out_dir, num_gen, num_workers=8, seed=None):
    """Generate ``num_gen`` levels from a procgen param file into
    ``out_dir`` as individual ``<basename>-NNN.npz`` files.

    Existing files are kept (resumable), like the reference's generator.
    """
    out_dir = os.path.abspath(out_dir)
    base_name = os.path.basename(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    digits = len(str(num_gen))
    it = SafeLifeLevelIterator(param_file, num_workers=num_workers,
                               seed=seed)
    try:
        for k in range(1, num_gen + 1):
            fname = os.path.join(
                out_dir, "%s-%0*d.npz" % (base_name, digits, k))
            lv = next(it)  # always consume: a resumed seeded run keeps
            if os.path.exists(fname):  # the stream aligned with the files
                continue
            L.save_level(lv, fname)
    finally:
        it.close()


def combine_levels(directory, out_file=None):
    """Merge every single-level ``.npz`` in ``directory`` into one archive
    (structured array under key ``levels``, reference-compatible)."""
    import glob

    files = sorted(glob.glob(os.path.join(directory, "*.npz")))
    if not files:
        raise FileNotFoundError("no .npz levels in %s" % directory)
    levels = []
    for f in files:
        lv = L.load_levels(f)[0]
        lv.name = os.path.basename(f)
        levels.append(lv)
    out_file = out_file or directory.rstrip("/") + ".npz"
    L.save_archive(levels, out_file)
    return out_file


def expand_levels(file_name, out_dir=None):
    """Opposite of :func:`combine_levels`: split an archive into files."""
    out_dir = out_dir or file_name[:-4]
    os.makedirs(out_dir, exist_ok=True)
    for lv in L.load_levels(file_name):
        name = lv.name if lv.name.endswith(".npz") else lv.name + ".npz"
        L.save_level(lv, os.path.join(out_dir, os.path.basename(name)))
    return out_dir


BENCHMARK_TASKS = (
    "append-still", "append-dynamic", "append-spawn",
    "prune-dynamic", "prune-spawn", "prune-still", "prune-still-hard",
    "navigation",
)


def gen_benchmarks(out_dir, tasks=BENCHMARK_TASKS, num=100, seed=20260816,
                   num_workers=8):
    """Generate benchmark archives: ``num`` frozen levels per task, one
    archive ``<out_dir>/<task>.npz`` a task (kept if it exists).
    Deterministic given ``seed``; the canonical suite is the shipped
    frozen v1.0.

    ``out_dir`` is required. JAX's default, ``<levels>/benchmarks/v1``,
    lies in the JAX package's level tree, which the port only reads
    (:data:`.levels.LEVEL_DIRECTORY`).
    """
    os.makedirs(out_dir, exist_ok=True)
    root = np.random.SeedSequence(seed)
    outs = []
    for task, task_seed in zip(tasks, root.spawn(len(tasks))):
        out_file = os.path.join(out_dir, task + ".npz")
        if os.path.exists(out_file):
            outs.append(out_file)
            continue
        it = SafeLifeLevelIterator("random/" + task, seed=task_seed,
                                   num_workers=num_workers)
        try:
            levels = []
            for i in range(num):
                lv = next(it)
                lv.name = "%s-%03d.npz" % (task, i + 1)
                levels.append(lv)
        finally:
            it.close()
        L.save_archive(levels, out_file)
        outs.append(out_file)
    return outs


def _num_exits(lv):
    return int(((lv.board & (C.EXIT | C.AGENT)) == C.EXIT).sum())


def _swap_rows(pool, fresh, idx):
    """Rows ``idx`` of every tensor of ``pool`` <- the rows of ``fresh``,
    in place: holders of the pool see the new levels."""
    for f in dataclasses.fields(pool):
        if f.name not in _FLAGS:
            getattr(pool, f.name).index_copy_(0, idx, getattr(fresh, f.name))
    return pool
