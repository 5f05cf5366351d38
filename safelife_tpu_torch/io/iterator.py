"""The training level pool, refreshed from a level iterator.

Port of part of ``safelife_tpu/io/iterator.py``: ``LevelPoolManager`` for
one process (``__init__`` ``:310-331``, ``close``, ``restore_pool``
``:370-460``, ``level_meta`` ``:504-538``, ``refresh`` ``:540-705``,
``_level_compatible`` ``:707-729``) and ``_swap_rows`` (``:822-833``).
The level generator (``SafeLifeLevelIterator``) and the multi-host pool
are not ported yet: the manager takes any iterator of
:class:`~.levels.Level` objects, and uses an iterator's worker results
only when it has them (``num_workers``, ``fill_queue``, ``results``).
"""

import dataclasses
import logging

import numpy as np
import torch

from ..core import cells as C
from ..env.state import (LevelBatch, goals_are_static, level_metadata,
                         pack_levels, slot_metadata)
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

#: The pool's flags, fixed when it is built (``LevelBatch`` fields that are
#: not tensors).
_FLAGS = ("all_goals_static", "spawner_free")


class LevelPoolManager:
    """A level pool on the device, refreshed from an iterator.

    Training lanes reset onto pool slots on the device; between training
    iterations :meth:`refresh` swaps newly generated levels into free slots
    (round-robin), keeping the levels diverse without waiting on the
    generator.
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
        self.pool = pack_levels(levels, pad_agents, pad_exits,
                                device=self.device)

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
        if b.shape[0] != len(self._host_levels) \
                or tuple(b.shape[-2:]) != self.pool.board_shape:
            raise ValueError(
                "checkpointed level pool is %s but this run built %s "
                "(pool_size or board size changed); resume with matching "
                "settings or start a fresh data_dir"
                % (tuple(b.shape), (len(self._host_levels),)
                   + self.pool.board_shape))
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
        return self.pool

    def level_meta(self):
        """The live per-slot metadata, keyed by pool slot. The dict is the
        manager's own: :meth:`refresh` updates the entries of the slots it
        swaps, so a holder always sees the level now in each slot."""
        if self._meta is None:
            self._meta = level_metadata(self._host_levels, self.pool)
            if self._restored_meta:
                self._meta.update(self._restored_meta)
        return self._meta

    def refresh(self, max_new=8, in_use=None):
        """Take up to ``max_new`` new levels and swap them into the pool.
        Returns how many were swapped in.

        ``in_use`` holds the pool slots that live lanes reference (an
        ``EnvState.level_idx``, say). Those slots are NEVER overwritten:
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

        busy = np.zeros(n_slots, bool)
        if in_use is not None:
            if isinstance(in_use, torch.Tensor):
                in_use = in_use.cpu().numpy()
            busy[np.asarray(in_use, np.int64)] = True

        # Slots round-robin from the last one filled, skipping busy ones.
        slots = []
        probe = self._slot
        for _ in range(n_slots):
            if len(slots) >= len(self._pending):
                break
            if not busy[probe]:
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
        if not kept:
            return 0
        self._slot = (slots[-1] + 1) % n_slots
        for lv, s in zip(kept, slots):
            self._host_levels[s] = lv
            if self._restored_meta:
                self._restored_meta.pop(s, None)
        # The flags of ``fresh`` are its own; _swap_rows leaves the pool's.
        fresh = pack_levels(kept, self.pool.num_agents,
                            self.pool.exit_locs.shape[-2], device=self.device)
        _swap_rows(self.pool, fresh,
                   torch.as_tensor(slots, dtype=torch.int64,
                                   device=self.device))
        if self._meta is not None:
            self._meta.update(zip(slots, slot_metadata(
                fresh, [lv.name or ("level-%d" % s)
                        for lv, s in zip(kept, slots)])))
        return len(kept)

    def _level_compatible(self, lv):
        """Whether a new level keeps the pool's flags and fits its agent and
        exit padding."""
        if lv.num_agents > self.pool.num_agents:
            return False
        n_exits = int(((lv.board & (C.EXIT | C.AGENT)) == C.EXIT).sum())
        if n_exits > self.pool.exit_locs.shape[-2]:
            return False
        if self.pool.spawner_free and bool(
                ((lv.board | lv.goals) & C.SPAWNING).any()):
            return False
        if self.pool.all_goals_static and not goals_are_static(lv.goals):
            return False
        return True


def _swap_rows(pool, fresh, idx):
    """Rows ``idx`` of every tensor of ``pool`` <- the rows of ``fresh``,
    in place: holders of the pool see the new levels."""
    for f in dataclasses.fields(pool):
        if f.name not in _FLAGS:
            getattr(pool, f.name).index_copy_(0, idx, getattr(fresh, f.name))
    return pool
