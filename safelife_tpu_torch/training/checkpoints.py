"""Checkpoints on ``torch.save`` / ``torch.load``.

Port of ``safelife_tpu/training/checkpoints.py:21-101`` (``save``,
``save_if_needed``, ``latest_step``, ``restore``; Orbax there). A file
here describes itself, so Orbax's ``structure`` and template-free
``restore_raw`` have no counterpart: ``restore`` returns what was saved.
Reference ``BaseAlgo`` checkpointing (``training/base_algo.py:40-139``):
save every ``interval`` (100k) steps, keep the last 3, restore the latest;
the logger's cumulative stats ride in a JSON sidecar. The env batch and
the level pool are tensors too, so a run can resume mid-episode.

A state is a nested dict (lists and tuples too) of tensors and Python
scalars, e.g. ``{"params": model.state_dict(), "opt_state":
optimizer.state_dict(), "num_steps": n, "env_state": ws, "pool": pool}``.
Dataclasses of the port (``WrappedState``, ``EnvState``, ``LevelBatch``)
are stored field by field with their class's name and come back as the same
dataclasses. Files are loaded with ``weights_only=True``.
"""

import dataclasses
import importlib
import json
import os
import re

import torch

from ..utils.device import resolve_device

_CLASS_KEY = "__dataclass__"
_PACKAGE = __name__.split(".")[0]


def _encode(obj):
    """Tensors to the CPU, dataclasses to tagged dicts of their fields."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        fields = {f.name: _encode(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)}
        return {_CLASS_KEY: "%s:%s" % (cls.__module__, cls.__qualname__),
                "fields": fields}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    return obj


def _decode(obj, device):
    """Inverse of :func:`_encode`, with every tensor on ``device``."""
    if isinstance(obj, dict):
        if _CLASS_KEY in obj:
            module, _, name = obj[_CLASS_KEY].partition(":")
            if module.split(".")[0] != _PACKAGE:
                raise ValueError("checkpoint names a class outside %s: %s"
                                 % (_PACKAGE, obj[_CLASS_KEY]))
            cls = importlib.import_module(module)
            for part in name.split("."):
                cls = getattr(cls, part)
            return cls(**{k: _decode(v, device)
                          for k, v in obj["fields"].items()})
        return {k: _decode(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode(v, device) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return obj


class CheckpointManager:
    """Checkpoints of a run under ``<logdir>/checkpoints``: one
    ``ckpt-<step>.pt`` per saved step, the last ``max_to_keep`` kept, with an
    ``extra-<step>.json`` sidecar when ``extra`` is given."""

    def __init__(self, logdir, interval=100_000, max_to_keep=3):
        self.logdir = logdir
        self.interval = interval
        self.max_to_keep = max_to_keep
        self.next_checkpoint = None
        self.path = os.path.join(os.path.abspath(logdir), "checkpoints")
        os.makedirs(self.path, exist_ok=True)

    def _ckpt_path(self, step):
        return os.path.join(self.path, "ckpt-%d.pt" % int(step))

    def _extra_path(self, step):
        return os.path.join(self.path, "extra-%d.json" % int(step))

    def steps(self):
        """The saved steps, oldest first."""
        found = (re.fullmatch(r"ckpt-(\d+)\.pt", f)
                 for f in os.listdir(self.path))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step, state, extra=None):
        """Save ``state`` and a small JSON ``extra`` dict at ``step``, then
        drop all but the last ``max_to_keep`` checkpoints. Each file is
        written beside its final name and renamed, so a checkpoint on disk
        is whole."""
        path = self._ckpt_path(step)
        torch.save(_encode(state), path + ".tmp")
        os.replace(path + ".tmp", path)
        if extra is not None:
            with open(self._extra_path(step) + ".tmp", "w") as f:
                json.dump(extra, f)
            os.replace(self._extra_path(step) + ".tmp",
                       self._extra_path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._ckpt_path(old))
            if os.path.exists(self._extra_path(old)):
                os.remove(self._extra_path(old))

    def save_if_needed(self, step, state, extra=None):
        """Save when ``step`` has reached the next multiple of
        ``interval``."""
        if self.next_checkpoint is None:
            self.next_checkpoint = (
                int(step) // self.interval + 1) * self.interval
        if int(step) >= self.next_checkpoint:
            self.save(step, state, extra)
            self.next_checkpoint = (
                int(step) // self.interval + 1) * self.interval

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, device="cuda"):
        """The latest checkpoint: (state, extra, step), the state as it was
        saved with its tensors on ``device``; (None, None, None) when there
        is none."""
        dev = resolve_device(device)
        step = self.latest_step()
        if step is None:
            return None, None, None
        state = _decode(torch.load(self._ckpt_path(step),
                                   weights_only=True), dev)
        extra = None
        if os.path.exists(self._extra_path(step)):
            with open(self._extra_path(step)) as f:
                extra = json.load(f)
        return state, extra, step
