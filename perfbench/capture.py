"""Wrapping the program's functions where their callers look them up.

The benchmark takes its spans and the outputs it judges from outside the
program: a module attribute (``ppo.rollout``, ``env.seed_words``, ...) is
replaced for the life of a ``with`` block by a function that calls the
original, and the original is put back after. Callers that look the name
up at call time (``module.name`` or a module-level call) then run the
wrapper.
"""

import contextlib
import time

import torch


@contextlib.contextmanager
def patched(module, name, make):
    """``module.name`` replaced by ``make(original)`` inside the block."""
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield original
    finally:
        setattr(module, name, original)


def after(module, name, fn):
    """Call ``fn(args, kwargs, result)`` after each call of ``module.name``;
    the result it returns (``None``: the original result) is passed on."""
    def make(original):
        def call(*args, **kwargs):
            out = original(*args, **kwargs)
            new = fn(args, kwargs, out)
            return out if new is None else new
        return call
    return patched(module, name, make)


class Spans:
    """Host-clock durations of calls of wrapped functions, by span name.

    With ``sync`` a span waits for the device before it starts and before
    it ends, so that it holds the device work of its call; without, it is
    the host's time in the call (its dispatch). With ``ranges`` each call
    is also a ``torch.profiler.record_function`` range of the span's name,
    which a profile can read."""

    def __init__(self, sync=True, ranges=False):
        self.sync = sync and torch.cuda.is_available()
        self.ranges = ranges
        self.seconds = {}
        self.stack = contextlib.ExitStack()

    def wrap(self, module, attr, name, sync=None):
        """Time ``module.attr`` as span ``name`` (``sync``: this span's
        own choice, else the object's)."""
        sync = self.sync if sync is None else (
            sync and torch.cuda.is_available())

        def make(original):
            def call(*args, **kwargs):
                if sync:
                    torch.cuda.synchronize()
                rng = (torch.profiler.record_function(name) if self.ranges
                       else contextlib.nullcontext())
                t0 = time.perf_counter()
                with rng:
                    out = original(*args, **kwargs)
                    if sync:
                        torch.cuda.synchronize()
                self.seconds.setdefault(name, []).append(
                    time.perf_counter() - t0)
                return out
            return call
        self.stack.enter_context(patched(module, attr, make))

    def close(self):
        self.stack.close()
