"""Global hyperparameter configuration.

Port of ``safelife_tpu/training/global_config.py:1-88`` (the port's own
copy): ``GlobalConfig``, ``config`` and ``build_config``.

Parity: reference ``training/global_config.py`` — a dict singleton with
namespaced keys (``ppo.gamma``, ``env.view_size``), hook-driven updates,
and unused-parameter warnings. The reference mutates annotated class
attributes in place; in this functional codebase configs are frozen
dataclasses, so :func:`build_config` constructs them with overrides applied
from the namespace instead.
"""

import dataclasses
import logging

logger = logging.getLogger(__name__)


class GlobalConfig(dict):
    """Dict with set-hooks and usage tracking."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._used = set()
        self._hooks = []

    def add_hook(self, hook):
        self._hooks.append(hook)

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        for hook in self._hooks:
            hook(key, value)

    def update(self, *args, **kwargs):
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def setdefault(self, key, default=None):
        self._used.add(key)
        if key not in self:
            self[key] = default
        return self[key]

    def get_scoped(self, scope, name, default):
        """Look up '<scope>.<name>', falling back to bare '<name>'."""
        for key in ("%s.%s" % (scope, name), name):
            if key in self:
                self._used.add(key)
                return self[key]
        return default

    def check_for_unused(self):
        unused = [k for k in self if k not in self._used
                  and not k.startswith("_")]
        if unused:
            logger.warning(
                "The following configuration parameters were set but never "
                "used: %s", ", ".join(sorted(unused)))
        return unused


#: The process-wide configuration (parity: the reference's module-level
#: ``config`` singleton).
config = GlobalConfig()


def build_config(cls, scope, base=None, **extra):
    """Construct a frozen config dataclass with global overrides applied.

    For each field of ``cls``, a ``<scope>.<field>`` (or bare ``<field>``)
    key in the global config wins over the dataclass default. ``extra``
    keyword arguments win over everything.
    """
    base = base or {}
    values = {}
    for f in dataclasses.fields(cls):
        default = getattr(base, f.name, None) if not isinstance(base, dict) \
            else base.get(f.name)
        if default is None:
            default = f.default if f.default is not dataclasses.MISSING \
                else (f.default_factory()
                      if f.default_factory is not dataclasses.MISSING
                      else None)
        val = config.get_scoped(scope, f.name, default)
        if isinstance(val, list):
            val = tuple(val)
        values[f.name] = val
    values.update(extra)
    return cls(**values)
