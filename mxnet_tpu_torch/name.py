"""Automatic naming: the port's copy of `mxnet_tpu.name` (NameManager,
Prefix).

Thread-local manager stack generating unique names like `dense0`, `conv1_`;
Gluon block prefixes come from it, so parameter names match the
reference's (`resnetv10_stage1_conv0_weight`, ...).
"""

import threading

__all__ = ["NameManager", "Prefix"]


class _Current(threading.local):
    def __init__(self):
        self.value = None


class NameManager:
    """reference: python/mxnet/name.py (NameManager)."""

    _current = _Current()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        """Return `name` if given, else generate `hint%d`."""
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        if NameManager._current.value is None:
            NameManager._current.value = NameManager()
        self._old_manager = NameManager._current.value
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_manager
        NameManager._current.value = self._old_manager


class Prefix(NameManager):
    """Manager that prepends a prefix to every name.
    reference: python/mxnet/name.py (Prefix)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


# expose a class-level accessor mirroring the reference's
# `NameManager.current` property usage
class _CurrentAccessor:
    def get(self, name, hint):
        cur = NameManager._current.value
        if cur is None:
            cur = NameManager._current.value = NameManager()
        return cur.get(name, hint)


NameManager.current = _CurrentAccessor()
