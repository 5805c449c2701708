# analysis-virtual-path: gserve/widget.py
"""LD001 good: guarded state only mutated under the lock; private helpers
whose every call site holds the lock inherit the locked context; unguarded
attributes stay free."""
import threading


class Widget:
    def __init__(self):
        self._lock = threading.Lock()
        self._cache = {}
        self._stats = 0       # never written under the lock: unguarded

    def swap(self, items):
        with self._lock:
            self._store(items)

    def clear(self):
        with self._lock:
            self._store(())

    def _store(self, items):
        # locked context: both call sites above hold self._lock
        self._cache = dict(items)

    def note(self):
        self._stats += 1      # unguarded attr, no lock needed
