# analysis-virtual-path: gserve/widget.py
"""LD001 bad: an attribute written both under and outside self._lock."""
import threading


class Widget:
    def __init__(self):
        self._lock = threading.Lock()
        self._cache = {}
        self._epoch = 0

    def swap(self, items):
        with self._lock:
            self._cache = dict(items)
            self._epoch += 1

    def refresh(self, items):
        self._cache = dict(items)  # FLAG: LD001
        self._cache.update(items)  # FLAG: LD001

    def bump(self):
        self._epoch += 1  # FLAG: LD001
