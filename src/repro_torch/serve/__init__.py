"""LM serving: prefill, decode and a batched greedy engine."""
from . import serve_step  # noqa: F401
from .serve_step import Engine  # noqa: F401
