"""Batched serving: prefill, then a KV-cache decode loop."""
from .engine import Engine, ServeStats, grow_caches

__all__ = ["Engine", "ServeStats", "grow_caches"]
