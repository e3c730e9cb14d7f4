"""Adapter-pool errors (the scheduler's ``AdapterPoolFull``). LoRA
serving itself is not ported yet."""

from .pool import AdapterPoolFull

__all__ = ["AdapterPoolFull"]
