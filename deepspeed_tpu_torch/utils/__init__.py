"""Logging and device helpers."""

from .device import resolve_device
from .logging import log_dist, logger

__all__ = ["log_dist", "logger", "resolve_device"]
