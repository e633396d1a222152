"""Utilities of the port: the JSONL MetricsLogger and the Watchdog."""

from .metrics import MetricsLogger
from .watchdog import Watchdog

__all__ = ["MetricsLogger", "Watchdog"]
