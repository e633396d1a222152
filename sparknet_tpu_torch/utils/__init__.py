"""Utilities of the port: the JSONL MetricsLogger, the signal policy,
timers, the Watchdog and the exit-code table."""

from .metrics import MetricsLogger
from .signals import SignalPolicy
from .timing import StepTimer, Timer
from .watchdog import Watchdog

__all__ = ["MetricsLogger", "SignalPolicy", "StepTimer", "Timer",
           "Watchdog"]
