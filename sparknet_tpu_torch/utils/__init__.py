"""Utilities of the port: the JSONL MetricsLogger."""

from .metrics import MetricsLogger

__all__ = ["MetricsLogger"]
