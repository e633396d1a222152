"""Distributed solvers of the port over worker slots stacked on one
device: per-step data parallelism and SparkNet's tau-step local SGD."""

from .data_parallel import DataParallelSolver, LocalSGDSolver

__all__ = ["DataParallelSolver", "LocalSGDSolver"]
