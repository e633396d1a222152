"""Solver suite: Caffe's optimizers, lr policies and the training loop
on one device (the port of sparknet_tpu/solver)."""

from .solver import Solver, resolve_nets
from .updates import Updater, canonical_type, SOLVER_TYPES
from .lr_policy import make_lr_fn

__all__ = ["Solver", "resolve_nets", "Updater", "canonical_type",
           "SOLVER_TYPES", "make_lr_fn"]
