"""NetParameter -> compiled net (compiler.py), plus the legacy net and
solver upgrades, the layer registry, fillers and weight carry-over."""

from .compiler import CompiledNet, filter_net, upgrade_v1, TRAIN, TEST
from .upgrade import upgrade_net, upgrade_v0, needs_v0_upgrade, \
    upgrade_solver, solver_needs_type_upgrade
from .registry import register, get, Layer
from .weights import history_from_numpy, params_from_numpy

__all__ = ["CompiledNet", "filter_net", "upgrade_v1", "TRAIN", "TEST",
           "upgrade_net", "upgrade_v0", "needs_v0_upgrade", "register",
           "get", "Layer", "params_from_numpy", "history_from_numpy",
           "upgrade_solver", "solver_needs_type_upgrade"]
