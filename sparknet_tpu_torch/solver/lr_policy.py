"""Learning-rate policies (Caffe sgd_solver.cpp GetLearningRate :27-79),
as plain Python on the iteration index.

  fixed:     base_lr
  step:      base_lr * gamma ^ floor(iter / stepsize)
  exp:       base_lr * gamma ^ iter
  inv:       base_lr * (1 + gamma * iter) ^ -power
  multistep: base_lr * gamma ^ (#stepvalues <= iter)
  poly:      base_lr * (1 - iter/max_iter) ^ power
  sigmoid:   base_lr * 1/(1 + exp(-gamma * (iter - stepsize)))

The JAX package evaluates the same formulas in f32 inside its compiled
step; here they are Python floats (f64), which differ from it in the
last f32 digit at most.
"""

import math


def make_lr_fn(sp):
    """SolverParameter -> fn(iter) -> lr (a Python float)."""
    policy = sp.lr_policy
    base_lr = float(sp.base_lr)
    gamma, power = float(sp.gamma), float(sp.power)
    stepsize, max_iter = int(sp.stepsize), int(sp.max_iter)
    if policy == "fixed":
        return lambda it: base_lr
    if policy == "step":
        return lambda it: base_lr * gamma ** math.floor(it / stepsize)
    if policy == "exp":
        return lambda it: base_lr * gamma ** it
    if policy == "inv":
        return lambda it: base_lr * (1.0 + gamma * it) ** (-power)
    if policy == "multistep":
        steps = [int(s) for s in sp.stepvalue]
        return lambda it: base_lr * gamma ** sum(s <= it for s in steps)
    if policy == "poly":
        return lambda it: base_lr * (1.0 - it / max_iter) ** power
    if policy == "sigmoid":
        return lambda it: base_lr / (1.0 + math.exp(-gamma
                                                    * (it - stepsize)))
    raise ValueError(f"unknown lr_policy {policy!r}")
