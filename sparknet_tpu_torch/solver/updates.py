"""Solver update rules with Caffe's semantics, in place on PyTorch
tensors (the port of sparknet_tpu/solver/updates.py; Caffe
solvers/sgd_solver.cpp and siblings).

  order per step (sgd_solver.cpp ApplyUpdate :102-117):
    rate = lr_policy(iter)
    ClipGradients            on RAW summed grads (:81-99)
    per param: Normalize (grad /= iter_size, :119-140)
               Regularize (grad += decay_mult*wd * {w | sign(w)}, :143-205)
               ComputeUpdateValue (per solver type)
    param -= update

  SGD       h = m*h + lr_local*g;            u = h           (:207+)
  Nesterov  h' = m*h + lr_local*g;           u = (1+m)h' - m*h
  AdaGrad   h += g^2;                        u = lr_local * g/(sqrt(h)+delta)
  RMSProp   h = r*h + (1-r)*g^2;             u = lr_local * g/(sqrt(h)+delta)
  AdaDelta  hg = m*hg + (1-m)g^2
            u  = g * sqrt((hu+delta)/(hg+delta))
            hu = m*hu + (1-m)u^2;            u *= lr_local
  Adam      m1 = b1*m1 + (1-b1)g; m2 = b2*m2 + (1-b2)g^2
            u  = lr_local * sqrt(1-b2^t)/(1-b1^t) * m1/(sqrt(m2)+delta)

History is a per-param list of slot tensors, Caffe's ``history_`` blobs,
so .solverstate files interchange with the JAX package. Each formula is
evaluated in the JAX package's order and the result copied into the
param and history tensors in place, under torch.no_grad(). The JAX
package computes these in XLA, not in a kernel of its own, so PyTorch's
own elementwise ops serve here.
"""

import math

import torch

SOLVER_TYPES = ("SGD", "Nesterov", "AdaGrad", "RMSProp", "AdaDelta", "Adam")

# number of history slots per param
N_HISTORY = {"SGD": 1, "Nesterov": 1, "AdaGrad": 1, "RMSProp": 1,
             "AdaDelta": 2, "Adam": 2}


def canonical_name(name):
    """The SOLVER_TYPES spelling of ``name``, matched case-insensitively."""
    for s in SOLVER_TYPES:
        if name.lower() == s.lower():
            return s
    raise ValueError(f"unknown solver type {name!r}")


def canonical_type(sp):
    """Resolve the solver type string, honoring the deprecated enum
    (Caffe solver_factory via SolverParameter.type / solver_type)."""
    t = sp.type
    if sp.has("solver_type") and not sp.has("type"):
        t = SOLVER_TYPES[int(sp.solver_type)]
    return canonical_name(t)


def init_history(solver_type, params):
    n = N_HISTORY[solver_type]
    return {name: [[torch.zeros_like(p, requires_grad=False)
                    for _ in range(n)] for p in blobs]
            for name, blobs in params.items()}


def clip_scale_of(grads, clip):
    """The global-L2-norm clipping factor (sgd_solver.cpp:81-99) as a
    0-d tensor on the grads' device, or None when clipping is off
    (clip < 0). The norm is summed in f32."""
    if clip is None or clip < 0:
        return None
    return clip_factor(sum((g.float() ** 2).sum() for g in grads), clip)


def clip_factor(sumsq, clip):
    """clip / ||g|| where the norm (sqrt of ``sumsq``) exceeds ``clip``,
    else 1."""
    norm = torch.sqrt(sumsq)
    return torch.where(norm > clip, clip / torch.clamp(norm, min=1e-30),
                       torch.ones_like(norm))


def regularize(grad, param, wd_local, reg_type):
    if wd_local == 0.0:
        return grad
    if reg_type == "L1":
        return grad + wd_local * torch.sign(param)
    return grad + wd_local * param  # L2


def compute_update(solver_type, grad, history, local_rate, *, momentum,
                   delta, rms_decay, momentum2, t):
    """-> (update, new_history). ``t`` = iter+1 (Adam bias correction)."""
    g = grad
    if solver_type == "SGD":
        h = momentum * history[0] + local_rate * g
        return h, [h]
    if solver_type == "Nesterov":
        h_new = momentum * history[0] + local_rate * g
        u = (1.0 + momentum) * h_new - momentum * history[0]
        return u, [h_new]
    if solver_type == "AdaGrad":
        h = history[0] + g * g
        u = local_rate * g / (torch.sqrt(h) + delta)
        return u, [h]
    if solver_type == "RMSProp":
        h = rms_decay * history[0] + (1.0 - rms_decay) * g * g
        u = local_rate * g / (torch.sqrt(h) + delta)
        return u, [h]
    if solver_type == "AdaDelta":
        hg = momentum * history[0] + (1.0 - momentum) * g * g
        u = g * torch.sqrt((history[1] + delta) / (hg + delta))
        hu = momentum * history[1] + (1.0 - momentum) * u * u
        return local_rate * u, [hg, hu]
    if solver_type == "Adam":
        m1 = momentum * history[0] + (1.0 - momentum) * g
        m2 = momentum2 * history[1] + (1.0 - momentum2) * g * g
        correction = math.sqrt(1.0 - momentum2 ** t) / (1.0 - momentum ** t)
        u = local_rate * correction * m1 / (torch.sqrt(m2) + delta)
        return u, [m1, m2]
    raise ValueError(solver_type)


class Updater:
    """Bound update for one SolverParameter and param-multiplier map.

    mults: {layer: [(lr_mult, decay_mult) per owned param]}.
    """

    def __init__(self, sp, mults):
        self.solver_type = canonical_type(sp)
        self.momentum = float(sp.momentum) if sp.has("momentum") else 0.0
        self.momentum2 = float(sp.momentum2)
        self.delta = float(sp.delta)
        self.rms_decay = float(sp.rms_decay) if sp.has("rms_decay") else 0.99
        self.weight_decay = float(sp.weight_decay) \
            if sp.has("weight_decay") else 0.0
        self.reg_type = sp.regularization_type
        self.clip = float(sp.clip_gradients)
        self.iter_size = int(sp.iter_size)
        self.mults = mults

    def init(self, params):
        return init_history(self.solver_type, params)

    @torch.no_grad()
    def __call__(self, params, grads, history, rate, it, clip_scale=None):
        """One update of ``params`` and ``history`` in place from
        ``grads`` (same structure as params: the summed micro-batch
        gradients), at policy rate ``rate`` for iteration ``it``.
        ``clip_scale`` overrides the clipping factor of ``grads`` (a
        sharded solver's, taken over the global gradient)."""
        scale = clip_scale if clip_scale is not None else clip_scale_of(
            [g for gs in grads.values() for g in gs], self.clip)
        for lname, blobs in params.items():
            for i, p in enumerate(blobs):
                self.update_blob(lname, i, p, grads[lname][i],
                                 history[lname][i], rate, it, scale)

    @torch.no_grad()
    def update_blob(self, lname, i, p, g, history, rate, it, scale=None):
        """The update of one param blob ``p`` (layer ``lname``, owned
        blob ``i``; a view updates its rows in place) and its history
        slots from its gradient ``g``."""
        g = g.to(p.dtype)
        if scale is not None:
            g = g * scale
        lr_mult, decay_mult = self.mults[lname][i]
        if self.iter_size > 1:
            g = g / self.iter_size
        g = regularize(g, p, self.weight_decay * decay_mult, self.reg_type)
        u, new = compute_update(
            self.solver_type, g, history, rate * lr_mult,
            momentum=self.momentum, delta=self.delta,
            rms_decay=self.rms_decay, momentum2=self.momentum2, t=it + 1)
        for h, v in zip(history, new):
            h.copy_(v)
        p.sub_(u)
