"""Carry parameters and solver history across from the JAX package's
numpy form.

Both packages keep Caffe's blob layouts — conv weights (O, I/group, kh,
kw), InnerProduct weights (out, in), biases (O,) — so carrying weights
over is a check of names and shapes plus a dtype conversion.
"""

import numpy as np
import torch


def _expected(net):
    want = {}
    for (owner, idx), meta in sorted(net.param_meta.items()):
        want.setdefault(owner, []).append(tuple(meta[0]))
    return want


def _tensor(net, what, arr, shape):
    arr = np.asarray(arr)
    if arr.shape != shape:
        raise ValueError(f"{what}: shape {arr.shape}, the net has {shape}")
    return torch.from_numpy(np.array(arr, np.float32)).to(net.device,
                                                          net.dtype)


def _convert(net, what, arrays_by_layer, want):
    unknown = sorted(set(arrays_by_layer) - set(want))
    missing = sorted(set(want) - set(arrays_by_layer))
    if unknown or missing:
        raise ValueError(f"{what}: layers not in the net {unknown}, "
                         f"net layers without {what} {missing}")
    out = {}
    for name, shapes in want.items():
        arrays = list(arrays_by_layer[name])
        if len(arrays) != len(shapes):
            raise ValueError(f"{what} of layer {name!r}: {len(arrays)} "
                             f"blobs, the net has {len(shapes)}")
        out[name] = [_tensor(net, f"{what} of layer {name!r} blob {i}",
                             arr, shape)
                     for i, (arr, shape) in enumerate(zip(arrays, shapes))]
    return out


def params_from_numpy(net, params_np, state_np=None):
    """``{layer: [np.ndarray]}`` (the JAX package's params, e.g. as
    ``jax.tree.map(np.asarray, params)``) -> ``(params, state)`` for the
    port's CompiledNet ``net``, on its device and in its dtype. Raises
    ValueError on a layer, blob count or shape that does not match."""
    params = _convert(net, "params", params_np, _expected(net))
    want_state = {lp.name: [tuple(s) for s, _ in impl.state_shapes()]
                  for lp, impl, _, _ in net.layers if impl.state_shapes()}
    state = _convert(net, "state", state_np or {}, want_state)
    return params, state


def history_from_numpy(net, solver_type, history_np):
    """``{layer: [[np.ndarray per slot] per param]}`` (the JAX package's
    solver history, e.g. ``jax.tree.map(np.asarray, solver.history)``)
    -> the same structure of tensors for the port's Solver over
    CompiledNet ``net``, on its device in f32. ``solver_type`` fixes the
    slot count (two for AdaDelta and Adam, one otherwise). Raises
    ValueError on a layer, param, slot count or shape that does not
    match."""
    from ..solver.updates import N_HISTORY, canonical_name
    n_slots = N_HISTORY[canonical_name(solver_type)]
    bad = [(name, i, len(slots)) for name, v in history_np.items()
           for i, slots in enumerate(v) if len(slots) != n_slots]
    if bad:
        raise ValueError(f"history: (layer, param, slots) {bad}; "
                         f"{solver_type} keeps {n_slots} slots")
    per_layer = _convert(net, "history", {
        name: [a for slots in v for a in slots]
        for name, v in history_np.items()}, {
        name: [s for s in shapes for _ in range(n_slots)]
        for name, shapes in _expected(net).items()})
    return {name: [ts[i:i + n_slots] for i in range(0, len(ts), n_slots)]
            for name, ts in per_layer.items()}
