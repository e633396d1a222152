"""Caffe's solver-history order, which the binaryproto .solverstate
follows (sgd_solver.cpp :278-297 for the HDF5 twin).

History blobs are slot-major: all learnable params' slot 0 (in net
order), then all slot 1 (AdaDelta and Adam push their second round of
blobs after the first, sgd_solver.cpp PreSolve / adadelta_solver.cpp),
only layers that own their params.

Reading and writing the HDF5 snapshot format itself is not ported yet:
it needs h5py, which the card's machine does not have.
"""


def owned_param_keys(net):
    """[(layer_name, idx)] in net order — learnable-param order."""
    keys = []
    for lp, impl, bottoms, tops in net.layers:
        for key in net.param_refs.get(lp.name, ()):
            if key[0] == lp.name:
                keys.append(key)
    return keys


def history_order(net, history):
    """Yield (layer_name, param_idx, slot_idx) in caffe history_ order:
    slot-major over learnable params."""
    keys = owned_param_keys(net)
    n_slots = max((len(history[l][i]) for l, i in keys), default=0)
    for s in range(n_slots):
        for (l, i) in keys:
            if s < len(history[l][i]):
                yield l, i, s
