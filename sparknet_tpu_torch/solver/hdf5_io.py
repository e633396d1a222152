"""HDF5 checkpoint format, in the reference's layout (the port of
sparknet_tpu/solver/hdf5_io.py).

Net weights (net.cpp ToHDF5 :926-974):      /data/<layer_name>/<param_idx>
Solver state (sgd_solver.cpp :278-297):     /iter, /learned_net,
                                            /current_step, /history/<i>

History blobs are slot-major, in Caffe's history_ order, which the
binaryproto .solverstate follows too: all learnable params' slot 0 (in
net order), then all slot 1 (AdaDelta and Adam push their second round
of blobs after the first, sgd_solver.cpp PreSolve /
adadelta_solver.cpp), only layers that own their params.

h5py is imported only when an HDF5 file is read or written: the card's
machine has no h5py, and the binaryproto snapshots need none.
"""

import numpy as np
import torch


def _h5py():
    import h5py
    return h5py


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


def _array(t):
    return t.detach().to("cpu", torch.float32).numpy()


def save_net_hdf5(path, net, params):
    h5 = _h5py()
    with h5.File(path, "w") as f:
        data = f.create_group("data")
        for lp, impl, bottoms, tops in net.layers:
            owned = [k for k in net.param_refs.get(lp.name, ())
                     if k[0] == lp.name]
            g = data.create_group(lp.name)
            for (lname, i) in owned:
                g.create_dataset(str(i), data=_array(params[lname][i]))


def load_net_hdf5(path, params):
    """Copy the file's datasets into ``params`` in place
    (CopyTrainedLayersFromHDF5: layers matched by name, missing layers
    ignored)."""
    h5 = _h5py()
    with h5.File(path, "r") as f, torch.no_grad():
        data = f["data"]
        for lname in data:
            if lname not in params:
                continue
            g = data[lname]
            for i_str in g:
                i = int(i_str)
                if i < len(params[lname]):
                    ref = params[lname][i]
                    ref.copy_(torch.from_numpy(np.asarray(
                        g[i_str], np.float32).reshape(tuple(ref.shape))))


def save_state_hdf5(path, iter_, learned_net, net, history,
                    current_step=0):
    h5 = _h5py()
    with h5.File(path, "w") as f:
        # caffe's hdf5_save_int writes a native (32-bit) int and the
        # learned_net string as fixed-length chars (util/hdf5.cpp)
        f.create_dataset("iter", data=np.int32(iter_))
        f.create_dataset("learned_net",
                         data=np.bytes_(learned_net.encode()
                                        if isinstance(learned_net, str)
                                        else learned_net))
        f.create_dataset("current_step", data=np.int32(current_step))
        g = f.create_group("history")
        for n, (lname, i, s) in enumerate(history_order(net, history)):
            g.create_dataset(str(n), data=_array(history[lname][i][s]))


def load_state_hdf5(path, net, history):
    """Copy the file's history blobs into ``history`` in place;
    -> (iter, learned_net)."""
    h5 = _h5py()
    order = list(history_order(net, history))
    with h5.File(path, "r") as f, torch.no_grad():
        it = int(np.asarray(f["iter"]))
        learned = f["learned_net"][()]
        if isinstance(learned, bytes):
            learned = learned.decode()
        g = f["history"]
        if len(g) != len(order):
            # caffe CHECK_EQ(state_history_size, history_.size()): e.g. a
            # 1-slot SGD state restored into a 2-slot Adam solver
            raise ValueError(
                f"{path}: solver state has {len(g)} history blobs, this "
                f"solver ({len(order)} expected) is a different type — "
                f"restore with the solver type that wrote the snapshot")
        for n, (lname, i, s) in enumerate(order):
            ref = history[lname][i][s]
            ref.copy_(torch.from_numpy(np.asarray(
                g[str(n)], np.float32).reshape(tuple(ref.shape))))
    return it, learned
