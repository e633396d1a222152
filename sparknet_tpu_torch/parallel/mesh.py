"""Slot meshes and the slot collectives (the port of
sparknet_tpu/parallel/mesh.py).

The JAX package names its parallelism strategies by the axes of a
device mesh: "data" (gradient pmean), "model" (tensor parallelism), "seq"
(ring/Ulysses attention), "expert" (MoE all_to_all), "pipe" (GPipe) and
"host" (fault domains). The port trains on one card, so a mesh axis of W
devices is W *slots* on it: a SlotMesh names the axes and their sizes,
numbers the slots row-major over them (the layout of
``np.array(devices).reshape(sizes)``), and the solvers loop over the
slots in Python.

Every collective the JAX package issues inside shard_map becomes a
tensor operation across the slots of one mesh axis, here and nowhere
else: ``psum``, ``pmean``, ``all_gather``, ``psum_scatter``,
``ppermute`` and ``all_to_all`` take one tensor per slot of the mesh (a
list in slot order) and return one per slot, each reduction taken over
the slots that differ only along the named axis (the axis "group").
They are ordinary differentiable PyTorch operations, so autograd
carries each one's transpose (psum's is the identity on every member,
ppermute's the reverse shift, all_to_all's the reverse exchange) across
the slots of one graph. A multi-card version puts NCCL behind these six
functions.

sparknet_tpu/parallel/compat.py, a JAX-version shim for shard_map, has no
counterpart: there is no shard_map here.
"""

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
HOST_AXIS = "host"


class SlotMesh:
    """Named axes over slots of one card: ``shape`` {axis: size} in axis
    order (JAX's ``mesh.shape``), ``size`` the slot count; slot ``w``'s
    coordinates are the row-major digits of w."""

    def __init__(self, axes):
        self.shape = {str(k): int(v) for k, v in axes.items()}
        for k, v in self.shape.items():
            if v < 1:
                raise ValueError(f"mesh axis {k!r} has size {v}")
        self.axis_names = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))

    def __repr__(self):
        return f"SlotMesh({self.shape})"

    def coords(self, w):
        """{axis: index} of slot ``w``."""
        out = {}
        for name in reversed(self.axis_names):
            w, out[name] = divmod(w, self.shape[name])
        return {k: out[k] for k in self.axis_names}

    def axis_index(self, w, axis):
        return self.coords(w)[axis] if axis in self.shape else 0

    def groups(self, axis):
        """The slot lists one collective over ``axis`` reduces within:
        slots equal on every other axis, each list in ``axis`` order.
        An axis the mesh lacks makes every slot its own group."""
        if axis not in self.shape:
            return [[w] for w in range(self.size)]
        out = {}
        for w in range(self.size):
            c = self.coords(w)
            key = tuple(v for k, v in c.items() if k != axis)
            out.setdefault(key, []).append(w)
        return list(out.values())


def make_mesh(axes=None):
    """A SlotMesh from {axis: size}. A single -1 size takes the card's one
    device, so it has one slot (the JAX package infers it from the device
    count). Default: one "data" slot."""
    axes = dict(axes or {DATA_AXIS: -1})
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    return SlotMesh({k: 1 if int(v) == -1 else int(v)
                     for k, v in axes.items()})


def make_tp_mesh(tp):
    """The (data, model) mesh of the tensor-parallel lever (``--tp N``):
    "model" gets ``tp`` slots, "data" the card's one device."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"need tp >= 1, got {tp}")
    return make_mesh({DATA_AXIS: -1, MODEL_AXIS: tp})


def mesh_axis_size(mesh, axis):
    shape = mesh.shape if hasattr(mesh, "shape") else dict(mesh)
    return int(shape[axis]) if axis in shape else 1


def local_batch_slice(global_batch_size, mesh=None, axis=DATA_AXIS):
    """(start, size) of this process's slice of the global batch: each
    process of a multi-process run loads only its own rows."""
    from .multihost import process_count, process_index
    pcount, pid = process_count(), process_index()
    if global_batch_size % pcount:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {pcount} hosts")
    per = global_batch_size // pcount
    return pid * per, per


# -- the slot collectives ----------------------------------------------------
def _check(xs, mesh):
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} tensors for a mesh of {mesh.size} "
                         "slots")


def psum(xs, mesh, axis):
    """Each slot gets the sum over its ``axis`` group (one tensor shared
    by the group's slots), summed in axis order."""
    _check(xs, mesh)
    out = [None] * mesh.size
    for g in mesh.groups(axis):
        total = xs[g[0]]
        for w in g[1:]:
            total = total + xs[w]
        for w in g:
            out[w] = total
    return out


def pmean(xs, mesh, axis):
    n = mesh_axis_size(mesh, axis)
    return [x / n for x in psum(xs, mesh, axis)] if n > 1 else list(xs)


def all_gather(xs, mesh, axis, dim=0):
    """Tiled all_gather: every slot gets its group's tensors concatenated
    along ``dim`` in axis order."""
    _check(xs, mesh)
    out = [None] * mesh.size
    for g in mesh.groups(axis):
        full = torch.cat([xs[w] for w in g], dim) if len(g) > 1 else xs[g[0]]
        for w in g:
            out[w] = full
    return out


def psum_scatter(xs, mesh, axis, dim=0):
    """Tiled reduce-scatter: the group's sum, cut into as many blocks
    along ``dim`` as the group has slots; slot i of the group keeps
    block i."""
    _check(xs, mesh)
    out = [None] * mesh.size
    for g in mesh.groups(axis):
        total = xs[g[0]]
        for w in g[1:]:
            total = total + xs[w]
        for w, blk in zip(g, torch.chunk(total, len(g), dim)):
            out[w] = blk
    return out


def ppermute(xs, mesh, axis, shift=1):
    """Slot i of each group gets the tensor of slot (i - shift) mod n: the
    ring rotation jax.lax.ppermute with perm [(i, i + shift)] makes."""
    _check(xs, mesh)
    out = [None] * mesh.size
    for g in mesh.groups(axis):
        n = len(g)
        for i, w in enumerate(g):
            out[w] = xs[g[(i - shift) % n]]
    return out


def all_to_all(xs, mesh, axis, split_dim, concat_dim):
    """Tiled all_to_all: each slot cuts its tensor into n blocks along
    ``split_dim``; slot j of the group gets block j of every member,
    concatenated along ``concat_dim`` in axis order."""
    _check(xs, mesh)
    out = [None] * mesh.size
    for g in mesh.groups(axis):
        n = len(g)
        if xs[g[0]].shape[split_dim] % n:
            raise ValueError(
                f"all_to_all: dim {split_dim} of {tuple(xs[g[0]].shape)} "
                f"does not divide over {n} slots")
        blocks = [torch.chunk(xs[w], n, split_dim) for w in g]
        for j, w in enumerate(g):
            out[w] = torch.cat([blocks[i][j] for i in range(n)],
                               concat_dim) if n > 1 else blocks[0][0]
    return out


def slot_rows(n, parts, index):
    """[lo, hi) of block ``index`` when ``n`` rows split in ``parts``."""
    if n % parts:
        raise ValueError(f"{n} not divisible by {parts}")
    blk = n // parts
    return index * blk, (index + 1) * blk
