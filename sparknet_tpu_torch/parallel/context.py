"""Parallelism context: the axes a layer runs under, the slot it runs
as, and the process-wide host topology (the port of
sparknet_tpu/parallel/context.py).

Layers that can use a mesh axis (Attention's ring mode, PositionalEmbed's
sequence offset, the MoE layer's expert exchange) need to know which
named axes the surrounding solver provides. In the JAX package the
distributed runners publish them before tracing the net body under
shard_map. The port's mesh solvers run the net's layers in lock step
over the slots of a mesh (parallel/lockstep.py): they publish the axes
with ``axis_context`` and, while a slot's layer runs, the slot with
``slot_context``, so a layer reads its own coordinate with
``axis_index``, the counterpart of jax.lax.axis_index.

The host topology is a process-wide constant: one process is one fault
domain, fixed at launch. parallel/multihost.py publishes it once;
everything host-side (heartbeats, coordinated restart, per-host data
slicing, snapshot world stamps) reads it from here.
"""

import contextlib
import threading

_state = threading.local()


def current_axes():
    """Mapping {logical_axis: mesh_axis_name} in effect."""
    return getattr(_state, "axes", {})


@contextlib.contextmanager
def axis_context(**axes):
    """e.g. ``with axis_context(data="data", seq="seq"):`` run the step."""
    prev = current_axes()
    merged = dict(prev)
    merged.update(axes)
    _state.axes = merged
    try:
        yield merged
    finally:
        _state.axes = prev


def axis(name):
    return current_axes().get(name)


def current_slot():
    """(mesh, slot) of the slot whose layer runs now, or None."""
    return getattr(_state, "slot", None)


@contextlib.contextmanager
def slot_context(mesh, slot):
    prev = current_slot()
    _state.slot = (mesh, int(slot))
    try:
        yield
    finally:
        _state.slot = prev


def current_mesh():
    """The SlotMesh the running solver published (None outside one)."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def axis_index(name):
    """This slot's index along the mesh axis bound to logical ``name``
    (0 when unbound or outside a slot)."""
    mesh_axis = axis(name)
    cur = current_slot()
    if mesh_axis is None or cur is None:
        return 0
    mesh, w = cur
    return mesh.axis_index(w, mesh_axis)


_host_topology = None


def publish_host_topology(info):
    """Record this process's host topology. ``info``: a mapping with at
    least process_id / num_processes / local_device_count /
    global_device_count."""
    global _host_topology
    _host_topology = dict(info)
    return _host_topology


def current_host():
    """The published host topology dict, or a single-host default when
    the multi-host runtime never initialized (the common path)."""
    if _host_topology is not None:
        return dict(_host_topology)
    return {"process_id": 0, "num_processes": 1,
            "local_device_count": None, "global_device_count": None}
