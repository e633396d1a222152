"""Process-wide host topology (the host-topology half of
sparknet_tpu/parallel/context.py).

One process is one fault domain, fixed at launch. parallel/multihost.py
publishes the topology once; everything host-side (heartbeats,
coordinated restart, per-host data slicing, snapshot world stamps) reads
it from here. The JAX module's trace-time axis and world contexts have no
counterpart: the port's solvers loop over their slots in Python, and no
layer is traced.
"""

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
