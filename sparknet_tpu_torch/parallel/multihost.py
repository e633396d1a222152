"""Multi-host runtime: process topology, fault-domain slot grids, shrink
(the port of sparknet_tpu/parallel/multihost.py).

The host is the real failure unit: preemption, OOM-kill and network
partitions take out whole processes. The topology comes from the JAX
package's variables:

  SPARKNET_NUM_PROCESSES   the world's process count (unset: one)
  SPARKNET_PROCESS_ID      this process's index
  SPARKNET_COORDINATOR     accepted and recorded in the topology; the
                           port has no coordination service to reach

The port has no collective across processes yet (ROADMAP A5b brings one
over several cards), so ``needs_host_relay()`` is True whenever more than
one process runs: the tau-interval cross-host average then goes through
the rendezvous directory (resilience.heartbeat.FileConsensus), the JAX
package's rule for a backend without cross-process collectives. Each
process trains its own fault domain — one row of the (host, data) slot
grid — and the relay supplies the consensus.

  init_runtime()      read the variables, check them, publish the
                      topology (parallel/context.py)
  SlotGrid            the (host, data) grid of worker slots: one row per
                      fault domain, each row owned by one process
  host_mesh()         the grid for a hosts x per_host partition (virtual
                      fault domains in one process: how the tests and
                      one-card runs exercise the two-tier path)
  auto_host_mesh()    this process's one-row grid when the relay is
                      needed, the whole grid otherwise
  survivor_mesh()     the grid rebuilt over the LIVE host rows
  my_host_rows(), local_batch_rows()
                      the rows this process feeds and its slice of a
                      slot-major batch
  exit_if_peers_died()
                      exit without waiting on processes that are gone
"""

import os

from . import context

HOST_AXIS = "host"
DATA_AXIS = "data"


def _env_int(name):
    v = os.environ.get(name)
    if v is None or v == "":
        return None
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: want an integer") from None


def process_count():
    """The world's process count: the published topology's, else
    SPARKNET_NUM_PROCESSES, else 1."""
    topo = context.current_host()
    if context._host_topology is not None:
        return int(topo["num_processes"])
    return max(1, _env_int("SPARKNET_NUM_PROCESSES") or 1)


def process_index():
    """This process's index: the published topology's, else
    SPARKNET_PROCESS_ID, else 0."""
    if context._host_topology is not None:
        return int(context.current_host()["process_id"])
    return _env_int("SPARKNET_PROCESS_ID") or 0


def needs_host_relay():
    """True when the cross-host tier cannot run as an in-program
    collective: the port has none across processes (until ROADMAP A5b),
    so any world of more than one process relays its tau-interval
    average through the rendezvous directory."""
    return process_count() > 1


def _local_devices():
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.device_count(), "cuda"
    except Exception:
        pass
    return 1, "cpu"


def init_runtime(coordinator_address=None, num_processes=None,
                 process_id=None):
    """Read (or take) the world's process count, this process's index
    and the coordinator address, check them, and publish the topology.
    Idempotent; a single-process run publishes the trivial one-host
    topology. Returns the topology dict."""
    coordinator_address = coordinator_address or os.environ.get(
        "SPARKNET_COORDINATOR")
    n = num_processes if num_processes is not None else \
        _env_int("SPARKNET_NUM_PROCESSES")
    pid = process_id if process_id is not None else \
        _env_int("SPARKNET_PROCESS_ID")
    n = int(n or 1)
    pid = int(pid or 0)
    if n < 1 or not 0 <= pid < n:
        raise ValueError(f"process id {pid} outside a world of {n} "
                         "process(es) (SPARKNET_PROCESS_ID, "
                         "SPARKNET_NUM_PROCESSES)")
    return publish_topology(n, pid, coordinator_address)


def publish_topology(num_processes=None, process_id=None, coordinator=None):
    """Publish this process's host topology through parallel/context.py
    (defaults: what process_count() and process_index() read)."""
    n = process_count() if num_processes is None else int(num_processes)
    pid = process_index() if process_id is None else int(process_id)
    local, platform = _local_devices()
    return context.publish_host_topology({
        "process_id": pid, "num_processes": n,
        "local_device_count": local, "global_device_count": None,
        "platform": platform, "coordinator": coordinator})


class SlotGrid:
    """The (host, data) grid of worker slots: ``hosts`` rows of
    ``per_host`` slots, row h owned by process ``owners[h]``. ``shape``
    is the JAX mesh's shape ({"host": H, "data": per_host}), the world a
    snapshot is stamped with."""

    def __init__(self, hosts, per_host, owners=None):
        self.hosts, self.per_host = int(hosts), int(per_host)
        if self.hosts < 1 or self.per_host < 1:
            raise ValueError(f"slot grid {hosts}x{per_host}: want at least "
                             "one host of one slot")
        self.owners = list(owners) if owners is not None else \
            [process_index()] * self.hosts
        if len(self.owners) != self.hosts:
            raise ValueError(f"{len(self.owners)} row owners for "
                             f"{self.hosts} hosts")

    @property
    def shape(self):
        return {HOST_AXIS: self.hosts, DATA_AXIS: self.per_host}

    @property
    def slots(self):
        return self.hosts * self.per_host

    def is_local(self):
        """Every row owned by this process: rounds over it never wait on
        another process."""
        me = process_index()
        return all(o == me for o in self.owners)

    def __repr__(self):
        return f"SlotGrid({self.hosts}x{self.per_host}, owners={self.owners})"


def host_mesh(hosts=None, per_host=None, device_axis=DATA_AXIS):
    """The (host, data) slot grid: ``hosts`` rows (default: the process
    count) of ``per_host`` slots (default 1). In one process every row
    is this process's: virtual fault domains."""
    del device_axis         # the port's one slot axis is "data"
    hosts = process_count() if hosts is None else int(hosts)
    return SlotGrid(hosts, per_host or 1)


def auto_host_mesh(hosts=None, per_host=None, device_axis=DATA_AXIS):
    """The right grid for this runtime: this process's one row when the
    cross-host tier relays through the rendezvous directory
    (needs_host_relay), the whole grid otherwise."""
    if needs_host_relay():
        return SlotGrid(1, per_host or 1, owners=[process_index()])
    return host_mesh(hosts, per_host, device_axis)


def survivor_mesh(mesh, live_hosts, device_axis=None):
    """The grid rebuilt over the LIVE host rows. When only this
    process's rows survive the result is local (SlotGrid.is_local)."""
    del device_axis
    live = sorted(int(h) for h in live_hosts)
    if not live:
        raise ValueError("no live hosts to rebuild a grid over")
    return SlotGrid(len(live), mesh.per_host,
                    owners=[mesh.owners[h] for h in live])


def my_host_rows(mesh):
    """Host rows of ``mesh`` this process owns — the rows it feeds
    (one in a multi-process run; all of them in one process)."""
    me = process_index()
    return [h for h, o in enumerate(mesh.owners) if o == me]


def local_batch_rows(global_batch, mesh):
    """(start, size) of this process's contiguous slice of a batch axis
    laid out slot-major over (host, data): host h's slots hold blocks
    [h*per_host, (h+1)*per_host)."""
    slots = mesh.slots
    if global_batch % slots:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{slots} slots")
    per_slot = global_batch // slots
    rows = my_host_rows(mesh)
    if not rows:
        raise ValueError("this process owns no host row of the grid")
    if rows != list(range(rows[0], rows[0] + len(rows))):
        raise ValueError(f"this process's host rows {rows} are not "
                         "contiguous on the host axis")
    return (rows[0] * mesh.per_host * per_slot,
            len(rows) * mesh.per_host * per_slot)


def exit_if_peers_died(rc, heartbeat):
    """Exit with code ``rc`` at once, skipping interpreter teardown,
    when the heartbeat layer saw a peer host die this run: nothing at
    exit may wait on a process that is gone, and the supervisor contract
    is the run's exit code. No-op (returns) in one process or when no
    host ever died."""
    if heartbeat is None or process_count() <= 1:
        return
    try:
        dead = heartbeat.ever_dead()
    except Exception:
        dead = None
    if not dead:
        return
    import sys
    print(f"multihost: peer host(s) {sorted(dead)} died this run; "
          f"exiting {rc}", flush=True)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


__all__ = ["init_runtime", "publish_topology", "host_mesh",
           "survivor_mesh", "my_host_rows", "local_batch_rows",
           "HOST_AXIS", "DATA_AXIS", "SlotGrid", "needs_host_relay",
           "auto_host_mesh", "exit_if_peers_died", "process_count",
           "process_index"]
