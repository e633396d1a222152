"""The injectable time + rendezvous-directory seam.

Every control-plane module in resilience/ used to reach straight for
``time.time()`` / ``time.sleep()`` and the filesystem. That hard wiring
made two things impossible:

  * simulating the control plane — the fleet simulator (sim/) drives
    the REAL HeartbeatCoordinator / ElasticPolicy / Router code against
    a discrete-event clock and an in-memory rendezvous directory, so a
    whole serving fleet runs minutes of traffic in seconds on one CPU;
  * surviving a wall-clock step — lease freshness computed as
    ``time.time() - stamp`` mass-expires every peer the instant NTP
    steps the clock backward past lease_s (or a laptop resumes from
    suspend). Duration/deadline arithmetic belongs on the MONOTONIC
    clock; only the human-readable stamps written to disk stay wall.

This module is the seam's REAL half — the defaults that keep production
behavior bit-identical:

  Clock    wall time (``time``), ``monotonic``, and ``sleep`` — the
           three time primitives the protocol code is allowed to use.
  RealDir  name-based file ops over one rendezvous directory, writes
           routed through the checkpoint layer's atomic helpers
           (tmp + fsync + os.replace), reads
           tolerant of torn/absent files.

The simulated half (sim/clock.SimClock, sim/memdir.MemDir) implements
the same two duck types; heartbeat.py never knows which it got.
"""

import glob as _glob
import json
import os
import time

import numpy as np

from .checkpoint import atomic_write_bytes, atomic_write_json


class Clock:
    """Wall-clock default for the time seam.

    time()       wall seconds (for on-disk stamps other PROCESSES
                 compare against their own wall clock — human-readable,
                 and the only cross-process time base a shared
                 directory offers)
    monotonic()  this process's monotonic seconds — ALL duration and
                 deadline arithmetic (lease ages, gate deadlines,
                 consensus timeouts) happens here, so an NTP step or a
                 suspend/resume can never mass-expire leases
    sleep(s)     blocks this thread (the simulator's clock instead
                 advances virtual time and drains due events)
    """

    def time(self):
        return time.time()

    def monotonic(self):
        return time.monotonic()

    def sleep(self, seconds):
        time.sleep(seconds)


#: shared default instance — coordinators without an injected clock use
#: the process wall/monotonic clock (bit-identical to the pre-seam code)
WALL_CLOCK = Clock()


def read_json_file(path):
    """Parse a JSON object file, or None — a torn write must read as
    absent, not an error (rendezvous writers re-write within one
    heartbeat interval)."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError):
        return None
    return obj if isinstance(obj, dict) else None


class RealDir:
    """Name-based atomic file ops over one rendezvous directory — the
    on-disk default for the Dir seam. All names are basenames inside
    ``root``; globbing returns sorted basenames so every consumer
    iterates deterministically. Writes are atomic renames (a reader
    sees the old file or the new one, never a torn middle); reads
    return None for absent/torn files."""

    def __init__(self, root):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def path(self, name):
        return os.path.join(self.root, name)

    def glob(self, pattern):
        root = _glob.escape(self.root)
        return sorted(os.path.basename(p)
                      for p in _glob.glob(os.path.join(root, pattern)))

    def read_json(self, name):
        return read_json_file(self.path(name))

    def write_json(self, name, obj):
        atomic_write_json(self.path(name), obj)

    def write_npz(self, name, arrays):
        """``arrays``: {key: ndarray}. Atomic like write_json."""
        atomic_write_bytes(self.path(name),
                           lambda f: np.savez(f, **arrays))

    def load_npz(self, name):
        """{key: ndarray} fully materialized, or None (absent/torn)."""
        try:
            with np.load(self.path(name)) as z:
                return {k: z[k] for k in z.files}
        except (OSError, ValueError, KeyError):
            return None

    def exists(self, name):
        return os.path.exists(self.path(name))

    def remove(self, name):
        """True when this call removed the file (False: already gone —
        a concurrent peer won the race, which is never an error in the
        rendezvous protocol)."""
        try:
            os.remove(self.path(name))
        except OSError:
            return False
        return True

    def mtime(self, name):
        try:
            return os.path.getmtime(self.path(name))
        except OSError:
            return None
