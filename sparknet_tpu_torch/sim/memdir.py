"""The in-memory rendezvous directory — the simulated half of the Dir
seam.

Same duck type as resilience.seam.RealDir, over a plain dict. The
semantics RealDir's atomic renames guarantee are trivially true here:
a write is one dict assignment (a reader sees the old record or the new
one, never a torn middle), reads of absent names are None, and globbing
returns sorted names so every consumer iterates deterministically.

Records are stored as the PARSED objects (dicts, ndarray maps) rather
than serialized bytes — that is what makes a 1,000-host fleet cheap
(no json/npz round-trip per beat). Two contracts follow, both already
honored by every writer in resilience/:

  * writers always build a FRESH object per write (heartbeat's beat(),
    the consensus posts) — stored records are never mutated in place;
  * readers treat records as read-only snapshots.

``write_npz``/``load_npz`` store the {key: ndarray} map directly;
``mtime`` is the simulated wall time of the write, which keeps the
ghost-reaper's stamp math meaningful.
"""

import fnmatch


class MemDir:
    def __init__(self, clock, root="mem:fleet"):
        self.clock = clock
        self.root = str(root)
        self._files = {}         # name -> (wall mtime, object)

    def path(self, name):
        """A display-only path (nothing in the sim opens real files)."""
        return f"{self.root}/{name}"

    def glob(self, pattern):
        return sorted(n for n in self._files
                      if fnmatch.fnmatchcase(n, pattern))

    def read_json(self, name):
        rec = self._files.get(name)
        return rec[1] if rec is not None and isinstance(rec[1], dict) \
            else None

    def write_json(self, name, obj):
        self._files[name] = (self.clock.time(), obj)

    def write_npz(self, name, arrays):
        self._files[name] = (self.clock.time(), dict(arrays))

    def load_npz(self, name):
        rec = self._files.get(name)
        return dict(rec[1]) if rec is not None else None

    def exists(self, name):
        return name in self._files

    def remove(self, name):
        return self._files.pop(name, None) is not None

    def mtime(self, name):
        rec = self._files.get(name)
        return rec[0] if rec is not None else None
