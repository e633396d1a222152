"""Pure-Python LMDB (Lightning Memory-Mapped Database) reader and writer
(the port's copy of sparknet_tpu/data/lmdb.py).

The reference trains its stock prototxts from LMDB databases of serialized
``Datum`` records (reference caffe/src/caffe/util/db_lmdb.cpp:1-35 opens the
env read-only and walks a cursor; layers/data_layer.cpp:14-60 consumes the
cursor sequentially, wrapping at the end). This module implements the LMDB
*file format* directly — a memory-mapped B+tree — so the same databases are
readable (and writable, for ``convert_imageset``-style tools and test
fixtures) with no native liblmdb dependency.

Format notes (byte layout of lmdb's mdb.c, little-endian, 64-bit):

  page header (16 bytes)          meta page body (after header)
    0  u64 pgno                      0  u32 magic     = 0xBEEFC0DE
    8  u16 pad                       4  u32 version   = 1
    10 u16 flags                     8  u64 fixed-map address
    12 u16 lower | u32 n_overflow   16  u64 mapsize
    14 u16 upper                    24  MDB_db[2] (FREE, MAIN; 48 B each)
                                   120  u64 last_pg
  MDB_db (48 bytes)                128  u64 txnid
    0  u32 pad (FREE slot: psize)
    4  u16 flags    6  u16 depth
    8  u64 branch_pages   16 u64 leaf_pages   24 u64 overflow_pages
    32 u64 entries        40 u64 root (0xFFFF.. = empty)

  node (8-byte header at even offsets; page ptr array after page header,
  nodes allocated downward from `upper`):
    0 u16 lo   2 u16 hi   4 u16 flags   6 u16 ksize   8 key...
    branch: child pgno = lo | hi<<16 | flags<<32, data none
    leaf:   datasize   = lo | hi<<16; flags & 0x01 (BIGDATA) -> key is
            followed by a u64 pgno of an overflow page run; else by data.
  overflow page run: first page has header {pgno, flags=0x04, n_overflow};
    payload starts at byte 16 and runs contiguously across the whole span.

The two meta pages (pgno 0, 1) alternate by txnid; readers take the one
with the larger txnid. Caffe databases store keys like "00042" /
"00000042_name.jpg" — lexicographically ordered, which the bulk writer
below requires (it builds the tree bottom-up in one pass).
"""

import mmap
import os
import struct

_MAGIC = 0xBEEFC0DE
_VERSION = 1
_P_INVALID = 0xFFFFFFFFFFFFFFFF

_P_BRANCH = 0x01
_P_LEAF = 0x02
_P_OVERFLOW = 0x04
_P_META = 0x08
_P_LEAF2 = 0x20

_F_BIGDATA = 0x01
_F_DUPDATA = 0x04

_PAGEHDRSZ = 16
_NODESZ = 8

_page_hdr = struct.Struct("<QHHHH")          # pgno, pad, flags, lower, upper
_node_hdr = struct.Struct("<HHHH")           # lo, hi, flags, ksize
_db_rec = struct.Struct("<IHHQQQQQ")         # pad, flags, depth, branch,
                                             # leaf, overflow, entries, root
_meta_hdr = struct.Struct("<IIQQ")           # magic, version, address, mapsize


def _data_path(path):
    """An LMDB "database" is a directory holding data.mdb (the default
    MDB_NOSUBDIR-less layout caffe uses); accept the file itself too."""
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


class LMDBError(ValueError):
    pass


class LMDBReader:
    """Read-only cursor over one LMDB file's MAIN database.

    Usage::

        with LMDBReader("examples/cifar10/cifar10_train_lmdb") as db:
            for key, value in db.items():
                ...
    """

    def __init__(self, path):
        self.path = _data_path(path)
        self._f = open(self.path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:
            self._f.close()
            raise LMDBError(f"{self.path}: empty or unmappable file")
        self._read_meta()

    # -- structure ---------------------------------------------------------

    def _read_meta(self):
        best = None
        for pgno in (0, 1):
            off = pgno * 4096  # meta pages are at file start regardless of
            # psize: page 1 lives at offset psize, but psize is only known
            # from meta 0 — read meta 0 first, then meta 1 at its true spot.
            if pgno == 1:
                off = self._psize
            hdr = self._mm[off:off + _PAGEHDRSZ]
            if len(hdr) < _PAGEHDRSZ:
                continue
            _, _, flags, _, _ = _page_hdr.unpack(hdr)
            if not flags & _P_META:
                raise LMDBError(f"{self.path}: page {pgno} is not a meta page")
            body = self._mm[off + _PAGEHDRSZ:off + _PAGEHDRSZ + 136]
            magic, version, _, mapsize = _meta_hdr.unpack(body[:24])
            if magic != _MAGIC:
                raise LMDBError(f"{self.path}: bad magic {magic:#x}")
            if version != _VERSION:
                raise LMDBError(f"{self.path}: unsupported version {version}")
            free = _db_rec.unpack(body[24:72])
            main = _db_rec.unpack(body[72:120])
            last_pg, txnid = struct.unpack("<QQ", body[120:136])
            if pgno == 0:
                self._psize = free[0] or 4096
            if best is None or txnid >= best[0]:
                best = (txnid, main, last_pg)
        if best is None:
            raise LMDBError(f"{self.path}: no valid meta page")
        self.txnid, main, self.last_pg = best
        (_, self.db_flags, self.depth, self.branch_pages, self.leaf_pages,
         self.overflow_pages, self.entries, self.root) = main

    def _page(self, pgno):
        off = pgno * self._psize
        if off + self._psize > len(self._mm):
            raise LMDBError(f"{self.path}: page {pgno} beyond EOF")
        return off

    def _page_nodes(self, off):
        """Yield node offsets of a branch/leaf page at file offset `off`."""
        _, _, flags, lower, upper = _page_hdr.unpack(
            self._mm[off:off + _PAGEHDRSZ])
        n = (lower - _PAGEHDRSZ) >> 1
        ptrs = struct.unpack("<%dH" % n,
                             self._mm[off + _PAGEHDRSZ:off + _PAGEHDRSZ
                                      + 2 * n])
        return flags, [off + p for p in ptrs]

    def _leaf_value(self, noff):
        lo, hi, flags, ksize = _node_hdr.unpack(self._mm[noff:noff + _NODESZ])
        key = bytes(self._mm[noff + _NODESZ:noff + _NODESZ + ksize])
        dsize = lo | (hi << 16)
        if flags & _F_DUPDATA:
            raise LMDBError("dupsort databases are not supported")
        if flags & _F_BIGDATA:
            (ovpg,) = struct.unpack(
                "<Q", self._mm[noff + _NODESZ + ksize:
                               noff + _NODESZ + ksize + 8])
            ooff = self._page(ovpg)
            _, _, oflags, pages_lo, pages_hi = _page_hdr.unpack(
                self._mm[ooff:ooff + _PAGEHDRSZ])
            if not oflags & _P_OVERFLOW:
                raise LMDBError(f"page {ovpg}: expected overflow page")
            start = ooff + _PAGEHDRSZ
            value = bytes(self._mm[start:start + dsize])
        else:
            start = noff + _NODESZ + ksize
            value = bytes(self._mm[start:start + dsize])
        return key, value

    # -- public API --------------------------------------------------------

    def __len__(self):
        return self.entries

    def items(self):
        """Yield (key, value) bytes pairs in key order (a full cursor walk,
        db_lmdb.cpp LMDBCursor::Next equivalent)."""
        if self.root == _P_INVALID:
            return
        stack = [self.root]
        # depth-first, left-to-right; branch children pushed reversed
        while stack:
            off = self._page(stack.pop())
            flags, nodes = self._page_nodes(off)
            if flags & _P_LEAF2:
                raise LMDBError("MDB_DUPFIXED leaf2 pages not supported")
            if flags & _P_BRANCH:
                kids = []
                for noff in nodes:
                    lo, hi, nflags, _ = _node_hdr.unpack(
                        self._mm[noff:noff + _NODESZ])
                    kids.append(lo | (hi << 16) | (nflags << 32))
                stack.extend(reversed(kids))
            elif flags & _P_LEAF:
                for noff in nodes:
                    yield self._leaf_value(noff)
            else:
                raise LMDBError(f"unexpected page flags {flags:#x}")

    def keys(self):
        for k, _ in self.items():
            yield k

    def get(self, key):
        """Point lookup by binary search down the tree."""
        if isinstance(key, str):
            key = key.encode()
        if self.root == _P_INVALID:
            return None
        pgno = self.root
        for _ in range(self.depth + 1):
            off = self._page(pgno)
            flags, nodes = self._page_nodes(off)
            if flags & _P_BRANCH:
                # find rightmost child whose separator <= key; node 0's key
                # is empty by convention (always <= key)
                chosen = None
                for noff in nodes:
                    lo, hi, nflags, ksize = _node_hdr.unpack(
                        self._mm[noff:noff + _NODESZ])
                    sep = bytes(self._mm[noff + _NODESZ:
                                         noff + _NODESZ + ksize])
                    child = lo | (hi << 16) | (nflags << 32)
                    if ksize == 0 or sep <= key:
                        chosen = child
                    else:
                        break
                pgno = chosen
            elif flags & _P_LEAF:
                for noff in nodes:
                    k, v = self._leaf_value(noff)
                    if k == key:
                        return v
                return None
            else:
                raise LMDBError(f"unexpected page flags {flags:#x}")
        raise LMDBError("tree deeper than declared depth")

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self.items()


class LMDBWriter:
    """Single-pass bulk writer: collects records, builds the B+tree
    bottom-up on close. Keys must be unique; they are sorted on close, so
    insertion order is free (caffe's sequential "%05d"/"%08d_..." keys are
    already sorted). The resulting file is a valid single-txn LMDB env."""

    def __init__(self, path, psize=4096):
        self.dir = path
        self.psize = psize
        self.nodemax = (((psize - _PAGEHDRSZ) // 2) & ~1) - 2  # mdb.c
        self._items = []
        self._closed = False

    def put(self, key, value):
        if isinstance(key, str):
            key = key.encode()
        if isinstance(value, str):
            value = value.encode()
        if len(key) > 511:  # mdb_env_get_maxkeysize default
            raise LMDBError(f"key too long ({len(key)} > 511)")
        self._items.append((bytes(key), bytes(value)))

    # -- tree construction -------------------------------------------------

    def _new_page(self):
        """Returns (pgno, buf). buf is psize bytes, header filled on seal."""
        buf = bytearray(self.psize)
        self._pages.append(buf)
        return len(self._pages) + 1, buf  # pgnos 0,1 are the metas

    def _seal(self, buf, pgno, flags, ptrs_nodes):
        """Write header + ptr array + nodes (already placed)."""
        lower = _PAGEHDRSZ + 2 * len(ptrs_nodes)
        upper = min(ptrs_nodes) if ptrs_nodes else self.psize
        _page_hdr.pack_into(buf, 0, pgno, 0, flags, lower, upper)
        struct.pack_into("<%dH" % len(ptrs_nodes), buf, _PAGEHDRSZ,
                         *ptrs_nodes)

    def _build_level(self, entries, leaf):
        """Pack (key, payload) entries into pages; returns [(pgno, firstkey)].

        leaf payloads are either (b"data", None) inline or (None, ovpgno,
        dsize) for big data; branch payloads are child pgnos."""
        out = []
        page_nodes = []   # (key, node_bytes)
        used = 0

        def flush():
            nonlocal page_nodes, used
            if not page_nodes:
                return
            pgno, buf = self._new_page()
            ptrs = []
            top = self.psize
            for key, nb in page_nodes:
                top -= len(nb) + (len(nb) & 1)  # EVEN alignment
                buf[top:top + len(nb)] = nb
                ptrs.append(top)
            self._seal(buf, pgno, _P_LEAF if leaf else _P_BRANCH, ptrs)
            self._stat["leaf" if leaf else "branch"] += 1
            out.append((page_nodes[0][0], pgno))
            page_nodes, used = [], 0

        for i, (key, payload) in enumerate(entries):
            if leaf:
                kind = payload[0]
                if kind == "inline":
                    data = payload[1]
                    nb = _node_hdr.pack(len(data) & 0xFFFF, len(data) >> 16,
                                        0, len(key)) + key + data
                else:  # overflow
                    ovpg, dsize = payload[1], payload[2]
                    nb = _node_hdr.pack(dsize & 0xFFFF, dsize >> 16,
                                        _F_BIGDATA, len(key)) + key \
                        + struct.pack("<Q", ovpg)
            else:
                child = payload
                k = b"" if not page_nodes else key  # node 0 key is empty
                nb = _node_hdr.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                                    (child >> 32) & 0xFFFF, len(k)) + k
            need = 2 + len(nb) + (len(nb) & 1)
            if page_nodes and _PAGEHDRSZ + used + need > self.psize:
                flush()
                if not leaf:
                    # re-encode with empty node-0 key for the new page
                    k = b""
                    nb = _node_hdr.pack(child & 0xFFFF,
                                        (child >> 16) & 0xFFFF,
                                        (child >> 32) & 0xFFFF, len(k)) + k
                    need = 2 + len(nb) + (len(nb) & 1)
            page_nodes.append((key, nb))
            used += need
        flush()
        return out

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._items.sort(key=lambda kv: kv[0])
        for i in range(1, len(self._items)):
            if self._items[i][0] == self._items[i - 1][0]:
                raise LMDBError(
                    f"duplicate key {self._items[i][0]!r}")
        self._pages = []
        self._stat = {"leaf": 0, "branch": 0, "overflow": 0}

        # leaves (+ overflow runs as encountered)
        leaf_entries = []
        for key, value in self._items:
            if _NODESZ + len(key) + len(value) > self.nodemax:
                npages = (_PAGEHDRSZ + len(value) + self.psize - 1) \
                    // self.psize
                first_buf = bytearray(self.psize)
                self._pages.append(first_buf)
                ovpg = len(self._pages) + 1
                # overflow header: pgno, flags=P_OVERFLOW, page count in the
                # 32-bit field that aliases lower/upper
                struct.pack_into("<QHHI", first_buf, 0, ovpg, 0,
                                 _P_OVERFLOW, npages)
                span = bytearray()
                span += value[:self.psize - _PAGEHDRSZ]
                first_buf[_PAGEHDRSZ:_PAGEHDRSZ + len(span)] = span
                rest = value[self.psize - _PAGEHDRSZ:]
                for p in range(1, npages):
                    b = bytearray(self.psize)
                    chunk = rest[(p - 1) * self.psize:p * self.psize]
                    b[:len(chunk)] = chunk
                    self._pages.append(b)
                self._stat["overflow"] += npages
                leaf_entries.append((key, ("big", ovpg, len(value))))
            else:
                leaf_entries.append((key, ("inline", value)))

        depth = 0
        root = _P_INVALID
        if leaf_entries:
            # each level is [(first_key_of_subtree, pgno)], built bottom-up
            level = self._build_level(leaf_entries, leaf=True)
            depth = 1
            while len(level) > 1:
                level = self._build_level(level, leaf=False)
                depth += 1
            root = level[0][1]

        last_pg = len(self._pages) + 1
        file_pages = last_pg + 1
        mapsize = file_pages * self.psize

        meta = bytearray(self.psize)
        main = _db_rec.pack(0, 0, depth, self._stat["branch"],
                            self._stat["leaf"], self._stat["overflow"],
                            len(self._items), root)
        free = _db_rec.pack(self.psize, 0, 0, 0, 0, 0, 0, _P_INVALID)
        body = _meta_hdr.pack(_MAGIC, _VERSION, 0, mapsize) + free + main \
            + struct.pack("<QQ", last_pg, 1)
        meta[_PAGEHDRSZ:_PAGEHDRSZ + len(body)] = body

        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, "data.mdb"), "wb") as f:
            for pgno in (0, 1):
                m = bytearray(meta)
                _page_hdr.pack_into(m, 0, pgno, 0, _P_META, 0, 0)
                f.write(m)
            f.write(b"".join(bytes(p) for p in self._pages))
        # lock.mdb exists in every real env dir; readers ignore its content
        lock = os.path.join(self.dir, "lock.mdb")
        if not os.path.exists(lock):
            open(lock, "wb").close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
