"""Pure-Python LevelDB — reader (full DB: SSTables + MANIFEST + WAL) and a
single-table writer, dependency-free (the port's copy of
sparknet_tpu/data/leveldb.py). crc32c and Snappy dispatch to the native
host library (native/) where it builds, as there; the pure-Python codecs
below are the fallback and the executable spec.

The reference opens Datum databases through either backend
(``db.cpp:10-22`` dispatch; ``db_leveldb.cpp:8-19`` with block_size 64 KiB)
and only ever walks a cursor sequentially from the first key
(``data_reader.cpp``), so the contract here is ordered iteration over the
live key space — not point lookups under concurrent writers.

Like `lmdb.py`, this implements the *file format* from the public on-disk
layout (google/leveldb ``doc/table_format.md`` + ``doc/log_format.md`` +
``doc/impl.md``), not by wrapping a native library:

- ``CURRENT`` names the live ``MANIFEST-NNNNNN``; the manifest is a record
  log of VersionEdits that accumulate the set of live ``.ldb``/``.sst``
  table files per level, the active WAL number, and the last sequence.
- Table files are SSTables: 4 KiB-default blocks of prefix-compressed
  key/value entries with a restart array, each block followed by a 5-byte
  trailer (compression type + masked crc32c); an index block maps last-keys
  to block handles; a 48-byte footer holds the metaindex/index handles and
  the magic number. Block compression is Snappy (type 1) or none (type 0);
  a pure-Python Snappy decoder below handles both the literal and all
  three copy element kinds.
- Keys inside tables and the WAL are *internal keys*: user_key + 8-byte
  (sequence<<8 | type) trailer; type 1 = value, 0 = deletion. Iteration
  merges all sources by (key asc, sequence desc) and keeps the newest
  non-deleted version of each key — so partially-compacted DBs read
  correctly.
- A freshly written, never-compacted DB may hold every record only in the
  write-ahead ``.log`` (32 KiB-framed WriteBatch records); the reader
  replays any live WAL into a memtable and merges it like a level.

Checksum verification mirrors ``leveldb::ReadOptions::verify_checksums``
(default off); the writer always emits correct masked crc32c.

The writer produces the minimal valid DB a real leveldb would open: one
level-0 table, a one-edit manifest, CURRENT, and an empty WAL. Entries are
buffered and sorted at close (caffe writes "%08d"-style ascending keys, but
order is not assumed), matching `LMDBWriter`'s buffering contract.
"""

import heapq
import os
import struct

_MAGIC = 0xdb4775248b80fb57
_BLOCK_LOG = 32768          # log_format.md framing block
_HEADER = 7                 # crc(4) + length(2) + type(1)
_FULL, _FIRST, _MIDDLE, _LAST = 1, 2, 3, 4
_TYPE_DELETION, _TYPE_VALUE = 0, 1
_MASK_DELTA = 0xa282ead8
_COMPARATOR = b"leveldb.BytewiseComparator"


# ---------------------------------------------------------------- varints
# shared LEB128 codec (the proto wire codec's — one implementation to fix)
from ..proto.wire import _read_varint as _get_varint  # noqa: E402
from ..proto.wire import _write_varint as _put_varint  # noqa: E402


# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []
_c = 0
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82f63b78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)
del _c, _n


def _crc32c_py(data, crc=0):
    c = crc ^ 0xffffffff
    tab = _CRC_TABLE
    for b in data:
        c = tab[(c ^ b) & 0xff] ^ (c >> 8)
    return c ^ 0xffffffff


def crc32c(data, crc=0):
    # the native kernel (native/pipeline.cpp crc32c_update) wins past a
    # few dozen bytes; the ctypes call itself costs ~1us, so tiny inputs
    # (the 1-byte record-type prefixes) stay in Python
    if len(data) >= 64:
        from .. import native
        c = native.crc32c(data, crc)
        if c is not None:
            return c
    return _crc32c_py(data, crc)


def crc_mask(crc):
    """leveldb stores crcs "masked" so crcs-of-crcs stay well distributed."""
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xffffffff


def crc_unmask(masked):
    rot = (masked - _MASK_DELTA) & 0xffffffff
    return ((rot >> 17) | (rot << 15)) & 0xffffffff


# ---------------------------------------------------------------- snappy

def snappy_decompress(data):
    """Full Snappy format decoder: varint32 length preamble, then literal
    (00), copy-1 (01), copy-2 (10), copy-4 (11) elements; copies may
    overlap their own output (RLE-style) so those run byte-wise.

    Dispatches to the native decoder (native/pipeline.cpp
    snappy_uncompress) when the library is available — the block decode
    is the hot loop of LevelDB streaming; the pure-Python path below is
    the fallback, and the error path with the descriptive diagnostics."""
    n, p = _get_varint(data, 0)
    from .. import native
    out_native = native.snappy_uncompress(data, n)
    if out_native is not None:
        return out_native
    return _snappy_decompress_py(data, n, p)


def _snappy_decompress_py(data, n, p):
    """The pure-Python decoder from the element stream at ``p``, for a
    declared length ``n``."""
    out = bytearray()
    while p < len(data):
        tag = data[p]
        p += 1
        kind = tag & 3
        if kind == 0:                       # literal
            ln = tag >> 2
            if ln >= 60:                    # big literal: length in 1-4 bytes
                nb = ln - 59
                ln = int.from_bytes(data[p:p + nb], "little")
                p += nb
            ln += 1
            out += data[p:p + ln]
            p += ln
            continue
        if kind == 1:                       # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | data[p]
            p += 1
        elif kind == 2:                     # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[p:p + 2], "little")
            p += 2
        else:                               # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[p:p + 4], "little")
            p += 4
        start = len(out) - off
        if off >= ln:                       # disjoint: one slice copy
            out += out[start:start + ln]
        else:                               # overlapping: byte-wise
            for i in range(ln):
                out.append(out[start + i])
    if len(out) != n:
        raise ValueError(f"snappy: got {len(out)} bytes, expected {n}")
    return bytes(out)


def snappy_compress(data):
    """Valid (if unambitious) Snappy: the whole payload as literals. Every
    decoder accepts it; our own DBs exercise the type-1 block path with a
    single fast slice-copy on read."""
    buf = bytearray()
    _put_varint(buf, len(data))
    p = 0
    while p < len(data):
        chunk = data[p:p + (1 << 16)]
        ln = len(chunk) - 1
        if ln < 60:
            buf.append(ln << 2)
        else:
            nb = (ln.bit_length() + 7) // 8
            buf.append((59 + nb) << 2)
            buf += ln.to_bytes(nb, "little")
        buf += chunk
        p += len(chunk)
    return bytes(buf)


# ---------------------------------------------------------------- record log

class LogWriter:
    """log_format.md framing: records fragmented across 32 KiB blocks."""

    def __init__(self, f):
        self.f = f
        self._block_off = 0

    def add_record(self, data):
        data = memoryview(bytes(data))
        first = True
        while True:
            left = _BLOCK_LOG - self._block_off
            if left < _HEADER:
                self.f.write(b"\0" * left)
                self._block_off = 0
                left = _BLOCK_LOG
            avail = left - _HEADER
            frag = data[:avail]
            data = data[len(frag):]
            end = len(data) == 0
            t = (_FULL if first and end else _FIRST if first
                 else _LAST if end else _MIDDLE)
            crc = crc_mask(crc32c(frag, crc32c(bytes([t]))))
            self.f.write(struct.pack("<IHB", crc, len(frag), t))
            self.f.write(frag)
            self._block_off += _HEADER + len(frag)
            first = False
            if end:
                return


def log_records(data, verify=False):
    """Yield whole records from log-framed bytes (a MANIFEST or WAL)."""
    pending = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        block_left = _BLOCK_LOG - (pos % _BLOCK_LOG)
        if block_left < _HEADER:
            pos += block_left            # trailer padding
            continue
        if pos + _HEADER > n:
            return                       # truncated tail (crashed writer)
        crc, length, t = struct.unpack_from("<IHB", data, pos)
        if t == 0 and length == 0:
            pos += block_left            # zero-fill: pre-allocated space
            continue
        frag = data[pos + _HEADER:pos + _HEADER + length]
        if len(frag) < length:
            return                       # truncated record
        if verify and crc_unmask(crc) != crc32c(frag, crc32c(bytes([t]))):
            raise ValueError(f"log record crc mismatch at offset {pos}")
        pos += _HEADER + length
        if t == _FULL:
            yield bytes(frag)
        elif t == _FIRST:
            pending = bytearray(frag)
        elif t == _MIDDLE:
            pending += frag
        elif t == _LAST:
            pending += frag
            yield bytes(pending)
            pending = bytearray()
        else:
            raise ValueError(f"bad log record type {t}")


# ---------------------------------------------------------------- blocks

def _block_entries(data):
    """Prefix-compressed entries of one (decompressed) block."""
    if len(data) < 4:
        return
    num_restarts = struct.unpack_from("<I", data, len(data) - 4)[0]
    end = len(data) - 4 - 4 * num_restarts
    p = 0
    key = b""
    while p < end:
        shared, p = _get_varint(data, p)
        non_shared, p = _get_varint(data, p)
        vlen, p = _get_varint(data, p)
        key = key[:shared] + data[p:p + non_shared]
        p += non_shared
        yield key, data[p:p + vlen]
        p += vlen


class _BlockBuilder:
    def __init__(self, restart_interval=16):
        self.buf = bytearray()
        self.restarts = [0]
        self.interval = restart_interval
        self.count = 0
        self.last_key = b""

    def add(self, key, value):
        shared = 0
        if self.count % self.interval == 0:
            if self.count:
                self.restarts.append(len(self.buf))
        else:
            m = min(len(key), len(self.last_key))
            while shared < m and key[shared] == self.last_key[shared]:
                shared += 1
        _put_varint(self.buf, shared)
        _put_varint(self.buf, len(key) - shared)
        _put_varint(self.buf, len(value))
        self.buf += key[shared:]
        self.buf += value
        self.last_key = key
        self.count += 1

    def finish(self):
        out = bytearray(self.buf)
        restarts = self.restarts if self.count else [0]
        for r in restarts:
            out += struct.pack("<I", r)
        out += struct.pack("<I", len(restarts))
        return bytes(out)

    def __len__(self):
        return len(self.buf)


# ---------------------------------------------------------------- tables

def _read_block(data, offset, size, verify=False):
    raw = data[offset:offset + size]
    ctype = data[offset + size]
    if verify:
        # block crcs cover contents then the type byte, in write order
        stored = struct.unpack_from("<I", data, offset + size + 1)[0]
        if crc_unmask(stored) != crc32c(bytes([ctype]), crc32c(raw)):
            raise ValueError(f"block crc mismatch at {offset}")
    if ctype == 1:
        return snappy_decompress(raw)
    return bytes(raw)


def table_entries(data, verify=False):
    """Yield (internal_key, value) from an SSTable's bytes, in key order."""
    if len(data) < 48 or \
            struct.unpack("<Q", data[-8:])[0] != _MAGIC:
        raise ValueError("not an SSTable (bad footer magic)")
    p = len(data) - 48
    _mi_off, p = _get_varint(data, p)
    _mi_size, p = _get_varint(data, p)
    ix_off, p = _get_varint(data, p)
    ix_size, p = _get_varint(data, p)
    index = _read_block(data, ix_off, ix_size, verify)
    for _key, handle in _block_entries(index):
        off, q = _get_varint(handle, 0)
        size, q = _get_varint(handle, q)
        yield from _block_entries(_read_block(data, off, size, verify))


def _table_versions(path, verify=False):
    """[(user_key, seq, vtype, value)] from one table file, key order."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    for ikey, value in table_entries(data, verify):
        tag = struct.unpack("<Q", ikey[-8:])[0]
        out.append((ikey[:-8], tag >> 8, tag & 0xff, value))
    return out


class _TableWriter:
    def __init__(self, f, block_size=4096, compress=True):
        self.f = f
        self.block_size = block_size
        self.compress = compress
        self.block = _BlockBuilder()
        self.index = []                 # (last_key, offset, size)
        self.offset = 0
        self.first_key = self.last_key = None

    def add(self, ikey, value):
        if self.first_key is None:
            self.first_key = ikey
        self.last_key = ikey
        self.block.add(ikey, value)
        if len(self.block) >= self.block_size:
            self._flush()

    def _write_block(self, contents):
        if self.compress:
            payload, ctype = snappy_compress(contents), 1
        else:
            payload, ctype = contents, 0
        crc = crc_mask(crc32c(bytes([ctype]), crc32c(payload)))
        self.f.write(payload)
        self.f.write(struct.pack("<BI", ctype, crc))
        handle = (self.offset, len(payload))
        self.offset += len(payload) + 5
        return handle

    def _flush(self):
        if not self.block.count:
            return
        handle = self._write_block(self.block.finish())
        self.index.append((self.block.last_key, handle))
        self.block = _BlockBuilder()

    def finish(self):
        self._flush()
        meta_handle = self._write_block(_BlockBuilder().finish())
        ixb = _BlockBuilder(restart_interval=1)
        for last_key, (off, size) in self.index:
            hv = bytearray()
            _put_varint(hv, off)
            _put_varint(hv, size)
            ixb.add(last_key, bytes(hv))
        index_handle = self._write_block(ixb.finish())
        footer = bytearray()
        for v in (*meta_handle, *index_handle):
            _put_varint(footer, v)
        footer += b"\0" * (40 - len(footer))
        footer += struct.pack("<Q", _MAGIC)
        self.f.write(footer)
        return self.offset + 48


# ---------------------------------------------------------------- manifest

def _decode_version_edit(rec):
    """VersionEdit tags we act on: 2 log_number, 6 deleted file,
    7 new file; the other standard tags (1,3,4,5,9) are parsed and
    skipped. Truly unknown tags raise: varint-framed records can't be
    skipped without knowing their field structure, and guessing would
    silently corrupt every later field in the edit — matching leveldb's
    own VersionEdit::DecodeFrom, which also rejects unknown tags
    (version_edit.cc). Notably tag 8 (kLargeValueRef, removed pre-1.0)
    is rejected here just as it is upstream."""
    p = 0
    out = {"new": [], "deleted": [], "log_number": None}
    while p < len(rec):
        tag, p = _get_varint(rec, p)
        if tag == 1:                     # comparator name
            n, p = _get_varint(rec, p)
            p += n
        elif tag == 2:
            out["log_number"], p = _get_varint(rec, p)
        elif tag == 9:                   # prev log number
            _, p = _get_varint(rec, p)
        elif tag == 3:                   # next file number
            _, p = _get_varint(rec, p)
        elif tag == 4:                   # last sequence
            _, p = _get_varint(rec, p)
        elif tag == 5:                   # compact pointer
            _, p = _get_varint(rec, p)
            n, p = _get_varint(rec, p)
            p += n
        elif tag == 6:
            level, p = _get_varint(rec, p)
            num, p = _get_varint(rec, p)
            out["deleted"].append((level, num))
        elif tag == 7:
            level, p = _get_varint(rec, p)
            num, p = _get_varint(rec, p)
            _size, p = _get_varint(rec, p)
            n, p = _get_varint(rec, p)
            p += n                       # smallest internal key
            n, p = _get_varint(rec, p)
            p += n                       # largest internal key
            out["new"].append((level, num))
        else:
            raise ValueError(
                f"unknown VersionEdit tag {tag} (varint framing makes "
                f"unknown tags unskippable; is this DB from a forked or "
                f"pre-1.0 leveldb?)")
    return out


def _encode_version_edit(log_number, next_file, last_seq, new_files):
    buf = bytearray()
    _put_varint(buf, 1)
    _put_varint(buf, len(_COMPARATOR))
    buf += _COMPARATOR
    _put_varint(buf, 2)
    _put_varint(buf, log_number)
    _put_varint(buf, 3)
    _put_varint(buf, next_file)
    _put_varint(buf, 4)
    _put_varint(buf, last_seq)
    for level, num, size, smallest, largest in new_files:
        _put_varint(buf, 7)
        _put_varint(buf, level)
        _put_varint(buf, num)
        _put_varint(buf, size)
        _put_varint(buf, len(smallest))
        buf += smallest
        _put_varint(buf, len(largest))
        buf += largest
    return bytes(buf)


# ---------------------------------------------------------------- reader

class LevelDBReader:
    """Ordered iteration over a LevelDB directory. API mirrors LMDBReader:
    items()/keys()/get()/len()/close(), context manager, iter."""

    def __init__(self, path, verify_checksums=False):
        self.path = path
        self.verify = verify_checksums
        cur = os.path.join(path, "CURRENT")
        with open(cur) as f:
            manifest = f.read().strip()
        with open(os.path.join(path, manifest), "rb") as f:
            mdata = f.read()
        files = {}                      # (level, num) -> True
        log_number = 0
        for rec in log_records(mdata, verify=self.verify):
            edit = _decode_version_edit(rec)
            if edit["log_number"] is not None:
                log_number = edit["log_number"]
            for lv_num in edit["deleted"]:
                files.pop(lv_num, None)
            for lv_num in edit["new"]:
                files[lv_num] = True
        self._tables = []
        for level, num in sorted(files):
            for ext in (".ldb", ".sst"):
                p = os.path.join(path, f"{num:06d}{ext}")
                if os.path.exists(p):
                    self._tables.append(p)
                    break
            else:
                raise FileNotFoundError(
                    f"{path}: live table {num:06d} missing")
        # WALs at least as new as the manifest's log_number hold memtable
        # entries not yet in any table (impl.md recovery)
        self._memtable = {}
        for fn in sorted(os.listdir(path)):
            if fn.endswith(".log"):
                try:
                    num = int(fn.split(".")[0])
                except ValueError:
                    continue
                if num >= log_number:
                    self._replay_wal(os.path.join(path, fn))
        self._decoded = None
        self._cacheable = None
        self._len = None

    def _replay_wal(self, path):
        with open(path, "rb") as f:
            data = f.read()
        for rec in log_records(data, verify=self.verify):
            seq = struct.unpack_from("<Q", rec, 0)[0]
            count = struct.unpack_from("<I", rec, 8)[0]
            p = 12
            for i in range(count):
                vtype = rec[p]
                p += 1
                klen, p = _get_varint(rec, p)
                key = rec[p:p + klen]
                p += klen
                value = b""
                if vtype == _TYPE_VALUE:
                    vlen, p = _get_varint(rec, p)
                    value = rec[p:p + vlen]
                    p += vlen
                old = self._memtable.get(key)
                if old is None or old[0] <= seq + i:
                    self._memtable[key] = (seq + i, vtype, value)

    def _sources(self):
        # table files are immutable, so decode each once and iterate the
        # cached version lists on every items() pass (a Datum source walks
        # the whole DB once per epoch; re-decompressing per pass would
        # dominate the input pipeline). The cache is bounded: DBs whose
        # table files exceed SPARKNET_LEVELDB_CACHE_MB (default 1024)
        # re-decode per pass instead of pinning the dataset in host RAM.
        if self._decoded is None and self._cacheable is None:
            budget = float(os.environ.get("SPARKNET_LEVELDB_CACHE_MB",
                                          "1024")) * (1 << 20)
            self._cacheable = sum(
                os.path.getsize(p) for p in self._tables) <= budget
        if self._decoded is None and self._cacheable:
            self._decoded = [_table_versions(p, self.verify)
                             for p in self._tables]
        if self._decoded is not None:
            srcs = [iter(t) for t in self._decoded]
        else:
            srcs = [iter(_table_versions(p, self.verify))
                    for p in self._tables]
        if self._memtable:
            srcs.append(iter(sorted(
                (k, s, t, v) for k, (s, t, v) in self._memtable.items())))
        return srcs

    def items(self):
        """(key, value) in key order — newest live version of each key."""
        merged = heapq.merge(*self._sources(),
                             key=lambda e: (e[0], -e[1]))
        prev = None
        for key, _seq, vtype, value in merged:
            if key == prev:
                continue                 # older version shadowed
            prev = key
            if vtype == _TYPE_VALUE:
                yield key, value

    def keys(self):
        for k, _ in self.items():
            yield k

    def get(self, key):
        if isinstance(key, str):
            key = key.encode()
        for k, v in self.items():
            if k == key:
                return v
            if k > key:
                return None
        return None

    def __len__(self):
        if self._len is None:
            self._len = sum(1 for _ in self.items())
        return self._len

    def close(self):
        self._memtable = {}
        self._tables = []
        self._decoded = None
        self._cacheable = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self.items()


# ---------------------------------------------------------------- writer

class LevelDBWriter:
    """Buffering writer producing a minimal real DB: one level-0 table
    (000005.ldb), MANIFEST-000004 + CURRENT, and an empty WAL 000006.log.
    put() order is preserved as sequence order; keys sort at close."""

    def __init__(self, path, block_size=4096, compress=True):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.block_size = block_size
        self.compress = compress
        self._entries = []
        self._closed = False

    def put(self, key, value):
        if self._closed:
            raise ValueError("put() on a closed LevelDBWriter")
        if isinstance(key, str):
            key = key.encode()
        if isinstance(value, str):
            value = value.encode()
        self._entries.append((bytes(key), bytes(value)))

    def close(self):
        # idempotent: an explicit close() followed by the context
        # manager's __exit__ (or any double close) must not rewrite the
        # DB from the now-empty entry list
        if self._closed:
            return
        self._closed = True
        seq = {}
        for i, (k, _) in enumerate(self._entries):
            seq[k] = i + 1               # later puts shadow earlier ones
        versions = sorted(
            ((k, seq[k], v) for i, (k, v) in enumerate(self._entries)
             if seq[k] == i + 1),
            key=lambda e: (e[0], -e[1]))
        table_path = os.path.join(self.path, "000005.ldb")
        with open(table_path, "wb") as f:
            tw = _TableWriter(f, self.block_size, self.compress)
            for k, s, v in versions:
                tw.add(k + struct.pack("<Q", (s << 8) | _TYPE_VALUE), v)
            size = tw.finish()
        smallest = tw.first_key or b""
        largest = tw.last_key or b""
        last_seq = len(self._entries)
        edit = _encode_version_edit(
            log_number=6, next_file=7, last_seq=last_seq,
            new_files=[(0, 5, size, smallest, largest)] if versions else [])
        with open(os.path.join(self.path, "MANIFEST-000004"), "wb") as f:
            LogWriter(f).add_record(edit)
        with open(os.path.join(self.path, "000006.log"), "wb"):
            pass
        tmp = os.path.join(self.path, "CURRENT.tmp")
        with open(tmp, "w") as f:
            f.write("MANIFEST-000004\n")
        os.replace(tmp, os.path.join(self.path, "CURRENT"))
        self._entries = []

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
