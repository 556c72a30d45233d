"""A read-only OCDBT key-value store (tensorstore's "Optionally-Cooperative
Distributed B+Tree"), in Python and numpy.

orbax keeps the arrays of the JAX package's `state.orbax` in one: a
`manifest.ocdbt` at the top whose B+tree refers to the data each process
wrote under `ocdbt.process_<i>/` (its own manifest and `d/` files), and
`d/` files of its own. The layout, as tensorstore writes it:

  * A manifest or B+tree node is an encoded blob: a 4-byte big-endian magic
    (0x0cdb3a2a manifest, 0x0cdb20de node), the blob's length (uint64 LE),
    varints for the format version and its compression (0 none, 1 zstd),
    the payload, and the CRC-32C (uint32 LE) of everything before it.
  * A manifest's payload: the config (a 16-byte uuid, varints for the
    manifest kind, the inline-value and node-size limits, a byte for the
    version tree's arity log2, a varint for the compression method and, for
    zstd, an int32 LE level), a data-file table, then the newest versions:
    a count n and arrays of n generation numbers, root heights (bytes),
    root locations (data file, offset, length), statistics (three varints)
    and commit times (uint64 LE). Older versions sit in version-tree nodes
    that a reader of the newest state does not need.
  * A data-file table: a count n, n - 1 prefix lengths (shared with the
    previous path), n suffix lengths, n base-path lengths, the suffixes. A
    file's path is its base path, after the base path of the file the table
    was read from, then the rest.
  * A node's payload: its height (a byte), a data-file table, the entry
    count n, n - 1 key prefix lengths, n key suffix lengths, in an interior
    node n subtree common-prefix lengths, then the suffixes. A leaf then
    holds n value lengths, n value kinds (0 inline, 1 in a data file), the
    data file and offset of each out-of-line value, and the inline values.
    An interior node then holds n child locations and n child statistics; a
    child's keys follow the first common-prefix-length bytes of its entry's
    key.

`OcdbtStore(path)` reads the manifest and walks the newest root once;
`keys()` and `read(key)` serve from what it found. A bad magic, a bad
checksum or a truncated blob raises `ValueError` naming the file.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from . import zstd

MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE


def _crc32c_table():
    poly = 0x82F63B78
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table[i] = c
    return table.tolist()


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli), table-driven."""
    table = _CRC_TABLE
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, what: str):
        raise ValueError(f"{self.where}: {what}")

    def byte(self) -> int:
        if self.pos >= len(self.data):
            self.fail("truncated")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail("truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint too long")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]


def _decode_blob(blob: bytes, magic: int, where: str) -> _Reader:
    """Check an encoded manifest or node and return a reader of its payload."""
    if len(blob) < 18:
        raise ValueError(f"{where}: truncated ({len(blob)} bytes)")
    got_magic, length = struct.unpack_from(">I", blob)[0], struct.unpack_from("<Q", blob, 4)[0]
    if got_magic != magic:
        raise ValueError(f"{where}: bad magic {got_magic:#010x} (expected {magic:#010x})")
    if length != len(blob):
        raise ValueError(f"{where}: truncated ({len(blob)} of {length} bytes)")
    if crc32c(blob[:-4]) != struct.unpack_from("<I", blob, len(blob) - 4)[0]:
        raise ValueError(f"{where}: bad checksum")
    r = _Reader(blob[:-4], where)
    r.pos = 12
    r.varint()  # format version
    compression = r.varint()
    if compression == 1:
        try:
            return _Reader(zstd.decompress(blob[r.pos:-4]), where)
        except ValueError as e:
            raise ValueError(f"{where}: {e}") from e
    if compression != 0:
        r.fail(f"unknown compression format {compression}")
    return _Reader(blob[r.pos:-4], where)


def _data_file_table(r: _Reader, base: str) -> list:
    """-> [(base path, full path)] of each data file."""
    n = r.varint()
    if n == 0:
        return []
    prefix = r.varints(n - 1)
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        path = (prev[:prefix[i - 1]] if i else b"") + r.take(suffix[i])
        if base_len[i] > len(path):
            r.fail("data file base path longer than its path")
        text = path.decode()
        files.append((base + text[:base_len[i]], base + text))
        prev = path
    return files


def _file_ref(r: _Reader, files: list, n: int):
    ids = r.varints(n)
    if any(i >= len(files) for i in ids):
        r.fail("data file index out of range")
    return [files[i] for i in ids]


class OcdbtStore:
    """The newest state of the OCDBT store under `path`."""

    def __init__(self, path):
        self.root = Path(path)
        self._values = {}
        self._files = {}
        where = str(self.root / "manifest.ocdbt")
        r = _decode_blob(self._file("manifest.ocdbt"), MANIFEST_MAGIC, where)
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            r.fail(f"manifest kind {kind} (numbered manifests are not read)")
        r.varints(2)  # inline-value and node-size limits
        r.byte()  # version tree arity log2
        if r.varint() == 1:
            r.take(4)  # zstd level
        files = _data_file_table(r, "")
        n = r.varint()
        if n == 0:
            return  # an empty store
        generations = r.varints(n)
        heights = [r.byte() for _ in range(n)]
        locations = list(zip(_file_ref(r, files, n), r.varints(n), r.varints(n)))
        newest = int(np.argmax(generations))
        self._walk(locations[newest], heights[newest], b"")

    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            path = self.root / rel
            try:
                self._files[rel] = path.read_bytes()
            except FileNotFoundError:
                raise ValueError(f"{path}: missing OCDBT file") from None
        return self._files[rel]

    def _slice(self, ref, offset: int, length: int) -> bytes:
        data = self._file(ref[1])
        if offset + length > len(data):
            raise ValueError(f"{self.root / ref[1]}: truncated ({len(data)} bytes, "
                             f"{offset + length} needed)")
        return data[offset:offset + length]

    def _walk(self, location, height: int, prefix: bytes):
        ref, offset, length = location
        where = f"{self.root / ref[1]} at {offset}"
        r = _decode_blob(self._slice(ref, offset, length), NODE_MAGIC, where)
        if r.byte() != height:
            r.fail(f"node height differs from its parent's reference ({height})")
        files = _data_file_table(r, ref[0])
        n = r.varint()
        keys_prefix = r.varints(n - 1) if n else []
        keys_suffix = r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            prev = (prev[:keys_prefix[i - 1]] if i else b"") + r.take(keys_suffix[i])
            keys.append(prefix + prev)
        if height == 0:
            lengths = r.varints(n)
            kinds = r.varints(n)
            out_of_line = [i for i, k in enumerate(kinds) if k == 1]
            if any(k > 1 for k in kinds):
                r.fail("unknown value kind")
            refs = _file_ref(r, files, len(out_of_line))
            offsets = r.varints(len(out_of_line))
            for i, f, o in zip(out_of_line, refs, offsets):
                self._values[keys[i]] = (f, o, lengths[i])
            for i, k in enumerate(kinds):
                if k == 0:
                    self._values[keys[i]] = r.take(lengths[i])
        else:
            children = list(zip(_file_ref(r, files, n), r.varints(n), r.varints(n)))
            r.varints(3 * n)  # statistics
            for key, c, child in zip(keys, common, children):
                self._walk(child, height - 1, key[:len(prefix) + c])
        if r.pos != len(r.data):
            r.fail("trailing bytes in node")

    def keys(self) -> list:
        """Every key, sorted, as str."""
        return sorted(k.decode() for k in self._values)

    def read(self, key: str) -> bytes:
        """The value of `key`; KeyError where it is absent."""
        value = self._values[key.encode()]
        return value if isinstance(value, bytes) else self._slice(*value)
