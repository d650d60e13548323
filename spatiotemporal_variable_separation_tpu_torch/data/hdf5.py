"""HDF5 files without h5py: the reader and writer of the TaxiBJ and SST corpora.

The JAX package reads TaxiBJ's ``BJ{13..16}_M32x32_T30_InOut.h5`` and SST's
``data_{zone}.nc`` (netCDF-4, which is HDF5 underneath) with h5py, and its
stand-in generators write them with h5py.  The port reads and writes them
with this module instead (numpy and the standard library), so the same code
runs wherever the port does.  Its format is the HDF Group's *HDF5 File Format
Specification Version 3.0*.

Reader: ``open(path)`` gives the root group, a mapping (``name in g``,
``g[name]``, ``"a/b"`` paths, ``with``).  A dataset has ``shape``, ``dtype``
and ``attrs``; ``ds[()]`` reads all of it, ``ds[i]`` one index of the first
axis.  Arrays come back as h5py returns them, dtype and byte order
included.  It covers:

* superblocks v0-v3; object headers v1 and v2 with continuation blocks;
* groups: symbol tables (v1 B-tree, local heap, ``SNOD``), compact links,
  and dense links (link info -> fractal heap, read through its v2 B-tree
  name index);
* datatypes: fixed-point of 1-8 bytes, IEEE floats of 2, 4 and 8 bytes (both
  byte orders), fixed-length strings;
* dataspaces: scalar and simple;
* data layouts: compact, contiguous (one ``np.fromfile`` at its offset) and
  chunked, indexed by a v1 B-tree (layout v3) or, in layout v4, by a single
  chunk, an implicit index, a fixed array or an extensible array;
* filters: deflate, shuffle and fletcher32 (checked); chunks never written
  read as the fill value;
* attributes: messages v1-v3 in the header and dense storage (attribute
  info -> fractal heap).  Numeric and fixed-string attributes decode as h5py
  gives them; any other attribute is listed by name and raises when read.

Anything else raises ``HDF5Error`` naming the file, the object's path and
the feature (``filter 32000 (lzf)``, ``datatype class 9
(variable-length)``, ``v2 B-tree chunk index``), as does a truncated file.

Writer: ``write(path, {name: (array, attrs)})`` writes what ``h5py.File(path,
"w")``, ``create_dataset(name, data=array)`` and ``d.attrs[k] = v`` write
under HDF5 1.14 with h5py's defaults, byte for byte, for the files the
stand-in corpora make: superblock v0, an old-style root group, v1 object
headers, contiguous numeric or fixed-string arrays and numeric scalar
attributes.  It refuses what it would lay out differently from libhdf5.
"""

from __future__ import annotations

import io
import os
import zlib
from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                6: "scaleoffset", 307: "bzip2", 32000: "lzf", 32001: "blosc", 32004: "lz4",
                32008: "bitshuffle", 32013: "zfp", 32015: "zstd"}
CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string", 4: "bitfield",
               5: "opaque", 6: "compound", 7: "reference", 8: "enumerated",
               9: "variable-length", 10: "array"}

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _FILTERS, _ATTRIBUTE = 0x6, 0x7, 0x8, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15
_KNOWN = {0x0, 0x1, 0x2, 0x3, 0x4, 0x5, 0x6, 0x7, 0x8, 0xA, 0xB, 0xC, 0xD, 0xE, 0xF,
          0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18}

#: IEEE layouts (size, exponent location, exponent size, mantissa size, bias)
_IEEE = {(2, 10, 5, 10, 15), (4, 23, 8, 23, 127), (8, 52, 11, 52, 1023)}


class HDF5Error(OSError):
    """A file this module cannot read: truncated, malformed, or using a
    feature it does not cover.  The message names the file, the object's
    path and the feature."""


def _u(b, pos: int, n: int) -> int:
    return int.from_bytes(b[pos:pos + n], "little")


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _log2(n: int) -> int:
    """floor(log2(n)) for n > 0 (libhdf5's H5VM_log2_gen)."""
    return n.bit_length() - 1


class _File:
    """An open HDF5 file: its superblock's sizes and reads at addresses."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self.f = io.open(self.path, "rb")
        try:
            self.size = os.fstat(self.f.fileno()).st_size
            self._superblock()
        except BaseException:
            self.f.close()
            raise

    def fail(self, obj: str, what: str):
        raise HDF5Error(f"{self.path}: {obj}: {what}")

    def read(self, addr: int, n: int, obj: str = "/") -> bytes:
        start = self.base + addr
        if start < 0 or start + n > self.size:
            self.fail(obj, f"truncated file: needs bytes {start}..{start + n} of {self.size}")
        self.f.seek(start)
        return self.f.read(n)

    def undefined(self, addr: int) -> bool:
        return addr == (1 << (8 * self.O)) - 1

    def _superblock(self):
        at = 0
        while True:  # the superblock sits at 0 or after a user block of 512 * 2^k
            self.f.seek(at)
            if self.f.read(8) == SIGNATURE:
                break
            at = 512 if at == 0 else at * 2
            if at + 8 > self.size:
                self.fail("/", "not an HDF5 file (no superblock signature)")
        self.base = 0
        head = self.read(at, 256 if at + 256 <= self.size else self.size - at)
        version = head[8]
        if version in (0, 1):
            self.O, self.L = head[13], head[14]
            pos = 24 + (4 if version == 1 else 0)
            base = _u(head, pos, self.O)
            eof = _u(head, pos + 2 * self.O, self.O)
            entry = pos + 4 * self.O  # the root group's symbol table entry
            self.root = _u(head, entry + self.O, self.O)
        elif version in (2, 3):
            self.O, self.L = head[9], head[10]
            base = _u(head, 12, self.O)
            eof = _u(head, 12 + 2 * self.O, self.O)
            self.root = _u(head, 12 + 3 * self.O, self.O)
        else:
            self.fail("/", f"superblock version {version}")
        if self.O not in (2, 4, 8) or self.L not in (2, 4, 8):
            self.fail("/", f"sizes of offsets {self.O} and lengths {self.L}")
        self.base = base
        if base + eof > self.size:
            self.fail("/", f"truncated file: {self.size} bytes, the superblock says {base + eof}")

    def close(self):
        self.f.close()


class _Message:
    __slots__ = ("type", "flags", "data", "order")

    def __init__(self, type_, flags, data, order):
        self.type, self.flags, self.data, self.order = type_, flags, data, order


class _Header:
    """An object header (v1 or v2) and its continuation blocks, parsed into
    messages."""

    def __init__(self, file: _File, addr: int, path: str):
        self.file, self.path = file, path
        self.messages: List[_Message] = []
        sig = file.read(addr, 4, path)
        if sig == b"OHDR":
            self._v2(addr)
        elif sig[0] == 1:
            self._v1(addr)
        else:
            file.fail(path, f"object header version {sig[0]}")
        for m in self.messages:
            if m.type not in _KNOWN and m.flags & 0x80:
                file.fail(path, f"header message type {m.type} marked must-understand")

    def _v1(self, addr: int):
        prefix = self.file.read(addr, 16, self.path)
        chunks = [(addr + 16, _u(prefix, 8, 4))]
        while chunks:
            start, length = chunks.pop(0)
            buf = self.file.read(start, length, self.path)
            pos = 0
            while pos + 8 <= length:
                t, size, flags = _u(buf, pos, 2), _u(buf, pos + 2, 2), buf[pos + 4]
                data = buf[pos + 8:pos + 8 + size]
                if len(data) < size:
                    self.file.fail(self.path, "object header message runs past its chunk")
                self._add(t, flags, data, None, chunks)
                pos += 8 + size

    def _v2(self, addr: int):
        head = self.file.read(addr, 6, self.path)
        if head[4] != 2:
            self.file.fail(self.path, f"object header version {head[4]}")
        flags = head[5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        n = 1 << (flags & 3)
        size0 = _u(self.file.read(addr + pos, n, self.path), 0, n)
        order_bytes = 2 if flags & 0x04 else 0
        chunks = [(addr + pos + n, size0)]
        first = True
        while chunks:
            start, length = chunks.pop(0)
            if first:
                buf, first = self.file.read(start, length, self.path), False
            else:  # "OCHK", messages, checksum
                raw = self.file.read(start, length, self.path)
                if raw[:4] != b"OCHK":
                    self.file.fail(self.path, "continuation block without its OCHK signature")
                buf = raw[4:-4]
            pos, end = 0, len(buf)
            hdr = 4 + order_bytes
            while pos + hdr <= end:
                t, size, mflags = buf[pos], _u(buf, pos + 1, 2), buf[pos + 3]
                order = _u(buf, pos + 4, 2) if order_bytes else None
                data = buf[pos + hdr:pos + hdr + size]
                if len(data) < size:
                    self.file.fail(self.path, "object header message runs past its chunk")
                self._add(t, mflags, data, order, chunks)
                pos += hdr + size

    def _add(self, t, flags, data, order, chunks):
        if t == _CONTINUATION:
            O, L = self.file.O, self.file.L
            chunks.append((_u(data, 0, O), _u(data, O, L)))
        elif t != _NIL:
            self.messages.append(_Message(t, flags, data, order))

    def all(self, t: int) -> List[_Message]:
        return [m for m in self.messages if m.type == t]

    def first(self, t: int) -> Optional[bytes]:
        """The data of the first message of type ``t`` (a shared message
        resolved), or None."""
        for m in self.messages:
            if m.type == t:
                return _unshare(self.file, m.data, t, self.path) if m.flags & 0x02 else m.data
        return None


def _unshare(file: _File, data: bytes, t: int, path: str) -> bytes:
    """A shared message's own data, from the object header it lives in."""
    version, kind = data[0], data[1]
    if version == 1:
        addr = _u(data, 8, file.O)
    elif version == 2 or (version == 3 and kind == 2):
        addr = _u(data, 2, file.O)
    else:
        file.fail(path, "shared message in the shared-object heap")
    target = _Header(file, addr, path).first(t)
    if target is None:
        file.fail(path, f"shared message of type {t} not found at {addr}")
    return target


# -- datatypes and dataspaces -------------------------------------------------
class _Type:
    """A decoded datatype: the numpy dtype h5py gives and, for strings, the
    padding h5py's conversion undoes."""

    def __init__(self, dtype: np.dtype, pad: Optional[int] = None):
        self.dtype, self.pad = dtype, pad

    def fix(self, arr: np.ndarray) -> np.ndarray:
        """Strings as h5py's null-padded memory type holds them: the bytes
        after a string's first NUL (or its trailing spaces, space-padded)
        become NULs."""
        if self.pad is None or arr.size == 0:
            return arr
        b = arr.reshape(-1).view(np.uint8).reshape(arr.size, self.dtype.itemsize)
        if self.pad == 2:
            keep = np.cumsum((b != 0x20)[:, ::-1], axis=1)[:, ::-1] > 0
        else:
            keep = np.cumsum(b == 0, axis=1) == 0
        b[~keep] = 0
        return arr


def _datatype(file: _File, data: bytes, path: str) -> _Type:
    cls = data[0] & 0x0F
    bits = data[1] | (data[2] << 8) | (data[3] << 16)
    size = _u(data, 4, 4)
    if cls == 0:
        offset, precision = _u(data, 8, 2), _u(data, 10, 2)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            file.fail(path, f"fixed-point datatype of {size} bytes, {precision} bits at {offset}")
        order = ">" if bits & 1 else "<"
        return _Type(np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"))
    if cls == 1:
        if bits & 0x40:
            file.fail(path, "VAX-order floating-point datatype")
        offset, precision = _u(data, 8, 2), _u(data, 10, 2)
        eloc, esize, mloc, msize = data[12], data[13], data[14], data[15]
        bias = _u(data, 16, 4)
        if (offset, precision, mloc) != (0, 8 * size, 0) or \
                (size, eloc, esize, msize, bias) not in _IEEE:
            file.fail(path, f"floating-point datatype of {size} bytes that is not IEEE")
        return _Type(np.dtype(f"{'>' if bits & 1 else '<'}f{size}"))
    if cls == 3:
        pad, charset = bits & 0x0F, (bits >> 4) & 0x0F
        if pad > 2 or charset > 1:
            file.fail(path, f"string datatype with padding {pad}, character set {charset}")
        return _Type(np.dtype(f"S{size}"), pad)
    file.fail(path, f"datatype class {cls} ({CLASS_NAMES.get(cls, 'unknown')})")


def _dataspace(file: _File, data: bytes, path: str
               ) -> Tuple[Optional[Tuple[int, ...]], Optional[Tuple[Optional[int], ...]]]:
    """(shape, maxshape); shape None for a null dataspace."""
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        pos = 8
    elif version == 2:
        pos = 4
        if data[3] == 2:
            return None, None
    else:
        file.fail(path, f"dataspace message version {version}")
    L = file.L
    shape = tuple(_u(data, pos + L * i, L) for i in range(rank))
    maxshape = shape
    if flags & 1:
        unlimited = (1 << (8 * L)) - 1
        maxshape = tuple(None if v == unlimited else v
                         for v in (_u(data, pos + L * (rank + i), L) for i in range(rank)))
    return shape, maxshape


# -- heaps and B-trees ----------------------------------------------------------
def _local_heap_names(file: _File, addr: int, path: str):
    head = file.read(addr, 8 + 2 * file.L + file.O, path)
    if head[:4] != b"HEAP":
        file.fail(path, "local heap without its HEAP signature")
    size = _u(head, 8, file.L)
    data = file.read(_u(head, 8 + 2 * file.L, file.O), size, path)

    def name(offset: int) -> str:
        end = data.index(b"\0", offset)
        return data[offset:end].decode("utf-8", "surrogateescape")
    return name


def _v1_btree(file: _File, addr: int, node_type: int, key_size: int, path: str
              ) -> Iterator[Tuple[bytes, int]]:
    """(key, child address) of every leaf entry of a v1 B-tree; the key is
    the one before the child."""
    O = file.O
    head = file.read(addr, 8 + 2 * O, path)
    if head[:4] != b"TREE" or head[4] != node_type:
        file.fail(path, f"v1 B-tree node of type {head[4]} where {node_type} was expected")
    level, entries = head[5], _u(head, 6, 2)
    body = file.read(addr + 8 + 2 * O, entries * (key_size + O) + key_size, path)
    for i in range(entries):
        pos = i * (key_size + O)
        key, child = body[pos:pos + key_size], _u(body, pos + key_size, O)
        if level == 0:
            yield key, child
        else:
            yield from _v1_btree(file, child, node_type, key_size, path)


def _symbol_table_links(file: _File, data: bytes, path: str) -> Dict[str, int]:
    O = file.O
    name = _local_heap_names(file, _u(data, O, O), path)
    links = {}
    for _, snod in _v1_btree(file, _u(data, 0, O), 0, file.L, path):
        head = file.read(snod, 8, path)
        if head[:4] != b"SNOD":
            file.fail(path, "symbol table node without its SNOD signature")
        count, entry = _u(head, 6, 2), 2 * O + 24
        body = file.read(snod + 8, count * entry, path)
        for i in range(count):
            links[name(_u(body, i * entry, O))] = _u(body, i * entry + O, O)
    return links


def _v2_btree_records(file: _File, addr: int, path: str) -> Iterator[bytes]:
    """Every record of a v2 B-tree, in key order."""
    O, L = file.O, file.L
    head = file.read(addr, 16 + O + 2 + L + 4, path)
    if head[:4] != b"BTHD":
        file.fail(path, "v2 B-tree header without its BTHD signature")
    node_size, rec_size, depth = _u(head, 6, 4), _u(head, 10, 2), _u(head, 12, 2)
    root, root_n = _u(head, 16, O), _u(head, 16 + O, 2)
    # the widths of the child-count fields, as libhdf5's H5B2__hdr_init sets them
    max_leaf = (node_size - 10) // rec_size
    nrec_size = _log2(max_leaf) // 8 + 1
    cum_max, cum_size = [max_leaf], [0]
    for d in range(1, depth + 1):
        ptr = O + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_int = (node_size - (10 + ptr)) // (rec_size + ptr)
        cum_max.append((max_int + 1) * cum_max[d - 1] + max_int)
        cum_size.append(_log2(cum_max[d]) // 8 + 1)

    def node(at: int, n: int, d: int):
        if file.undefined(at):
            return
        if d == 0:
            buf = file.read(at, 6 + n * rec_size, path)
            if buf[:4] != b"BTLF":
                file.fail(path, "v2 B-tree leaf without its BTLF signature")
            for i in range(n):
                yield buf[6 + i * rec_size:6 + (i + 1) * rec_size]
            return
        ptr = O + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        buf = file.read(at, 6 + n * rec_size + (n + 1) * ptr, path)
        if buf[:4] != b"BTIN":
            file.fail(path, "v2 B-tree internal node without its BTIN signature")
        base = 6 + n * rec_size
        for i in range(n + 1):
            p = base + i * ptr
            yield from node(_u(buf, p, O), _u(buf, p + O, nrec_size), d - 1)
            if i < n:
                yield buf[6 + i * rec_size:6 + (i + 1) * rec_size]
    yield from node(root, root_n, depth)


class _FractalHeap:
    """The managed objects of a fractal heap, by heap ID."""

    def __init__(self, file: _File, addr: int, path: str):
        O, L = file.O, file.L
        self.file, self.path = file, path
        n = 4 + 1 + 2 + 2 + 1 + 4 + L + O + L + O + 8 * L + 2 + L + L + 2 + 2 + O + 2
        head = file.read(addr, n, path)
        if head[:4] != b"FRHP":
            file.fail(path, "fractal heap header without its FRHP signature")
        self.id_len, filter_len = _u(head, 5, 2), _u(head, 7, 2)
        if filter_len:
            file.fail(path, "fractal heap with I/O filters")
        self.max_man = _u(head, 10, 4)
        pos = 14 + L + O + L + O + 8 * L
        self.width = _u(head, pos, 2)
        self.start_size = _u(head, pos + 2, L)
        self.max_direct = _u(head, pos + 2 + L, L)
        self.max_heap_bits = _u(head, pos + 2 + 2 * L, 2)
        root = _u(head, pos + 6 + 2 * L, O)
        root_rows = _u(head, pos + 6 + 2 * L + O, 2)
        self.off_size = (self.max_heap_bits + 7) // 8
        self.len_size = min((_log2(self.max_direct) + 7) // 8, _log2(self.max_man) // 8 + 1)
        self.max_direct_rows = _log2(self.max_direct) - _log2(self.start_size) + 2
        self.blocks: List[Tuple[int, int, int]] = []  # (heap offset, size, address)
        if not file.undefined(root):
            if root_rows == 0:
                self._direct(root, self.start_size)
            else:
                self._indirect(root, root_rows)

    def _row_size(self, r: int) -> int:
        return self.start_size if r == 0 else self.start_size << (r - 1)

    def _direct(self, addr: int, size: int):
        head = self.file.read(addr, 5 + self.file.O + self.off_size, self.path)
        if head[:4] != b"FHDB":
            self.file.fail(self.path, "fractal heap direct block without its FHDB signature")
        self.blocks.append((_u(head, 5 + self.file.O, self.off_size), size, addr))

    def _indirect(self, addr: int, rows: int):
        O = self.file.O
        direct_rows = min(rows, self.max_direct_rows)
        n = rows * self.width
        buf = self.file.read(addr, 5 + O + self.off_size + n * O, self.path)
        if buf[:4] != b"FHIB":
            self.file.fail(self.path, "fractal heap indirect block without its FHIB signature")
        pos = 5 + O + self.off_size
        for r in range(rows):
            for _ in range(self.width):
                child = _u(buf, pos, O)
                pos += O
                if self.file.undefined(child):
                    continue
                size = self._row_size(r)
                if r < direct_rows:
                    self._direct(child, size)
                else:
                    child_rows = _log2(size) - _log2(self.start_size * self.width) + 1
                    self._indirect(child, child_rows)

    def get(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 3
        if kind != 0:
            self.file.fail(self.path, f"fractal heap {'huge' if kind == 1 else 'tiny'} object")
        offset = _u(heap_id, 1, self.off_size)
        length = _u(heap_id, 1 + self.off_size, self.len_size)
        for start, size, addr in self.blocks:
            if start <= offset < start + size:
                return self.file.read(addr + offset - start, length, self.path)
        self.file.fail(self.path, f"fractal heap object at offset {offset} is in no block")


def _link(file: _File, data: bytes, path: str) -> Tuple[str, Optional[int], Optional[int], str]:
    """(name, object address or None, creation order or None, kind) of a
    link message."""
    flags, pos = data[1], 2
    kind = 0
    if flags & 0x08:
        kind, pos = data[pos], pos + 1
    order = None
    if flags & 0x04:
        order, pos = _u(data, pos, 8), pos + 8
    if flags & 0x10:
        pos += 1
    n = 1 << (flags & 3)
    length, pos = _u(data, pos, n), pos + n
    name = data[pos:pos + length].decode("utf-8", "surrogateescape")
    pos += length
    if kind == 0:
        return name, _u(data, pos, file.O), order, "hard"
    return name, None, order, {1: "soft link", 64: "external link"}.get(kind, f"link type {kind}")


def _sorted(entries: List[Tuple[str, Optional[int], Any]]) -> List[Tuple[str, Any]]:
    """Entries in h5py's order: creation order where it is tracked, else by
    name."""
    if entries and all(e[1] is not None for e in entries):
        entries = sorted(entries, key=lambda e: e[1])
    else:
        entries = sorted(entries, key=lambda e: e[0].encode("utf-8", "surrogateescape"))
    return [(e[0], e[2]) for e in entries]


# -- attributes -----------------------------------------------------------------
class Attributes(Mapping):
    """An object's attributes, by name, decoded on read as h5py decodes
    them."""

    def __init__(self, file: _File, header: _Header, path: str):
        self._file, self._path = file, path
        entries = [(self._name(m.data), m.order, m.data) for m in header.all(_ATTRIBUTE)]
        info = header.first(_ATTRIBUTE_INFO)
        if info is not None:
            O = file.O
            pos = 2 + (2 if info[1] & 1 else 0)
            heap_addr, names_addr = _u(info, pos, O), _u(info, pos + O, O)
            if not file.undefined(heap_addr):
                heap = _FractalHeap(file, heap_addr, path)
                for rec in _v2_btree_records(file, names_addr, path):
                    if rec[8] & 0x02:
                        file.fail(path, "attribute stored as a shared message")
                    msg = heap.get(rec[:8])
                    entries.append((self._name(msg), _u(rec, 9, 4), msg))
        self._raw = dict(_sorted(entries))

    @staticmethod
    def _name(data: bytes) -> str:
        version = data[0]
        size = _u(data, 2, 2)
        start = 8 if version < 3 else 9
        return data[start:start + size].split(b"\0")[0].decode("utf-8", "surrogateescape")

    def __iter__(self):
        return iter(self._raw)

    def __len__(self):
        return len(self._raw)

    def __contains__(self, name):
        return name in self._raw

    def __getitem__(self, name: str):
        data = self._raw[name]
        where = f"{self._path} attribute {name!r}"
        file = self._file
        version, flags = data[0], data[1]
        nsize, tsize, ssize = _u(data, 2, 2), _u(data, 4, 2), _u(data, 6, 2)
        if version == 1:
            pos = 8 + _pad8(nsize)
            tdata = data[pos:pos + tsize]
            pos += _pad8(tsize)
            sdata = data[pos:pos + ssize]
            pos += _pad8(ssize)
        elif version in (2, 3):
            pos = (8 if version == 2 else 9) + nsize
            tdata, sdata = data[pos:pos + tsize], data[pos + tsize:pos + tsize + ssize]
            pos += tsize + ssize
        else:
            file.fail(where, f"attribute message version {version}")
        if version > 1 and flags & 0x01:
            tdata = _unshare(file, tdata, _DATATYPE, where)
        if version > 1 and flags & 0x02:
            sdata = _unshare(file, sdata, _DATASPACE, where)
        dtype = _datatype(file, tdata, where)
        shape, _ = _dataspace(file, sdata, where)
        if shape is None:
            file.fail(where, "null dataspace")
        count = int(np.prod(shape, dtype=np.int64))
        raw = data[pos:pos + count * dtype.dtype.itemsize]
        if len(raw) < count * dtype.dtype.itemsize:
            file.fail(where, "attribute data runs past its message")
        arr = dtype.fix(np.frombuffer(raw, dtype.dtype, count).reshape(shape).copy())
        return arr[()] if arr.ndim == 0 else arr


# -- datasets -------------------------------------------------------------------
def _fletcher32(data: bytes) -> int:
    """libhdf5's H5_checksum_fletcher32: big-endian 16-bit words, sums
    folded every 360 words, in 32-bit arithmetic."""
    n = len(data) // 2
    words = np.frombuffer(data, ">u2", n).astype(np.uint64)
    sum1 = sum2 = 0
    mask = 0xFFFFFFFF
    for k in range(0, n, 360):
        block = words[k:k + 360]
        m = len(block)
        weighted = int((block * np.arange(m, 0, -1, dtype=np.uint64)).sum())
        sum2 = (sum2 + m * sum1 + weighted) & mask
        sum1 = (sum1 + int(block.sum())) & mask
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if len(data) % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


class Dataset:
    """A dataset: ``shape``, ``dtype``, ``attrs``; ``ds[()]`` and ``ds[i]``
    read it."""

    def __init__(self, file: _File, header: _Header, path: str):
        self._file, self._header, self.name = file, header, path
        space = header.first(_DATASPACE)
        if space is None:
            file.fail(path, "dataset without a dataspace message")
        self.shape, self.maxshape = _dataspace(file, space, path)
        self._type: Optional[_Type] = None

    @property
    def attrs(self) -> Attributes:
        return Attributes(self._file, self._header, self.name)

    @property
    def dtype(self) -> np.dtype:
        return self._datatype().dtype

    def _datatype(self) -> _Type:
        if self._type is None:
            data = self._header.first(_DATATYPE)
            if data is None:
                self._file.fail(self.name, "dataset without a datatype message")
            self._type = _datatype(self._file, data, self.name)
        return self._type

    def __getitem__(self, key):
        if self.shape is None:
            self._file.fail(self.name, "null dataspace")
        if isinstance(key, tuple) and key == ():
            return self._read(0, 1)[()] if not self.shape else self._read(0, self.shape[0])
        if self.shape and isinstance(key, (int, np.integer)) and not isinstance(key, bool):
            n = self.shape[0]
            i = int(key) + (n if key < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {key} is out of range for axis 0 of {n}")
            return self._read(i, i + 1)[0]
        raise TypeError(f"{self.name}: reads take () or an int index of the first axis, "
                        f"not {key!r}")

    def _fill(self, dtype: np.dtype) -> np.ndarray:
        """The fill value as a 0-d array (zeros where none is set)."""
        hdr = self._header
        data = hdr.first(_FILL)
        value = b""
        if data is not None:
            version = data[0]
            if version in (1, 2):
                if version == 1 or data[3]:
                    size = _u(data, 4, 4) if len(data) >= 8 else 0
                    value = data[8:8 + size]
            elif version == 3:
                if data[1] & 0x20:
                    size = _u(data, 2, 4)
                    value = data[6:6 + size]
            else:
                self._file.fail(self.name, f"fill value message version {version}")
        else:
            old = hdr.first(_FILL_OLD)
            if old is not None:
                value = old[4:4 + _u(old, 0, 4)]
        if len(value) == dtype.itemsize:
            return np.frombuffer(value, dtype, 1).reshape(()).copy()
        return np.zeros((), dtype)

    def _read(self, start: int, stop: int) -> np.ndarray:
        """Rows ``start:stop`` of the first axis (the one element of a
        scalar), as h5py returns them."""
        file, hdr = self._file, self._header
        if hdr.first(_EXTERNAL) is not None:
            file.fail(self.name, "external data files")
        t = self._datatype()
        dtype = t.dtype
        inner = self.shape[1:] if self.shape else ()
        row = int(np.prod(inner, dtype=np.int64))
        out_shape = (stop - start,) + tuple(inner) if self.shape else ()
        count = (stop - start) * row if self.shape else 1
        layout = hdr.first(_LAYOUT)
        if layout is None:
            file.fail(self.name, "dataset without a data layout message")
        version, cls = layout[0], layout[1]
        if version not in (3, 4):
            file.fail(self.name, f"data layout message version {version}")
        if cls == 0:  # compact
            raw = layout[4:4 + _u(layout, 2, 2)]
            arr = np.frombuffer(raw, dtype, count, offset=start * row * dtype.itemsize).copy()
        elif cls == 1:  # contiguous
            addr = _u(layout, 2, file.O)
            if file.undefined(addr):
                arr = np.full(count, self._fill(dtype), dtype)
            else:
                offset = file.base + addr + start * row * dtype.itemsize
                if offset + count * dtype.itemsize > file.size:
                    file.fail(self.name, "truncated file: the data runs past its end")
                file.f.seek(offset)
                arr = np.fromfile(file.f, dtype, count)
        elif cls == 2:
            arr = _Chunks(self, layout).read(start, stop)
        else:
            file.fail(self.name, f"data layout class {cls}"
                      + (" (virtual)" if cls == 3 else ""))
        return t.fix(arr.reshape(out_shape))


class _Chunks:
    """A chunked dataset's chunk index, filters and assembly."""

    def __init__(self, ds: Dataset, layout: bytes):
        self.ds, self.file = ds, ds._file
        file, O = self.file, self.file.O
        self.where = ds.name
        self.rank = len(ds.shape)
        self.partial_edge_unfiltered = False
        version = layout[0]
        if version == 3:
            ndims = layout[2]
            self.index = ("btree1", _u(layout, 3, O))
            self.dims = [_u(layout, 3 + O + 4 * i, 4) for i in range(ndims)]
            self.single = None
        else:
            flags, ndims, enc = layout[2], layout[3], layout[4]
            self.partial_edge_unfiltered = bool(flags & 0x01)
            self.dims = [_u(layout, 5 + enc * i, enc) for i in range(ndims)]
            pos = 5 + enc * ndims
            kind = layout[pos]
            pos += 1
            self.single = None
            if kind == 1:
                if flags & 0x02:
                    L = file.L
                    self.single = (_u(layout, pos, L), _u(layout, pos + L, 4))
                    pos += L + 4
                self.index = ("single", _u(layout, pos, O))
            elif kind == 2:
                self.index = ("implicit", _u(layout, pos, O))
            elif kind == 3:
                self.index = ("farray", _u(layout, pos + 1, O))
            elif kind == 4:
                self.index = ("earray", _u(layout, pos + 5, O))
            elif kind == 5:
                file.fail(self.where, "v2 B-tree chunk index")
            else:
                file.fail(self.where, f"chunk index type {kind}")
        self.chunk = self.dims[:self.rank]
        self.filters = self._pipeline()

    def _pipeline(self) -> List[Tuple[int, List[int]]]:
        data = self.ds._header.first(_FILTERS)
        if data is None:
            return []
        version, n = data[0], data[1]
        pos = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid = _u(data, pos, 2)
            pos += 2
            name_len = 0
            if version == 1 or fid >= 256:
                name_len, pos = _u(data, pos, 2), pos + 2
            nvals = _u(data, pos + 2, 2)
            pos += 4
            pos += _pad8(name_len) if version == 1 else name_len
            vals = [_u(data, pos + 4 * i, 4) for i in range(nvals)]
            pos += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (1, 2, 3):
                self.file.fail(self.where,
                               f"filter {fid} ({FILTER_NAMES.get(fid, 'unregistered')})")
            out.append((fid, vals))
        return out

    def _grid(self, max_shape: Sequence[Optional[int]]) -> List[int]:
        return [-(-m // c) if m is not None else 0 for m, c in zip(max_shape, self.chunk)]

    def _entries(self) -> Iterator[Tuple[Tuple[int, ...], int, int, int]]:
        """(element offsets, address, stored size, filter mask) of every
        allocated chunk."""
        kind, addr = self.index
        file, O = self.file, self.file.O
        nbytes = int(np.prod(self.dims, dtype=np.int64))
        if file.undefined(addr):
            return
        if kind == "btree1":
            key = 8 + 8 * len(self.dims)
            for k, child in _v1_btree(file, addr, 1, key, self.where):
                offsets = tuple(_u(k, 8 + 8 * i, 8) for i in range(self.rank))
                yield offsets, child, _u(k, 0, 4), _u(k, 4, 4)
            return
        if kind == "single":
            size, mask = self.single if self.single else (nbytes, 0)
            yield (0,) * self.rank, addr, size, mask
            return
        maxshape = [m if m is not None else None for m in self.ds.maxshape]
        if kind == "implicit":
            grid = self._grid(maxshape)
            for i in range(int(np.prod(grid, dtype=np.int64))):
                yield self._coords(i, grid, None), addr + i * nbytes, nbytes, 0
            return
        if kind == "farray":
            grid = self._grid(maxshape)
            for i, (a, size, mask) in self._fixed_array(addr):
                if not file.undefined(a):
                    yield self._coords(i, grid, None), a, size, mask
            return
        unlim = [d for d, m in enumerate(maxshape) if m is None]
        grid = self._grid(maxshape)
        for i, (a, size, mask) in self._extensible_array(addr):
            if not file.undefined(a):
                yield self._coords(i, grid, unlim[0]), a, size, mask

    def _coords(self, i: int, grid: List[int], unlim: Optional[int]) -> Tuple[int, ...]:
        """Element offsets of the chunk at linear index ``i``: row-major over
        the chunk grid, the unlimited axis (if any) slowest."""
        order = list(range(self.rank))
        if unlim is not None:
            order = [unlim] + [d for d in order if d != unlim]
        scaled = [0] * self.rank
        for d in reversed(order[1:]):
            i, scaled[d] = divmod(i, grid[d])
        scaled[order[0]] = i
        return tuple(s * c for s, c in zip(scaled, self.chunk))

    def _element(self, buf: bytes, pos: int, esize: int, filtered: bool):
        O = self.file.O
        a = _u(buf, pos, O)
        if not filtered:
            return a, int(np.prod(self.dims, dtype=np.int64)), 0
        n = esize - O - 4
        return a, _u(buf, pos + O, n), _u(buf, pos + O + n, 4)

    def _fixed_array(self, addr: int):
        file, O, L = self.file, self.file.O, self.file.L
        head = file.read(addr, 8 + L + O, self.where)
        if head[:4] != b"FAHD":
            file.fail(self.where, "fixed array header without its FAHD signature")
        filtered, esize, page_bits = head[5] == 1, head[6], head[7]
        n, dblock = _u(head, 8, L), _u(head, 8 + L, O)
        if n > (1 << page_bits):
            file.fail(self.where, "paged fixed-array chunk index")
        if file.undefined(dblock):
            return
        buf = file.read(dblock, 6 + O + n * esize, self.where)
        if buf[:4] != b"FADB":
            file.fail(self.where, "fixed array data block without its FADB signature")
        for i in range(n):
            yield i, self._element(buf, 6 + O + i * esize, esize, filtered)

    def _extensible_array(self, addr: int):
        file, O, L = self.file, self.file.O, self.file.L
        head = file.read(addr, 12 + 6 * L + O, self.where)
        if head[:4] != b"EAHD":
            file.fail(self.where, "extensible array header without its EAHD signature")
        filtered, esize, max_bits = head[5] == 1, head[6], head[7]
        idx_elmts, dblk_min, sblk_min_ptrs, page_bits = head[8], head[9], head[10], head[11]
        max_idx = _u(head, 12 + 4 * L, L)
        iblock = _u(head, 12 + 6 * L, O)
        if file.undefined(iblock):
            return
        nsblks = 1 + max_bits - _log2(dblk_min)
        info, start_idx, start_dblk = [], 0, 0
        for s in range(nsblks):
            ndblks, nelmts = 1 << (s // 2), (1 << ((s + 1) // 2)) * dblk_min
            info.append((ndblks, nelmts, start_idx, start_dblk))
            start_idx += ndblks * nelmts
            start_dblk += ndblks
        iblock_sblks = 2 * _log2(sblk_min_ptrs)
        n_dblk_addrs = 2 * (sblk_min_ptrs - 1)
        n_sblk_addrs = nsblks - iblock_sblks
        off_size = (max_bits + 7) // 8
        buf = file.read(iblock, 6 + O + idx_elmts * esize + (n_dblk_addrs + n_sblk_addrs) * O,
                        self.where)
        if buf[:4] != b"EAIB":
            file.fail(self.where, "extensible array index block without its EAIB signature")
        pos = 6 + O
        for i in range(min(idx_elmts, max_idx)):
            yield i, self._element(buf, pos + i * esize, esize, filtered)
        pos += idx_elmts * esize
        dblk_addrs = [_u(buf, pos + O * k, O) for k in range(n_dblk_addrs)]
        pos += n_dblk_addrs * O
        sblk_addrs = [_u(buf, pos + O * k, O) for k in range(n_sblk_addrs)]

        def data_block(at: int, nelmts: int, first: int):
            if file.undefined(at):
                return
            if nelmts > (1 << page_bits):
                file.fail(self.where, "paged extensible-array chunk index")
            b = file.read(at, 6 + O + off_size + nelmts * esize, self.where)
            if b[:4] != b"EADB":
                file.fail(self.where, "extensible array data block without its EADB signature")
            for k in range(nelmts):
                if first + k < max_idx:
                    yield first + k, self._element(b, 6 + O + off_size + k * esize, esize,
                                                   filtered)

        for s, (ndblks, nelmts, s_start, s_dblk) in enumerate(info):
            first = idx_elmts + s_start
            if first >= max_idx:
                break
            if s < iblock_sblks:
                for d in range(ndblks):
                    yield from data_block(dblk_addrs[s_dblk + d], nelmts, first + d * nelmts)
                continue
            at = sblk_addrs[s - iblock_sblks]
            if file.undefined(at):
                continue
            if nelmts > (1 << page_bits):
                file.fail(self.where, "paged extensible-array chunk index")
            b = file.read(at, 6 + O + off_size + ndblks * O, self.where)
            if b[:4] != b"EASB":
                file.fail(self.where,
                          "extensible array secondary block without its EASB signature")
            for d in range(ndblks):
                yield from data_block(_u(b, 6 + O + off_size + d * O, O), nelmts,
                                      first + d * nelmts)

    def _decode(self, raw: bytes, mask: int, edge: bool) -> bytes:
        if edge and self.partial_edge_unfiltered:
            return raw
        for i in reversed(range(len(self.filters))):
            if mask & (1 << i):
                continue
            fid, vals = self.filters[i]
            if fid == 1:
                raw = zlib.decompress(raw)
            elif fid == 2:
                size = vals[0] if vals else self.ds.dtype.itemsize
                n = len(raw) // size
                b = np.frombuffer(raw, np.uint8)
                head = b[:n * size].reshape(size, n).T.reshape(-1)
                raw = head.tobytes() + raw[n * size:]
            else:
                body, stored = raw[:-4], _u(raw, len(raw) - 4, 4)
                sum_ = _fletcher32(body)
                if stored not in (sum_, int.from_bytes(sum_.to_bytes(4, "little"), "big")):
                    self.file.fail(self.where, "fletcher32 checksum mismatch")
                raw = body
        return raw

    def read(self, start: int, stop: int) -> np.ndarray:
        ds = self.ds
        dtype = ds._datatype().dtype
        shape = list(ds.shape)
        out_shape = [stop - start] + shape[1:] if shape else []
        out = np.empty(out_shape, dtype)
        out[...] = ds._fill(dtype)
        nbytes = int(np.prod(self.dims, dtype=np.int64))
        for offsets, addr, size, mask in self._entries():
            if shape and not (offsets[0] < stop and offsets[0] + self.chunk[0] > start):
                continue
            if any(o >= s for o, s in zip(offsets, shape)):
                continue
            edge = any(o + c > s for o, c, s in zip(offsets, self.chunk, shape))
            raw = self._decode(self.file.read(addr, size, self.where), mask, edge)
            if len(raw) != nbytes:
                self.file.fail(self.where, f"chunk of {len(raw)} bytes where {nbytes} "
                                           "were expected")
            block = np.frombuffer(raw, dtype).reshape(self.chunk)
            src, dst = [], []
            for d, (o, c, s) in enumerate(zip(offsets, self.chunk, shape)):
                lo, hi = o, min(o + c, s)
                if d == 0:
                    lo, hi = max(lo, start), min(hi, stop)
                    dst.append(slice(lo - start, hi - start))
                else:
                    dst.append(slice(lo, hi))
                src.append(slice(lo - o, hi - o))
            out[tuple(dst)] = block[tuple(src)]
        return out


# -- groups ---------------------------------------------------------------------
class Group(Mapping):
    """A group: a mapping of link names to groups and datasets."""

    def __init__(self, file: _File, header: _Header, path: str):
        self._file, self._header, self.name = file, header, path
        self._links: Optional[Dict[str, Tuple[str, Optional[int]]]] = None

    @property
    def attrs(self) -> Attributes:
        return Attributes(self._file, self._header, self.name)

    def _table(self) -> Dict[str, Tuple[str, Optional[int]]]:
        if self._links is None:
            file, hdr, path = self._file, self._header, self.name
            stab = hdr.first(_SYMBOL_TABLE)
            if stab is not None:
                entries = [(n, None, ("hard", a))
                           for n, a in _symbol_table_links(file, stab, path).items()]
            else:
                entries = []
                for m in hdr.all(_LINK):
                    name, addr, order, kind = _link(file, m.data, path)
                    entries.append((name, order, (kind, addr)))
                info = hdr.first(_LINK_INFO)
                if info is not None:
                    O = file.O
                    pos = 2 + (8 if info[1] & 1 else 0)
                    heap_addr, names_addr = _u(info, pos, O), _u(info, pos + O, O)
                    if not file.undefined(heap_addr):
                        heap = _FractalHeap(file, heap_addr, path)
                        for rec in _v2_btree_records(file, names_addr, path):
                            name, addr, order, kind = _link(
                                file, heap.get(rec[4:4 + heap.id_len]), path)
                            entries.append((name, order, (kind, addr)))
            self._links = dict(_sorted(entries))
        return self._links

    def __iter__(self):
        return iter(self._table())

    def __len__(self):
        return len(self._table())

    def __contains__(self, name) -> bool:
        parent, _, last = str(name).rstrip("/").rpartition("/")
        try:
            group = self[parent] if parent else self
        except (KeyError, HDF5Error):
            return False
        return isinstance(group, Group) and last in group._table()

    def __getitem__(self, name: str):
        node: Any = self
        for part in [p for p in str(name).split("/") if p]:
            if not isinstance(node, Group) or part not in node._table():
                raise KeyError(name)
            kind, addr = node._table()[part]
            path = node.name.rstrip("/") + "/" + part
            if kind != "hard":
                self._file.fail(path, kind)
            node = _object(node._file, addr, path)
        return node

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _object(file: _File, addr: int, path: str):
    header = _Header(file, addr, path)
    if header.first(_LAYOUT) is not None or header.first(_DATASPACE) is not None:
        return Dataset(file, header, path)
    return Group(file, header, path)


def open(path) -> Group:  # noqa: A001 -- h5py.File's counterpart
    """The root group of the HDF5 file at ``path``; close it (or use
    ``with``) when done."""
    file = _File(path)
    try:
        return Group(file, _Header(file, file.root, "/"), "/")
    except BaseException:
        file.close()
        raise


# -- the writer -----------------------------------------------------------------
_META_BLOCK = 2048      # libhdf5's metadata aggregation block
_HEAP_DATA = 88         # the root group's initial local heap
_OHDR_DATA = 256        # a dataset's first header chunk (H5D_MINHDR_SIZE)
_SNOD_SIZE = 8 + 8 * 40
_BTREE_SIZE = 24 + (33 + 32) * 8  # a group B-tree node, K 16, 8-byte offsets


def _encode_type(dtype: np.dtype) -> bytes:
    if dtype.kind == "S":
        return bytes([0x13, 0x01, 0, 0]) + dtype.itemsize.to_bytes(4, "little")
    if dtype.byteorder == ">" or (dtype.byteorder == "=" and np.little_endian is False):
        raise ValueError(f"the writer writes little-endian data only, not {dtype}")
    size = dtype.itemsize
    if dtype.kind in "iu":
        return (bytes([0x10, 0x08 if dtype.kind == "i" else 0, 0, 0]) + size.to_bytes(4, "little")
                + (0).to_bytes(2, "little") + (8 * size).to_bytes(2, "little"))
    if dtype.kind == "f" and size in (4, 8):
        eloc, esize, msize, bias = {4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}[size]
        return (bytes([0x11, 0x20, 8 * size - 1, 0]) + size.to_bytes(4, "little")
                + (0).to_bytes(2, "little") + (8 * size).to_bytes(2, "little")
                + bytes([eloc, esize, 0, msize]) + bias.to_bytes(4, "little"))
    raise ValueError(f"the writer writes integers, f32, f64 and fixed strings, not {dtype}")


def _msg(t: int, data: bytes, flags: int = 0) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return (t.to_bytes(2, "little") + len(data).to_bytes(2, "little")
            + bytes([flags, 0, 0, 0]) + data)


def _u64(v: int) -> bytes:
    return v.to_bytes(8, "little")


def _attribute(name: str, value) -> bytes:
    arr = np.asarray(value)
    if arr.ndim != 0 or arr.dtype.kind not in "iuf":
        raise ValueError(f"attribute {name!r}: the writer writes numeric scalars only")
    arr = arr.astype(arr.dtype.newbyteorder("<"))
    bname = name.encode() + b"\0"
    dtype = _encode_type(arr.dtype)
    space = bytes([1, 0, 0, 0, 0, 0, 0, 0])
    body = (bytes([1, 0]) + len(bname).to_bytes(2, "little") + len(dtype).to_bytes(2, "little")
            + len(space).to_bytes(2, "little"))
    for part in (bname, dtype, space):
        body += part + b"\0" * (_pad8(len(part)) - len(part))
    return _msg(_ATTRIBUTE, body + arr.tobytes())


def write(path, datasets: Mapping[str, Tuple[np.ndarray, Mapping[str, Any]]]) -> None:
    """Write ``{name: (array, attrs)}`` into a new HDF5 file at ``path``, in
    the mapping's order, byte for byte as h5py writes it (see the module's
    docstring for what it covers)."""
    items = [(str(name), np.asarray(arr), dict(attrs or {}))
             for name, (arr, attrs) in datasets.items()]
    if not items:
        raise ValueError("the writer writes at least one dataset")
    meta = bytearray(_META_BLOCK)
    # the root group's local heap: "" then each name, NUL-terminated, 8-aligned
    heap, offsets = bytearray(8), {}
    for name, arr, _ in items:
        if arr.ndim == 0 or arr.size == 0:
            raise ValueError(f"{name}: the writer writes non-empty arrays of rank >= 1")
        if "/" in name or not name:
            raise ValueError(f"{name!r}: names are plain link names")
        offsets[name] = len(heap)
        b = name.encode() + b"\0"
        heap += b + b"\0" * (_pad8(len(b)) - len(b))
    if len(heap) + 16 > _HEAP_DATA:
        raise ValueError("the dataset names do not fit the root group's first local heap")
    btree, heap_hdr = 0x88, 0x88 + _BTREE_SIZE
    heap_data = heap_hdr + 32
    ptr = heap_data + _HEAP_DATA
    data_at = _META_BLOCK
    snod = None
    headers = {}
    for i, (name, arr, attrs) in enumerate(items):
        headers[name] = ptr
        at = ptr + 16
        ends = {at + _OHDR_DATA}  # where this header's chunks end
        ptr += 16 + _OHDR_DATA
        if i == 0:
            snod, ptr = ptr, ptr + _SNOD_SIZE
        rank = arr.ndim
        dims = b"".join(_u64(d) for d in arr.shape)
        placed = []  # (address, message bytes)
        for m in (_msg(_DATASPACE, bytes([1, rank, 1, 0, 0, 0, 0, 0]) + dims + dims),
                  _msg(_DATATYPE, _encode_type(arr.dtype), flags=1),
                  _msg(_FILL, bytes([2, 2, 2, 1, 0, 0, 0, 0]), flags=1),
                  _msg(_LAYOUT, bytes([3, 1]) + _u64(data_at) + _u64(arr.nbytes))):
            placed.append((at, m))
            at += len(m)
        data_at += arr.nbytes
        # the rest of the chunk is one NIL; each attribute takes the first NIL
        # that holds it, else a new chunk of its size behind a continuation
        nils = [(at, min(ends) - at)]  # (address, bytes with the message header)
        for key, value in attrs.items():
            m = _attribute(key, value)
            fit = [k for k, (_, n) in enumerate(nils) if n >= len(m)]
            if not fit:
                if ptr in ends:  # libhdf5 grows a chunk that ends the metadata
                    raise ValueError(f"{name}: the writer does not grow a header chunk in "
                                     "place, as libhdf5 does for these attributes")
                cont = [k for k, (_, n) in enumerate(nils) if n >= 24]
                if not cont:
                    raise ValueError(f"{name}: too many attributes for the writer's layout")
                k = cont[0]
                at, n = nils.pop(k)
                placed.append((at, _msg(_CONTINUATION, _u64(ptr) + _u64(len(m)))))
                if n > 24:
                    nils.insert(k, (at + 24, n - 24))
                placed.append((ptr, m))
                ptr += len(m)
                ends.add(ptr)
                continue
            k = fit[0]
            at, n = nils.pop(k)
            placed.append((at, m))
            if n > len(m):
                nils.insert(k, (at + len(m), n - len(m)))
        for at, n in nils:
            placed.append((at, _msg(_NIL, b"\0" * (n - 8))))
        if ptr > _META_BLOCK:
            raise ValueError("the file's metadata outgrows libhdf5's first 2048-byte block")
        for at, m in placed:
            meta[at:at + len(m)] = m
        h = headers[name]
        meta[h:h + 16] = (bytes([1, 0]) + len(placed).to_bytes(2, "little")
                          + (1).to_bytes(4, "little") + _OHDR_DATA.to_bytes(4, "little")
                          + b"\0" * 4)
    undef = b"\xff" * 8
    eof = data_at
    # superblock v0 and the root group's symbol table entry
    meta[0:56] = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + (4).to_bytes(2, "little")
                  + (16).to_bytes(2, "little") + b"\0" * 4 + _u64(0) + undef + _u64(eof)
                  + undef)
    meta[56:96] = _u64(0) + _u64(0x60) + (1).to_bytes(4, "little") + b"\0" * 4 + \
        _u64(btree) + _u64(heap_hdr)
    # the root object header: one symbol table message
    meta[0x60:0x88] = (bytes([1, 0]) + (1).to_bytes(2, "little") + (1).to_bytes(4, "little")
                       + (24).to_bytes(4, "little") + b"\0" * 4
                       + _msg(_SYMBOL_TABLE, _u64(btree) + _u64(heap_hdr)))
    names = sorted(offsets, key=lambda n: n.encode())
    meta[btree:btree + 48] = (b"TREE" + bytes([0, 0]) + (1).to_bytes(2, "little") + undef
                              + undef + _u64(0) + _u64(snod) + _u64(offsets[names[-1]]))
    meta[heap_hdr:heap_hdr + 32] = (b"HEAP" + b"\0" * 4 + _u64(_HEAP_DATA) + _u64(len(heap))
                                    + _u64(heap_data))
    meta[heap_data:heap_data + len(heap)] = heap
    free = heap_data + len(heap)
    meta[free:free + 16] = _u64(1) + _u64(_HEAP_DATA - len(heap))
    entries = b"".join(_u64(offsets[n]) + _u64(headers[n]) + b"\0" * 24 for n in names)
    meta[snod:snod + 8 + len(entries)] = (b"SNOD" + bytes([1, 0])
                                          + len(names).to_bytes(2, "little") + entries)
    with io.open(path, "wb") as f:
        f.write(meta)
        for _, arr, _ in items:
            f.write(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
