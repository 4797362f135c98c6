"""RecordIO format.

Copy of ``mxnet_tpu/recordio.py`` (reference parity: python/mxnet/
recordio.py, MXRecordIO/MXIndexedRecordIO over dmlc-core recordio;
pack/unpack with IRHeader for image records). The binary format is kept
byte for byte: magic 0xced7230a, 32-bit LE kmagic + lrecord (upper 3 bits
cflag, lower 29 length), 4-byte alignment padding, so a ``.rec`` / ``.idx``
pair written by either package reads in the other. The JAX package's
native mmap reader (``native/mxtpu_io.cc``) is not ported: this Python
reader is the port's only path.
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as onp

from .base import MXNetError

_MAGIC = 0xced7230a
_CFLAG_BITS = 29
_LEN_MASK = (1 << _CFLAG_BITS) - 1


class RecordIOCorrupt(MXNetError):
    """Structured corruption report from a record stream.

    ``kind`` distinguishes the two failure classes a reader meets:

    - ``"torn_tail"`` — the file ends mid-record (a writer died between
      the header and the payload, or the payload itself was truncated).
      Everything before ``offset`` is intact: the file is *resumable* —
      re-open for append at ``offset``, or stop reading there.
    - ``"bad_magic"`` — framing lost mid-file (bit rot, a seek into the
      middle of a payload). Not resumable; the bytes from ``offset`` on
      cannot be trusted.

    ``offset`` is always the position of the last good record boundary.
    """

    def __init__(self, uri, offset, kind, detail):
        self.uri = uri
        self.offset = int(offset)
        self.kind = kind
        self.resumable = kind == "torn_tail"
        super().__init__(
            f"recordio corruption in {uri!r} at offset {offset}: "
            f"{detail} [{kind}]")


class MXRecordIO:
    """Sequential record file reader/writer (reference: recordio.py:34)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag!r}")
        self.is_open = True

    def close(self):
        if self.is_open:
            self.record.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["record"] = None
        d["is_open"] = False
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        self.record.write(struct.pack("<II", _MAGIC, len(buf) & _LEN_MASK))
        self.record.write(buf)
        pad = (4 - (len(buf) % 4)) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        start = self.record.tell()
        header = self.record.read(8)
        if not header:
            return None          # clean EOF on a record boundary
        if len(header) < 8:
            raise RecordIOCorrupt(
                self.uri, start, "torn_tail",
                f"{len(header)}-byte header fragment at EOF")
        magic, lrec = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise RecordIOCorrupt(
                self.uri, start, "bad_magic",
                f"invalid record magic 0x{magic:08x}")
        length = lrec & _LEN_MASK
        buf = self.record.read(length)
        if len(buf) < length:
            raise RecordIOCorrupt(
                self.uri, start, "torn_tail",
                f"payload truncated: {len(buf)} of {length} bytes")
        pad = (4 - (length % 4)) % 4
        if pad:
            # a short pad is still a complete record: the torn bytes are
            # alignment filler, so tolerate it (next read() reports EOF
            # or the tear, whichever the tail holds)
            self.record.read(pad)
        return buf

    def tell(self):
        return self.record.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access record file with .idx (reference: recordio.py:141)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.exists(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        key = self.key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if getattr(self, "fidx", None) is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def seek(self, idx):
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


IndexedRecordIO = MXIndexedRecordIO

# image record header (reference: recordio.py IRHeader)
IRHeader = collections.namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack IRHeader + payload bytes (reference: recordio.py pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, (list, tuple, onp.ndarray)):
        label = onp.asarray(header.label, dtype=onp.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
        return struct.pack(_IR_FORMAT, *header) + s
    return struct.pack(_IR_FORMAT, header.flag, float(header.label),
                       header.id, header.id2) + s


def unpack(s):
    """Unpack a record into (IRHeader, payload) (reference: recordio.py
    unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = onp.frombuffer(s[:header.flag * 4], dtype=onp.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=-1):
    """Unpack an image record into (IRHeader, HWC numpy image)."""
    header, img_bytes = unpack(s)
    from .image import imdecode_np
    return header, imdecode_np(img_bytes, flag=1 if iscolor != 0 else 0)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack IRHeader + an image encoded as ``img_fmt`` (``.npy`` is the raw
    codec every host has)."""
    from .image import imencode
    return pack(header, imencode(img, img_fmt, quality))
