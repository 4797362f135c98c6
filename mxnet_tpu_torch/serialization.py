"""Tensor-dict serialization formats.

Counterpart of ``mxnet_tpu/serialization.py`` (numpy and the standard
library only), with the same formats and behaviour: npz (the format
behind ``Block.save_parameters``), **safetensors** (an 8-byte
little-endian header length, a JSON header mapping tensor name ->
{dtype, shape, data_offsets}, then raw little-endian buffers) and the
legacy Apache MXNet NDArray binary format (``.params``), plus
crash-atomic writes and ``.sha256`` sidecars.

    save_safetensors(path, {"w": array, ...})
    tensors = load_safetensors(path)

Values are numpy arrays. numpy has no bfloat16 here: the port's blocks
hand bf16 parameters over widened to float32 (``functional.
param_arrays``, exact), and a BF16 record of a file (safetensors ``BF16``,
legacy type flag 12) loads widened to float32, exactly;
``Block.load_parameters`` rounds it back into a bf16 parameter. The
reference's fault-injection site is here too: ``serialization.torn_write``
truncates what ``atomic_write_bytes`` persists, and checksum validation is
the recovery that catches it.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import struct

import numpy as onp

from .base import MXNetError

__all__ = ["save_safetensors", "load_safetensors",
           "save_legacy_params", "load_legacy_params", "is_legacy_params",
           "atomic_write_bytes", "write_checksum", "verify_checksum",
           "CHECKSUM_SUFFIX"]

CHECKSUM_SUFFIX = ".sha256"


def _clean_stale_tmp(path):
    """Drop temp files a crashed earlier save left next to ``path``
    (``<name>.tmp-*``) so interrupted-then-retried saves don't accumulate
    garbage in the checkpoint directory."""
    d = os.path.dirname(os.path.abspath(path))
    base = os.path.basename(path) + ".tmp-"
    try:
        names = os.listdir(d)
    except OSError:
        return
    for n in names:
        if n.startswith(base):
            with contextlib.suppress(OSError):
                os.remove(os.path.join(d, n))


def atomic_write_bytes(path, data):
    """Crash-atomic file write: same-directory temp file + fsync +
    ``os.replace``.  A reader (or a crash at any point) observes either
    the old ``path`` or the complete new one, never a torn file — the
    failure mode the reference's plain ``open(path, 'wb')`` checkpointing
    is exposed to.

    Checksum validation (``write_checksum`` / ``verify_checksum``) catches
    what atomic replace cannot prevent: disk-level corruption.

    Injection: ``serialization.torn_write`` silently truncates the
    persisted bytes — emulating disk/filesystem-level corruption that
    atomic replace cannot prevent.
    """
    from . import fault as _fault
    data = data if isinstance(data, (bytes, bytearray, memoryview)) \
        else bytes(data)
    persisted = data
    if _fault._active and _fault.fire("serialization.torn_write"):
        persisted = data[:max(1, len(data) // 2)]
    _clean_stale_tmp(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(persisted)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
    return path


def write_checksum(path):
    """Write a ``path + '.sha256'`` sidecar holding the hex digest of the
    file's current bytes.  Ordering guarantee: the sidecar is written
    *after* the data file, so a crash between the two leaves a checkpoint
    that fails validation (rejected, older one used) — never a corrupt
    checkpoint that passes."""
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    atomic_write_bytes(path + CHECKSUM_SUFFIX, digest.encode())
    return digest


def verify_checksum(path, required=False):
    """Validate ``path`` against its ``.sha256`` sidecar.

    Returns True when the digest matches, None when no sidecar exists and
    ``required`` is False.  Raises :class:`MXNetError` on mismatch (torn/
    corrupt file) or on a missing sidecar with ``required=True``.
    """
    side = path + CHECKSUM_SUFFIX
    if not os.path.exists(side):
        if required:
            raise MXNetError(f"{path}: checksum sidecar {side} missing")
        return None
    with open(side, "rb") as f:
        want = f.read().decode().strip()
    with open(path, "rb") as f:
        have = hashlib.sha256(f.read()).hexdigest()
    if have != want:
        raise MXNetError(
            f"{path}: checksum mismatch (file {have[:12]}.. vs recorded "
            f"{want[:12]}..) — torn or corrupt checkpoint; falling back "
            "to an older checkpoint is the intended recovery")
    return True

# safetensors dtype tags <-> numpy
_DTYPES = {
    "F64": "float64", "F32": "float32", "F16": "float16", "BF16": "bfloat16",
    "I64": "int64", "I32": "int32", "I16": "int16", "I8": "int8",
    "U64": "uint64", "U32": "uint32", "U16": "uint16", "U8": "uint8",
    "BOOL": "bool",
}
_NP2TAG = {v: k for k, v in _DTYPES.items()}


def _np_dtype(tag):
    """The numpy dtype a record of ``tag`` is read as (bf16: its raw
    uint16 bits, widened by :func:`_widen_bf16`)."""
    if tag not in _DTYPES:
        raise MXNetError(f"safetensors dtype {tag!r} unsupported")
    name = _DTYPES[tag]
    return onp.dtype("<u2" if name == "bfloat16" else name)


def _widen_bf16(bits):
    """bf16 values given as uint16 bits -> float32 (exact)."""
    return (bits.astype(onp.uint32) << 16).view(onp.float32)




def save_safetensors(path, tensors, metadata=None):
    """Write a dict name -> numpy array to `path`."""
    arrays = {}
    header = {}
    offset = 0
    for name in sorted(tensors):
        arr = onp.ascontiguousarray(tensors[name])
        if arr.dtype.byteorder == ">":
            arr = arr.byteswap().view(arr.dtype.newbyteorder("<"))
        tag = _NP2TAG.get(str(arr.dtype))
        if tag is None:
            raise MXNetError(f"{name}: dtype {arr.dtype} has no "
                             "safetensors mapping")
        n = arr.nbytes
        header[name] = {"dtype": tag, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + n]}
        arrays[name] = arr
        offset += n
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode()
    pad = (8 - len(blob) % 8) % 8          # spec: align data to 8 bytes
    blob += b" " * pad
    payload = b"".join([struct.pack("<Q", len(blob)), blob]
                       + [arrays[name].tobytes() for name in sorted(arrays)])
    return atomic_write_bytes(path, payload)


def load_safetensors(path, return_metadata=False):
    """Read a safetensors file -> dict name -> numpy array."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode())
        data = f.read()
    metadata = header.pop("__metadata__", {})
    out = {}
    for name, info in header.items():
        lo, hi = info["data_offsets"]
        arr = onp.frombuffer(data[lo:hi], dtype=_np_dtype(info["dtype"]))
        arr = arr.reshape(info["shape"]).copy()
        out[name] = _widen_bf16(arr) if info["dtype"] == "BF16" else arr
    if return_metadata:
        return out, metadata
    return out


# ---------------------------------------------------------------------------
# legacy MXNet NDArray binary format (.params files)
# ---------------------------------------------------------------------------
#
# Reference: src/ndarray/ndarray.cc NDArray::Save/Load (list container at
# :2123 kMXAPINDArrayListMagic=0x112; per-array V1/V2/V3 records at
# :1851-1864) over dmlc::Stream. Byte-level layout (little-endian):
#
#   u64 0x112, u64 reserved,
#   u64 n_arrays, then per array:
#     u32 magic (V2=0xF993FAC9 | V3=0xF993FACA | V1=0xF993FAC8 | ndim),
#     [V2/V3] i32 stype (0=dense; sparse adds a storage TShape),
#     TShape: i32 ndim + ndim*i64 dims,
#     i32 dev_type, i32 dev_id,
#     i32 mshadow type_flag, raw data bytes
#   u64 n_names, then per name: u64 len + bytes
#
# Implementing this independently gives real interop: `.params` files
# written by Apache MXNet load here, and vice versa.

_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9
_V3_MAGIC = 0xF993FACA

# mshadow type flags (3rdparty/mshadow/mshadow/base.h:352-364)
_TYPE_FLAGS = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
               4: "int32", 5: "int8", 6: "int64", 7: "bool"}
_FLAG_OF = {v: k for k, v in _TYPE_FLAGS.items()}
_BF16_FLAG = 12


def _np_from_flag(flag):
    if flag == _BF16_FLAG:
        return onp.dtype("<u2")  # raw bits, widened after the read
    if flag not in _TYPE_FLAGS:
        raise MXNetError(f"legacy type_flag {flag} unsupported")
    return onp.dtype(_TYPE_FLAGS[flag])


def _flag_of(dtype):
    name = str(onp.dtype(dtype)) if str(dtype) != "bfloat16" else "bfloat16"
    if name == "bfloat16":
        return _BF16_FLAG
    if name not in _FLAG_OF:
        raise MXNetError(f"dtype {name} has no legacy type_flag")
    return _FLAG_OF[name]


def save_legacy_params(path, tensors):
    """Write arrays in the Apache MXNet .params binary format (loadable
    by `mxnet.nd.load`).  `tensors` is a name->array dict (names stored)
    or a list (no names, loads back as a list — reference behavior)."""
    if isinstance(tensors, dict):
        names = list(tensors)
        values = [tensors[n] for n in names]
    else:
        names = []
        values = list(tensors)
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(values)))
        for v in values:
            arr = onp.ascontiguousarray(v)
            # V3 for 0-d (np-shape semantics); V2 otherwise (1.x compat)
            magic = _V3_MAGIC if arr.ndim == 0 else _V2_MAGIC
            f.write(struct.pack("<I", magic))
            f.write(struct.pack("<i", 0))                    # dense stype
            f.write(struct.pack("<i", arr.ndim))
            for d in arr.shape:
                f.write(struct.pack("<q", d))
            f.write(struct.pack("<ii", 1, 0))                # cpu(0)
            f.write(struct.pack("<i", _flag_of(arr.dtype)))
            f.write(arr.tobytes())
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode()
            f.write(struct.pack("<Q", len(b)))
            f.write(b)
    return path


def load_legacy_params(path):
    """Read an Apache MXNet .params binary file -> dict name->numpy.

    Handles V1/V2/V3 records plus the pre-V1 layout where the magic
    field is the ndim of a uint32 shape (ndarray.cc LegacyTShapeLoad).
    """
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def take(fmt):
        nonlocal off
        try:
            vals = struct.unpack_from("<" + fmt, data, off)
        except struct.error as e:
            raise MXNetError(
                f"{path}: truncated/corrupt legacy NDArray file "
                f"(at byte {off}): {e}") from e
        off += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    header, _reserved = take("QQ")
    if header != _LIST_MAGIC:
        raise MXNetError(f"{path} is not a legacy NDArray file "
                         f"(magic {header:#x})")
    n = take("Q")
    arrays = []
    for _ in range(n):
        magic = take("I")
        if magic in (_V2_MAGIC, _V3_MAGIC):
            stype = take("i")
            if stype != 0:
                raise MXNetError("sparse records in legacy files are not "
                                 "supported; re-save densely")
            ndim = take("i")
            shape = [take("q") for _ in range(ndim)]
            if magic == _V2_MAGIC and ndim == 0:
                arrays.append(onp.zeros(0, "float32"))
                continue
        elif magic == _V1_MAGIC:
            ndim = take("i")
            shape = [take("q") for _ in range(ndim)]
            if ndim == 0:
                arrays.append(onp.zeros(0, "float32"))
                continue
        else:  # pre-V1: magic is ndim, dims are uint32
            ndim = magic
            shape = [take("I") for _ in range(ndim)]
            if ndim == 0:
                arrays.append(onp.zeros(0, "float32"))
                continue
        take("ii")                                   # context
        flag = take("i")
        dt = _np_from_flag(flag)
        count = 1
        for d in shape:
            if d < 0:
                raise MXNetError(f"{path}: corrupt legacy NDArray file "
                                 f"(negative dim {d} in shape {shape})")
            count *= d
        nbytes = count * dt.itemsize
        if len(data) - off < nbytes:
            raise MXNetError(f"{path}: truncated legacy NDArray file "
                             f"(record needs {nbytes} bytes at {off})")
        arr = onp.frombuffer(data, dt, count=count,
                             offset=off).reshape(shape).copy()
        if flag == _BF16_FLAG:
            arr = _widen_bf16(arr)
        off += nbytes
        arrays.append(arr)
    n_names = take("Q")
    names = []
    for _ in range(n_names):
        ln = take("Q")
        if len(data) - off < ln:
            raise MXNetError(f"{path}: truncated name section")
        names.append(data[off:off + ln].decode())
        off += ln
    if names and len(names) != len(arrays):
        raise MXNetError("corrupt legacy file: name/array count mismatch")
    if not names:
        return arrays   # unnamed save -> list (reference load behavior)
    return dict(zip(names, arrays))


def is_legacy_params(path):
    try:
        with open(path, "rb") as f:
            return struct.unpack("<Q", f.read(8))[0] == _LIST_MAGIC
    except (OSError, struct.error):
        return False
