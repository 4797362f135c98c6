"""mx.stream — the deterministic sharded streaming data plane.

Copy of ``mxnet_tpu/stream.py`` (host-only: RecordIO shards, numpy seeds,
JSON cursors), so a shard set either package writes reads in the other
and the two draw the same epoch plans from the same seed.

- **Shards**: :class:`ShardWriter` packs records round-robin into N
  ``shard-*.rec`` / ``.idx`` archives plus a ``manifest.json``. Every
  record carries a 12-byte envelope (``<QI`` global record id + crc32 of
  the payload), so corruption is caught per record. Global record id
  ``g`` lives in shard ``g % N`` at key ``g // N``.
- **Determinism**: :class:`EpochPlan` derives the shard order from a
  seeded permutation of ``(seed, epoch)`` and each shard's sample order
  from ``(seed, epoch, shard)``.
- **Assignment**: the shard at position ``p`` of the shuffled order
  belongs to host ``p % dp``.
- **Cursor**: :class:`StreamSampler` is a DataLoader batch sampler whose
  ``state_dict(cursor=served_batches)`` snapshots the epoch's work items
  and the served-batch count; it rides the ``TrainState`` bundle through
  the ``loader`` slot and replays bit for bit.
- **Reassignment**: :meth:`StreamSampler.take_over_host` deals a dead
  host's remaining work (rolled forward from its published
  ``stream-<rank>.json`` cursor) across the survivors, each shard adopted
  exactly once.
- **Robustness**: per-record checksums with the ``stream.torn_record`` /
  ``stream.shard_unreadable`` fault points; ``stream.on_corrupt`` picks
  skip-with-count or a structured :class:`CorruptRecord`; shard opens
  retry with bounded backoff and escalate a WorkerLost-style
  :class:`ShardUnreadable`, never a hang. Disabled, every hook is one
  module-attribute read.
"""
from __future__ import annotations

import binascii
import io
import json
import os
import struct
import threading
import time

import numpy as onp

from . import config as _config
from . import fault as _fault
from . import telemetry as _telemetry
from . import trace as _trace
from .base import MXNetError
from .recordio import MXIndexedRecordIO, RecordIOCorrupt
from .resilience import WorkerLost

__all__ = ["ShardWriter", "ShardManifest", "StreamDataset", "StreamSampler",
           "EpochPlan", "CorruptRecord", "ShardUnreadable", "encode_record",
           "decode_record", "pack_sample", "unpack_sample",
           "validate_manifest", "read_cursor", "remaining_items"]

_telemetry.declare_metric(
    "stream.shards_assigned", "gauge",
    "shards this host owns for the epoch in progress (adopted shards "
    "from dead peers included)")
_telemetry.declare_metric(
    "stream.shards_completed_total", "counter",
    "shards this host served to the end (every record of the shard's "
    "epoch order emitted)")
_telemetry.declare_metric(
    "stream.shards_reassigned_total", "counter",
    "shards adopted from dead hosts via take_over_host — each exactly "
    "once per epoch")
_telemetry.declare_metric(
    "stream.records_served_total", "counter",
    "records read, checksum-verified and handed to the consumer")
_telemetry.declare_metric(
    "stream.records_skipped_total", "counter",
    "corrupt records dropped under stream.on_corrupt=skip")
_telemetry.declare_metric(
    "stream.open_retries_total", "counter",
    "shard-open attempts that failed and were retried with backoff")


def _count(name, n=1):
    if _telemetry._active:
        _telemetry.inc(name, n)


def _gauge(name, value):
    if _telemetry._active:
        _telemetry.set_gauge(name, value)


def _note_served(n=1):
    """The per-record hot-path hook."""
    if _telemetry._active:
        _telemetry.inc("stream.records_served_total", n)


# ---------------------------------------------------------------------------
# record envelope
# ---------------------------------------------------------------------------

_REC_FORMAT = "<QI"       # global record id, crc32(payload)
_REC_SIZE = struct.calcsize(_REC_FORMAT)


class CorruptRecord(MXNetError):
    """A streamed record failed validation.  Structured so policy code
    can dispatch on the fields: ``shard`` (archive basename), ``record_id``
    (global id, None when the envelope itself is unreadable), ``kind``
    (``checksum`` | ``short_envelope`` | ``id_mismatch`` | ``missing`` |
    ``torn_tail`` | ``bad_magic``)."""

    def __init__(self, shard, record_id, kind, detail=""):
        self.shard = shard
        self.record_id = record_id
        self.kind = kind
        extra = f": {detail}" if detail else ""
        super().__init__(
            f"corrupt record {record_id} in shard {shard!r} [{kind}]{extra}")


class ShardUnreadable(WorkerLost):
    """A shard archive could not be opened after the bounded
    retry-with-backoff budget — the data-plane analog of a collective
    that exhausted its retries, so it reuses the WorkerLost structure
    (``op``/``key``/``attempts``/``last``) supervisors already dispatch
    on."""

    def __init__(self, shard, rank, attempts, last):
        super().__init__(op="shard_open", key=shard, rank=rank, nprocs=1,
                         attempts=attempts, last=last)
        self.shard = shard


def encode_record(record_id, payload):
    """Wrap ``payload`` bytes in the checksummed stream envelope."""
    crc = binascii.crc32(payload) & 0xffffffff
    return struct.pack(_REC_FORMAT, int(record_id), crc) + payload


def decode_record(buf, shard="?", expect_id=None):
    """Validate and strip the envelope: returns ``(record_id, payload)``
    or raises :class:`CorruptRecord`."""
    if buf is None or len(buf) < _REC_SIZE:
        raise CorruptRecord(shard, expect_id, "short_envelope",
                            f"{0 if buf is None else len(buf)} bytes")
    rid, crc = struct.unpack(_REC_FORMAT, buf[:_REC_SIZE])
    payload = buf[_REC_SIZE:]
    if binascii.crc32(payload) & 0xffffffff != crc:
        raise CorruptRecord(shard, rid, "checksum")
    if expect_id is not None and rid != int(expect_id):
        raise CorruptRecord(shard, rid, "id_mismatch",
                            f"expected {expect_id}")
    return rid, payload


def pack_sample(*arrays):
    """Serialize numpy arrays into one payload (npz container)."""
    bio = io.BytesIO()
    onp.savez(bio, *[onp.asarray(a) for a in arrays])
    return bio.getvalue()


def unpack_sample(payload):
    """Inverse of :func:`pack_sample`: one array, or a tuple of them."""
    with onp.load(io.BytesIO(payload)) as z:
        arrays = [z[k] for k in z.files]
    return arrays[0] if len(arrays) == 1 else tuple(arrays)


# ---------------------------------------------------------------------------
# shard archives + manifest
# ---------------------------------------------------------------------------

MANIFEST_NAME = "manifest.json"


class ShardWriter:
    """Pack records round-robin into N checksummed shard archives.

    Record ``g`` goes to shard ``g % num_shards`` at key
    ``g // num_shards`` — the id→location map every reader derives
    without a table.  ``close()`` writes the manifest and returns its
    path."""

    def __init__(self, out_dir, num_shards, prefix="shard"):
        if num_shards < 1:
            raise MXNetError(f"num_shards={num_shards} must be >= 1")
        self.out_dir = out_dir
        self.num_shards = int(num_shards)
        self.prefix = prefix
        os.makedirs(out_dir, exist_ok=True)
        self._names = [f"{prefix}-{i:05d}" for i in range(self.num_shards)]
        self._writers = [
            MXIndexedRecordIO(os.path.join(out_dir, n + ".idx"),
                              os.path.join(out_dir, n + ".rec"), "w")
            for n in self._names]
        self._counts = [0] * self.num_shards
        self.total = 0

    def append(self, payload):
        """Append one record; returns its global record id."""
        gid = self.total
        s = gid % self.num_shards
        self._writers[s].write_idx(gid // self.num_shards,
                                   encode_record(gid, payload))
        self._counts[s] += 1
        self.total += 1
        return gid

    def close(self):
        for w in self._writers:
            w.close()
        doc = {"version": 1, "assignment": "round_robin",
               "num_shards": self.num_shards, "total_records": self.total,
               "shards": [{"rec": n + ".rec", "idx": n + ".idx",
                           "records": c}
                          for n, c in zip(self._names, self._counts)]}
        path = os.path.join(self.out_dir, MANIFEST_NAME)
        from .serialization import atomic_write_bytes
        atomic_write_bytes(path, json.dumps(doc, indent=1).encode())
        return path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShardManifest:
    """Parsed manifest: shard entries with paths resolved against the
    manifest's directory."""

    def __init__(self, doc, root):
        if doc.get("version") != 1:
            raise MXNetError(f"unsupported manifest version "
                             f"{doc.get('version')!r}")
        self.root = root
        self.num_shards = int(doc["num_shards"])
        self.total_records = int(doc["total_records"])
        self.shards = doc["shards"]
        if len(self.shards) != self.num_shards:
            raise MXNetError(
                f"manifest lists {len(self.shards)} shards, "
                f"num_shards={self.num_shards}")

    @classmethod
    def load(cls, path):
        if os.path.isdir(path):
            path = os.path.join(path, MANIFEST_NAME)
        with open(path) as f:
            return cls(json.load(f), os.path.dirname(os.path.abspath(path)))

    def rec_path(self, shard_idx):
        return os.path.join(self.root, self.shards[shard_idx]["rec"])

    def idx_path(self, shard_idx):
        return os.path.join(self.root, self.shards[shard_idx]["idx"])

    def records(self, shard_idx):
        return int(self.shards[shard_idx]["records"])


def _as_manifest(manifest):
    if isinstance(manifest, ShardManifest):
        return manifest
    return ShardManifest.load(manifest)


def validate_manifest(manifest):
    """Re-read every record of every shard and verify its checksum and
    id.  Returns a
    summary dict; corruption lands in ``errors`` instead of raising so
    one torn shard doesn't hide the rest."""
    m = _as_manifest(manifest)
    errors = []
    records = 0
    for s in range(m.num_shards):
        try:
            rdr = MXIndexedRecordIO(m.idx_path(s), m.rec_path(s), "r")
        except OSError as e:
            errors.append(f"shard {s}: unreadable: {e}")
            continue
        try:
            for key in range(m.records(s)):
                gid = key * m.num_shards + s
                try:
                    decode_record(rdr.read_idx(key),
                                  shard=m.shards[s]["rec"], expect_id=gid)
                    records += 1
                except (KeyError, CorruptRecord, RecordIOCorrupt) as e:
                    errors.append(f"shard {s} record {gid}: {e}")
        finally:
            rdr.close()
    return {"shards": m.num_shards, "records": records,
            "expected_records": m.total_records, "errors": errors,
            "ok": not errors and records == m.total_records}


# ---------------------------------------------------------------------------
# epoch plan: seeded shard shuffle + within-shard seeded sample shuffle
# ---------------------------------------------------------------------------

def _seed32(*parts):
    return int(onp.random.SeedSequence(list(parts)).generate_state(1)[0])


class EpochPlan:
    """The epoch as a pure function of ``(seed, epoch)``: a seeded
    permutation of the shards, and per shard a seeded permutation of its
    records (global ids)."""

    def __init__(self, manifest, seed, epoch):
        self.manifest = _as_manifest(manifest)
        self.seed = int(seed)
        self.epoch = int(epoch)
        self.shard_order = onp.random.RandomState(
            _seed32(self.seed, self.epoch)) \
            .permutation(self.manifest.num_shards).tolist()

    def shard_records(self, shard_idx):
        """This shard's record ids in the epoch's serving order."""
        n = self.manifest.records(shard_idx)
        perm = onp.random.RandomState(
            _seed32(self.seed, self.epoch, shard_idx + 1)).permutation(n)
        num = self.manifest.num_shards
        return [int(k) * num + shard_idx for k in perm]

    def host_shards(self, rank, dp):
        """Shards owned by ``rank`` on a ``dp``-way mesh: position ``p``
        of the shuffled order belongs to host ``p % dp``."""
        dp = max(1, int(dp))
        return [s for p, s in enumerate(self.shard_order) if p % dp == rank]


# ---------------------------------------------------------------------------
# dataset facade (random access by global record id)
# ---------------------------------------------------------------------------

_seq_lock = threading.Lock()
_open_seq = 0      # global shard-open attempt counter (fault injection key)
_read_seq = 0      # global record-read counter (fault injection key)


class StreamDataset:
    """Random-access facade over the shard set: index = global record
    id.  Plugs into the existing DataLoader machinery (thread pool,
    spawn workers + shm ring, device prefetch) unchanged; the
    ``sample_batch`` hook additionally carries the corrupt-record
    policy, which per-item ``__getitem__`` cannot express (a skipped
    record must shrink the batch, not return a placeholder)."""

    def __init__(self, manifest, transform=None):
        self._manifest = _as_manifest(manifest)
        self._transform = transform
        self._readers = {}
        self._lock = threading.Lock()

    @property
    def manifest(self):
        return self._manifest

    def __len__(self):
        return self._manifest.total_records

    # readers are per-process: spawn workers re-open lazily
    def __getstate__(self):
        d = dict(self.__dict__)
        d["_readers"] = {}
        d["_lock"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()

    def _open(self, shard_idx):
        """Open (and cache) one shard reader, with bounded
        retry-with-backoff; exhaustion escalates :class:`ShardUnreadable`
        — a structured failure, never a hang."""
        global _open_seq
        rdr = self._readers.get(shard_idx)
        if rdr is not None:
            return rdr
        name = self._manifest.shards[shard_idx]["rec"]
        retries = max(0, int(_config.get("stream.open_retries")))
        backoff = float(_config.get("stream.open_backoff"))
        last = None
        for attempt in range(1, retries + 2):
            with _seq_lock:
                _open_seq += 1
                seq = _open_seq
            try:
                if _fault._active and _fault.fire("stream.shard_unreadable",
                                                  step=seq):
                    raise OSError(f"injected open failure for {name} "
                                  "(stream.shard_unreadable)")
                with _trace.span("stream.shard_open", category="stream",
                                 shard=name, attempt=attempt):
                    rdr = MXIndexedRecordIO(self._manifest.idx_path(shard_idx),
                                            self._manifest.rec_path(shard_idx),
                                            "r")
                self._readers[shard_idx] = rdr
                return rdr
            except OSError as e:
                last = e
                if attempt <= retries:
                    _count("stream.open_retries_total")
                    time.sleep(backoff * attempt)
        _fault.record("stream.shard_lost")
        raise ShardUnreadable(shard=name, rank=0, attempts=retries + 1,
                              last=last)

    def _read(self, gid):
        """Read + validate one record; returns ``(record_id, payload)``."""
        global _read_seq
        gid = int(gid)
        if not 0 <= gid < self._manifest.total_records:
            raise MXNetError(f"record id {gid} outside "
                             f"[0, {self._manifest.total_records})")
        shard_idx = gid % self._manifest.num_shards
        key = gid // self._manifest.num_shards
        name = self._manifest.shards[shard_idx]["rec"]
        rdr = self._open(shard_idx)
        with self._lock:     # readers seek: one reader position per process
            if _fault._active:
                with _seq_lock:
                    _read_seq += 1
                    seq = _read_seq
                torn = _fault.fire("stream.torn_record", step=seq)
            else:
                torn = False
            try:
                buf = rdr.read_idx(key)
            except KeyError:
                raise CorruptRecord(name, gid, "missing",
                                    "key absent from shard index")
        if torn and buf and len(buf) > _REC_SIZE:
            # flip one payload byte BEFORE verification: the checksum,
            # not the injection, is what must catch it
            pos = _REC_SIZE + (gid % (len(buf) - _REC_SIZE))
            buf = buf[:pos] + bytes([buf[pos] ^ 0xFF]) + buf[pos + 1:]
        rid, payload = decode_record(buf, shard=name, expect_id=gid)
        _note_served(1)
        return rid, payload

    def __getitem__(self, gid):
        """Per-item access always raises on corruption — the skip policy
        needs batch context (see :meth:`sample_batch`)."""
        payload = self._read(gid)[1]
        return self._transform(payload) if self._transform else payload

    def sample_batch(self, gids):
        """Batch fetch with the ``stream.on_corrupt`` policy applied:
        ``skip`` drops corrupt records (counted), ``raise`` escalates the
        structured :class:`CorruptRecord`."""
        policy = _config.get("stream.on_corrupt")
        out = []
        for gid in gids:
            try:
                payload = self._read(gid)[1]
            except CorruptRecord:
                if policy != "skip":
                    raise
                _count("stream.records_skipped_total")
                _fault.record("stream.record_skipped")
                continue
            out.append(self._transform(payload) if self._transform
                       else payload)
        if gids and not out:
            raise CorruptRecord(None, None, "checksum",
                                f"all {len(gids)} records of the batch "
                                "corrupt under skip policy")
        return out


# ---------------------------------------------------------------------------
# cursor publication (shared dir, HealthPlane-lease idiom)
# ---------------------------------------------------------------------------

CURSOR_PREFIX = "stream-"


def _cursor_path(cursor_dir, rank):
    return os.path.join(cursor_dir, f"{CURSOR_PREFIX}{int(rank)}.json")


def read_cursor(cursor_dir, rank):
    """A host's last published cursor, or None (absent or torn —
    readers never see a partial file thanks to the tmp+replace write,
    but a missing one is normal before the first checkpoint)."""
    try:
        with open(_cursor_path(cursor_dir, rank)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def remaining_items(manifest, state):
    """Roll a published cursor forward: the ``[shard, offset]`` work its
    owner had NOT yet served when the cursor was taken.  The cursor's
    ``consumed`` record count (falling back to ``cursor * batch_size``
    for pre-field cursors) is walked through the item list in order."""
    m = _as_manifest(manifest)
    consumed = int(state.get(
        "consumed", int(state["cursor"]) * int(state["batch_size"])))
    out = []
    for shard, off in state["items"]:
        avail = m.records(int(shard)) - int(off)
        take = min(avail, consumed)
        consumed -= take
        if take < avail:
            out.append([int(shard), int(off) + take])
    return out


# ---------------------------------------------------------------------------
# the streaming batch sampler (the cursor lives here)
# ---------------------------------------------------------------------------

class StreamSampler:
    """DataLoader batch sampler over this host's shard assignment.

    The epoch's work is a list of ``[shard, start_offset]`` items walked
    in order, batches spanning shard boundaries; the cursor is exactly
    ``(shard list, seed, offset)``: ``state_dict(cursor=k)`` records the
    epoch-start items, ``k`` served batches and the record count those
    batches held, and resume regenerates the identical epoch and skips
    that many *records* — bitwise batch parity with the uninterrupted
    run, and exact multiplicity even when shards were adopted after a
    partial tail batch.  The DataLoader drives the
    ``cursor=`` argument with its consumer-side served count, so the
    cursor that lands in the TrainState bundle never counts prefetched-
    but-unconsumed batches.
    """

    def __init__(self, manifest, batch_size, seed=0, dp=1, rank=0,
                 last_batch="keep", cursor_dir=None):
        if batch_size < 1:
            raise MXNetError(f"batch_size={batch_size} must be >= 1")
        if not 0 <= int(rank) < max(1, int(dp)):
            raise MXNetError(f"rank={rank} outside dp={dp}")
        if last_batch not in ("keep", "discard"):
            raise MXNetError(f"last_batch={last_batch!r} not in "
                             "('keep', 'discard')")
        self._manifest = _as_manifest(manifest)
        self._bs = int(batch_size)
        self._seed = int(seed)
        self._dp = max(1, int(dp))
        self._rank = int(rank)
        self._last_batch = last_batch
        self._cursor_dir = cursor_dir
        self._epoch = 0
        self._resume = None
        self._epoch_items = []   # [[shard, start_offset], ...] at epoch start
        self._pending = []       # live queue: [[shard, next_offset], ...]
        self._emitted = 0        # batches generated this epoch
        self._k0 = 0             # batches the current epoch resumed past
        self._cum = [0]          # records consumed after k0+j batches
        self._adopted = set()    # (epoch, shard) pairs taken over — once
        self._lock = threading.Lock()

    # -- epoch generation -------------------------------------------------

    def _fresh_items(self, epoch, rank=None, dp=None):
        plan = EpochPlan(self._manifest, self._seed, epoch)
        shards = plan.host_shards(self._rank if rank is None else rank,
                                  self._dp if dp is None else dp)
        return [[s, 0] for s in shards]

    def __iter__(self):
        if self._resume is not None:
            st, self._resume = self._resume, None
            self._epoch = int(st["epoch"])
            k0 = int(st.get("cursor", 0))
            to_skip = int(st.get("consumed", k0 * self._bs))
            items = [[int(s), int(o)] for s, o in st["items"]]
        else:
            self._epoch += 1
            k0, to_skip = 0, 0
            items = self._fresh_items(self._epoch)
        plan = EpochPlan(self._manifest, self._seed, self._epoch)
        with self._lock:
            self._epoch_items = [list(it) for it in items]
            self._pending = [list(it) for it in items]
            self._emitted = k0
            self._k0 = k0
            self._cum = [to_skip]
        _gauge("stream.shards_assigned", len(items))
        batch = []

        def _emit(b):
            with self._lock:
                self._emitted += 1
                self._cum.append(self._cum[-1] + len(b))

        while True:
            with self._lock:
                if not self._pending:
                    break
                shard, off = self._pending[0]
            order = plan.shard_records(shard)
            if to_skip:
                # resume skips RECORDS, not batches: batch boundaries may
                # legitimately shift when shards were adopted after this
                # host's own tail batch, but record multiplicity never does
                step = min(to_skip, len(order) - off)
                to_skip -= step
                off += step
                with self._lock:
                    self._pending[0][1] = off
            for i in range(off, len(order)):
                batch.append(order[i])
                with self._lock:
                    self._pending[0][1] = i + 1
                if len(batch) == self._bs:
                    _emit(batch)
                    yield batch
                    batch = []
            with self._lock:
                self._pending.pop(0)
            _count("stream.shards_completed_total")
            _gauge("stream.shards_assigned", len(self._pending))
        if batch and self._last_batch == "keep":
            _emit(batch)
            yield batch

    def __len__(self):
        # next epoch's assignment (or the pending resume's items)
        if self._resume is not None:
            items = self._resume["items"]
            consumed = int(self._resume.get(
                "consumed", int(self._resume.get("cursor", 0)) * self._bs))
        else:
            items = self._fresh_items(self._epoch + 1)
            consumed = 0
        n = sum(self._manifest.records(int(s)) - int(o) for s, o in items)
        n = max(0, n - consumed)
        return ((n + self._bs - 1) // self._bs if self._last_batch == "keep"
                else n // self._bs)

    # -- elastic resume (the TrainState bundle contract) ------------------

    def state_dict(self, cursor=None):
        with self._lock:
            items = [list(it) for it in self._epoch_items]
            cum = list(self._cum)
            k0 = self._k0
            emitted = self._emitted
        k = emitted if cursor is None else int(cursor)
        j = min(max(k - k0, 0), len(cum) - 1)
        consumed = cum[j] if k >= k0 else k * self._bs
        return {"seed": self._seed, "epoch": self._epoch, "cursor": k,
                "consumed": consumed, "batch_size": self._bs,
                "dp": self._dp, "rank": self._rank, "items": items}

    def load_state_dict(self, state):
        if int(state.get("batch_size", self._bs)) != self._bs:
            raise MXNetError(
                f"cursor batch_size {state.get('batch_size')} != sampler "
                f"batch_size {self._bs}: batch boundaries would shift and "
                "the bitwise-replay contract breaks")
        if int(state.get("seed", self._seed)) != self._seed:
            raise MXNetError(
                f"cursor seed {state.get('seed')} != sampler seed "
                f"{self._seed}: the epoch plans differ")
        k = int(state.get("cursor", 0))
        self._resume = {"epoch": int(state["epoch"]), "cursor": k,
                        "consumed": int(state.get("consumed", k * self._bs)),
                        "items": [[int(s), int(o)]
                                  for s, o in state["items"]]}

    def resume_cursor(self):
        """Batches a pending resume will skip (0 when none is pending)."""
        return int(self._resume["cursor"]) if self._resume else 0

    # -- fleet integration: publish + exactly-once take-over --------------

    def publish_cursor(self, cursor=None, cursor_dir=None, rank=None):
        """Atomically publish this host's cursor as
        ``stream-<rank>.json`` next to the heartbeat leases (tmp +
        os.replace, the HealthPlane idiom) so survivors can resume a
        dead host's shards from its last *checkpointed* position.
        Returns the path, or None without a cursor dir."""
        d = cursor_dir or self._cursor_dir or _config.get("fleet.lease_dir")
        if not d:
            return None
        os.makedirs(d, exist_ok=True)
        path = _cursor_path(d, self._rank if rank is None else rank)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(self.state_dict(cursor=cursor)))
        os.replace(tmp, path)
        return path

    def take_over_host(self, dead_rank, survivors=None, cursor_dir=None):
        """Adopt this host's share of a dead host's unfinished shards.

        The dead host's remaining work is rolled forward from its last
        published cursor (no cursor = no durable progress: its whole
        epoch share restarts at offset 0).  Work item ``j`` goes to
        ``survivors[j % len(survivors)]`` — every survivor runs the same
        deterministic split, so each shard lands on exactly one of them;
        a per-epoch adopted-set makes re-entry (double lose_host, two
        supervisors racing) a no-op.  Returns the number of shards
        adopted locally."""
        dead_rank = int(dead_rank)
        d = cursor_dir or self._cursor_dir or _config.get("fleet.lease_dir")
        st = read_cursor(d, dead_rank) if d else None
        if (st is not None and int(st.get("epoch", -1)) == self._epoch
                and int(st.get("seed", self._seed)) == self._seed):
            items = remaining_items(self._manifest, st)
        else:
            # pre-checkpoint death (or another epoch's stale cursor):
            # nothing it served was durable, re-serve its share in full
            items = self._fresh_items(
                self._epoch, rank=dead_rank,
                dp=int(st["dp"]) if st else self._dp)
        alive = sorted(h for h in (survivors if survivors is not None
                                   else [self._rank]) if h != dead_rank)
        if self._rank not in alive:
            return 0
        mine = [it for j, it in enumerate(items)
                if alive[j % len(alive)] == self._rank]
        adopted = 0
        with self._lock:
            for shard, off in mine:
                key = (self._epoch, int(shard))
                if key in self._adopted:
                    continue     # exactly once
                self._adopted.add(key)
                self._pending.append([int(shard), int(off)])
                self._epoch_items.append([int(shard), int(off)])
                adopted += 1
            assigned = len(self._pending)
        if adopted:
            _count("stream.shards_reassigned_total", adopted)
            _gauge("stream.shards_assigned", assigned)
            with _trace.span("stream.reassign", category="stream",
                             dead_host=dead_rank, shards=adopted,
                             survivor=self._rank):
                pass
        _fault.record("stream.take_over")
        return adopted
