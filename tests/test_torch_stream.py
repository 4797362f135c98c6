"""Port parity: ``mx.stream`` — checksummed shard writing and reading,
the seeded epoch plan, the StreamSampler cursor and its bit-for-bit
resume through a DataLoader (inline, threads, two spawned workers),
dp partitions and the exactly-once take-over, corrupt records under both
``stream.on_corrupt`` policies, and shard loss escalating a structured
``ShardUnreadable`` (a ``resilience.WorkerLost``) after the bounded retry
budget.

A shard set either package writes reads in the other: the files are
compared byte for byte, and every plan, batch and cursor is held equal
to the JAX package's on the same seeds.
"""
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import stream as jstream
from mxnet_tpu.gluon.data import DataLoader as JLoader

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import stream as tstream
from mxnet_tpu_torch.gluon.data import DataLoader as TLoader

torch.set_num_threads(2)

N_RECORDS = 53
N_SHARDS = 4


@pytest.fixture(autouse=True)
def _isolated():
    for pkg in (mx, tmx):
        pkg.fault.clear()
        pkg.fault.reset_stats()
        pkg.config.reset()
        pkg.telemetry.disable()
        pkg.telemetry.reset()
    with tmx.cpu():
        yield
    for pkg in (mx, tmx):
        pkg.fault.clear()
        pkg.fault.reset_stats()
        pkg.config.reset()
        pkg.telemetry.disable()
        pkg.telemetry.reset()


def _write(mod, d):
    with mod.ShardWriter(d, N_SHARDS) as w:
        for g in range(N_RECORDS):
            w.append(mod.pack_sample(onp.full((3,), g, dtype=onp.float32),
                                     onp.int32(g % 5)))
    return d


@pytest.fixture
def shards(tmp_path):
    return _write(tstream, str(tmp_path / "t"))


def _ids(batches):
    return [g for b in batches for g in b]


def test_shards_are_the_jax_packages_bytes(tmp_path):
    t = _write(tstream, str(tmp_path / "t"))
    j = _write(jstream, str(tmp_path / "j"))
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))
    for name in os.listdir(t):
        assert open(os.path.join(t, name), "rb").read() == \
            open(os.path.join(j, name), "rb").read(), name
    # each reads the other's
    jd = jstream.StreamDataset(t, transform=jstream.unpack_sample)
    td = tstream.StreamDataset(j, transform=tstream.unpack_sample)
    for g in (0, 1, 17, N_RECORDS - 1):
        (jx, jy), (tx, ty) = jd[g], td[g]
        onp.testing.assert_array_equal(tx, jx)
        assert int(ty) == int(jy) == g % 5
    for mod, d in ((tstream, j), (jstream, t)):
        rep = mod.validate_manifest(d)
        assert rep["ok"] and rep["records"] == N_RECORDS


def test_manifest_and_envelope(shards):
    m = tstream.ShardManifest.load(shards)
    assert m.num_shards == N_SHARDS and m.total_records == N_RECORDS
    assert [m.records(s) for s in range(N_SHARDS)] == [14, 13, 13, 13]
    buf = tstream.encode_record(7, b"payload bytes")
    assert buf == jstream.encode_record(7, b"payload bytes")
    assert tstream.decode_record(buf) == (7, b"payload bytes")
    flipped = buf[:-3] + bytes([buf[-3] ^ 0xFF]) + buf[-2:]
    with pytest.raises(tstream.CorruptRecord) as ei:
        tstream.decode_record(flipped, shard="s0")
    assert ei.value.kind == "checksum" and ei.value.shard == "s0"
    with pytest.raises(tstream.CorruptRecord, match="id_mismatch"):
        tstream.decode_record(buf, expect_id=8)


def test_validate_manifest_reports_on_disk_corruption(shards):
    rec = tstream.ShardManifest.load(shards).rec_path(1)
    with open(rec, "r+b") as f:
        f.seek(os.path.getsize(rec) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    t, j = tstream.validate_manifest(shards), jstream.validate_manifest(
        shards)
    assert not t["ok"] and t["errors"]
    assert "shard-00001" in t["errors"][0]
    assert len(t["errors"]) == len(j["errors"])


@pytest.mark.parametrize("seed,epoch", [(3, 1), (3, 2), (9, 1)])
def test_epoch_plan_matches_jax(shards, seed, epoch):
    a = tstream.EpochPlan(shards, seed=seed, epoch=epoch)
    b = jstream.EpochPlan(shards, seed=seed, epoch=epoch)
    assert a.shard_order == b.shard_order
    assert [a.shard_records(s) for s in range(N_SHARDS)] == \
        [b.shard_records(s) for s in range(N_SHARDS)]
    for dp in (1, 2, 3):
        parts = [a.host_shards(r, dp) for r in range(dp)]
        assert parts == [b.host_shards(r, dp) for r in range(dp)]
        assert sorted(s for p in parts for s in p) == list(range(N_SHARDS))


@pytest.mark.parametrize("last_batch", ["keep", "discard"])
def test_sampler_epochs_and_cursor_resume_match_jax(shards, last_batch):
    got = {}
    for name, mod in (("jax", jstream), ("torch", tstream)):
        s = mod.StreamSampler(shards, batch_size=4, seed=11,
                              last_batch=last_batch)
        full = list(iter(s))
        second = list(iter(s))
        s = mod.StreamSampler(shards, batch_size=4, seed=11,
                              last_batch=last_batch)
        it = iter(s)
        head = [next(it) for _ in range(3)]
        st = s.state_dict(cursor=3)
        s2 = mod.StreamSampler(shards, batch_size=4, seed=11,
                               last_batch=last_batch)
        s2.load_state_dict(st)
        assert len(s2) == len(full) - 3
        assert head + list(iter(s2)) == full
        got[name] = (full, second, st)
    assert got["torch"] == got["jax"]
    if last_batch == "keep":
        assert sorted(_ids(got["torch"][0])) == list(range(N_RECORDS))


def test_load_state_dict_rejects_mismatched_geometry(shards):
    st = tstream.StreamSampler(shards, batch_size=4, seed=11).state_dict()
    with pytest.raises(tmx.MXNetError, match="batch_size"):
        tstream.StreamSampler(shards, batch_size=8,
                              seed=11).load_state_dict(st)
    with pytest.raises(tmx.MXNetError, match="seed"):
        tstream.StreamSampler(shards, batch_size=4,
                              seed=12).load_state_dict(st)


def _loader(mod, loader_cls, shards, **kw):
    return loader_cls(mod.StreamDataset(shards,
                                        transform=mod.unpack_sample),
                      batch_sampler=mod.StreamSampler(shards, batch_size=4,
                                                      seed=5), **kw)


def _np(batch):
    return [b.asnumpy() for b in batch]


@pytest.mark.parametrize("workers,threads", [(0, None), (2, True),
                                             (2, False)])
def test_dataloader_batches_and_resume_match_jax(shards, workers, threads):
    """Batches through the port's loader (inline, threads, spawned
    workers) equal the JAX loader's; a cursor taken after 3 served batches
    resumes bit for bit."""
    want = [_np(b) for b in _loader(jstream, JLoader, shards)]
    loader = _loader(tstream, TLoader, shards, num_workers=workers,
                     thread_pool=threads)
    it = iter(loader)
    head = [_np(next(it)) for _ in range(3)]
    st = loader.state_dict()
    assert st["cursor"] == 3 and st["consumed"] == 12
    loader.close()
    l2 = _loader(tstream, TLoader, shards, num_workers=workers,
                 thread_pool=threads)
    l2.load_state_dict(st)
    got = head + [_np(b) for b in l2]
    l2.close()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            onp.testing.assert_array_equal(a, b)


def test_dp_partition_and_take_over_match_jax(shards, tmp_path):
    served = []
    for rank in range(2):
        s = tstream.StreamSampler(shards, batch_size=4, seed=7, dp=2,
                                  rank=rank)
        served.extend(_ids(iter(s)))
    assert sorted(served) == list(range(N_RECORDS))
    got = {}
    for name, mod in (("jax", jstream), ("torch", tstream)):
        d = str(tmp_path / f"cursors_{name}")
        dead = mod.StreamSampler(shards, batch_size=4, seed=7, dp=2,
                                 rank=1, cursor_dir=d)
        it = iter(dead)
        dead_served = [next(it) for _ in range(2)]
        dead.publish_cursor(cursor=1)  # only batch 1 was checkpointed
        assert mod.read_cursor(d, 1)["cursor"] == 1
        live = mod.StreamSampler(shards, batch_size=4, seed=7, dp=2,
                                 rank=0, cursor_dir=d)
        it = iter(live)
        first = next(it)
        adopted = live.take_over_host(1, survivors=[0, 1])
        assert live.take_over_host(1, survivors=[0, 1]) == 0  # once
        rest = [first] + list(it)
        got[name] = (dead_served, adopted, rest,
                     mod.remaining_items(shards, mod.read_cursor(d, 1)))
    assert got["torch"] == got["jax"]
    assert tmx.fault.stats().get("stream.take_over") == 2


def test_corrupt_skip_policy_counts_and_shrinks(shards):
    tmx.telemetry.enable()
    tmx.config.set("stream.on_corrupt", "skip")
    tmx.fault.configure("stream.torn_record:prob=1,times=3")
    ds = tstream.StreamDataset(shards)
    served = []
    for batch in tstream.StreamSampler(shards, batch_size=4, seed=5):
        served.extend(ds.sample_batch(batch))
    counters = tmx.telemetry.counters()
    assert counters["stream.records_skipped_total"] == 3
    assert len(served) == N_RECORDS - 3
    assert counters["stream.records_served_total"] == N_RECORDS - 3
    assert tmx.fault.stats().get("injected.stream.torn_record") == 3


def test_corrupt_raise_policy_and_getitem(shards):
    tmx.fault.configure("stream.torn_record:prob=1,times=1")
    ds = tstream.StreamDataset(shards)
    with pytest.raises(tstream.CorruptRecord) as ei:
        for batch in tstream.StreamSampler(shards, batch_size=4, seed=5):
            ds.sample_batch(batch)
    assert ei.value.kind == "checksum" and ei.value.record_id is not None
    tmx.config.set("stream.on_corrupt", "skip")  # the policy is batch-only
    tmx.fault.configure("stream.torn_record:prob=1,times=1")
    with pytest.raises(tstream.CorruptRecord):
        tstream.StreamDataset(shards)[0]


def test_shard_unreadable_escalates_after_retry_budget(shards):
    tmx.telemetry.enable()
    tmx.config.set("stream.open_backoff", 0.001)
    tmx.fault.configure("stream.shard_unreadable:prob=1,times=3")
    with pytest.raises(tstream.ShardUnreadable) as ei:
        tstream.StreamDataset(shards)[0]   # never hangs: bounded attempts
    e = ei.value
    assert isinstance(e, tmx.resilience.WorkerLost)
    assert e.op == "shard_open" and e.attempts == 3
    assert tmx.telemetry.counters()["stream.open_retries_total"] == 2
    assert tmx.fault.stats().get("stream.shard_lost") == 1


def test_shard_open_retry_recovers_from_transient_failure(shards):
    tmx.telemetry.enable()
    tmx.config.set("stream.open_backoff", 0.001)
    tmx.fault.configure("stream.shard_unreadable:prob=1,times=1")
    assert tstream.StreamDataset(shards)[0] is not None
    assert tmx.telemetry.counters()["stream.open_retries_total"] == 1


def test_run_restores_after_shard_loss(shards, tmp_path):
    """A shard that stays unreadable past the retry budget escalates a
    WorkerLost; ``resilience.run`` restores the last bundle (the loader
    cursor) and re-enters, and the served records continue bit for bit."""
    tmx.config.set("stream.open_backoff", 0.001)
    want = [b[0].asnumpy() for b in _loader(tstream, TLoader, shards)]
    loader = _loader(tstream, TLoader, shards)
    state = tmx.resilience.TrainState(loader=loader,
                                      path=str(tmp_path / "s.bundle"))
    seen = []
    calls = []

    def train():
        calls.append(len(seen))
        for i, (x, _y) in enumerate(loader):
            seen.append(x.asnumpy())
            state.step += 1
            if state.step == 4:
                state.save()
                # the next shard open fails past the budget (readers are
                # cached: drop them so the loss is felt)
                loader._dataset._readers.clear()
                tmx.fault.configure("stream.shard_unreadable:prob=1,times=3")
        return "done"

    assert tmx.resilience.run(train, state=state, max_restarts=2) == "done"
    assert calls[0] == 0 and len(calls) == 2
    # the batches served before the failure and after the restore
    resumed = seen[:4] + seen[calls[1]:]
    assert len(resumed) == len(want)
    for a, b in zip(resumed, want):
        onp.testing.assert_array_equal(a, b)
    assert tmx.fault.stats()["resilience.restart"] == 1
