"""On-card checks of the data path (marker ``cuda``).

What only a card can show: the DevicePrefetcher's pinned staging and
side-stream copies give the source's values in source order while the
consumer's stream is busy (each batch is read on the consumer's stream
after a long kernel queued ahead of it); a reused staging buffer is never
overwritten while the copy out of it is in flight (the ring waits on the
copy's event, and large batches put that wait to work); a spawned
worker's batch goes from its shared-memory segment into the staging ring
and from there to the card, with no other host copy; the copies add
no host sync to the consumer; and ``prefetch_to_device=True`` targets the
card, and raises when the process has none. They skip without a card
(decided in the ``cuda_device`` fixture). This file imports neither JAX
nor the JAX package, so it runs on the card's machine with
``--noconftest``.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import pipeline
from mxnet_tpu_torch.gluon import data as tdata

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the side-stream copies have no "
                    "CPU mode")
    yield torch.device("cuda", 0)
    tmx.telemetry.disable()
    tmx.telemetry.reset()


def _batches(n, numel, seed=0):
    rs = onp.random.RandomState(seed)
    return [rs.randint(0, 1 << 20, numel).astype("float32") for _ in range(n)]


def test_values_and_order_under_a_busy_consumer_stream(cuda_device):
    src = _batches(12, 1 << 16)
    pf = pipeline.DevicePrefetcher(iter(src), depth=3)
    for i, out in enumerate(pf):
        assert out.device == cuda_device and not out.is_pinned()
        torch.cuda._sleep(2_000_000)  # the consumer's stream stays busy
        got = out.sum(dtype=torch.float64)  # read on the consumer stream
        assert got.item() == float(src[i].astype("float64").sum()), i
    assert pf.staging.waits >= 0


def test_reused_staging_buffer_waits_for_its_copy(cuda_device):
    """Big batches through a ring of at most depth + 1 buffers a shape:
    buffers come back around while copies are still in flight, and every
    batch still arrives intact (the ring waited on the copy's event)."""
    src = _batches(10, 1 << 24, seed=1)  # 64 MiB each
    want = [float(b.astype("float64").sum()) for b in src]
    pf = pipeline.DevicePrefetcher(iter(src), depth=1)
    got = []
    for out in pf:
        torch.cuda._sleep(5_000_000)
        got.append(out.sum(dtype=torch.float64))
    assert [g.item() for g in got] == want
    assert len(pf.staging._free[((1 << 24,), torch.float32)]) <= 2


def test_pinned_batches_copy_directly_and_count_bytes(cuda_device):
    tmx.telemetry.enable()
    x = onp.arange(64 * 8, dtype="float32").reshape(64, 8)
    with tmx.cpu():
        loader = tdata.DataLoader(tdata.ArrayDataset(x), batch_size=16,
                                  pin_memory=True, prefetch_to_device=True)
        got = [b.asnumpy() for b in loader]
    onp.testing.assert_array_equal(onp.concatenate(got), x)
    snap = tmx.telemetry.snapshot()["counters"]
    assert snap["pipeline.h2d_bytes_total"] == x.nbytes
    assert snap["pipeline.batches_total"] == 4


@pytest.mark.parametrize("pin", [False, True])
def test_worker_batches_land_in_the_staging_ring(cuda_device, monkeypatch,
                                                 pin):
    """Spawned workers under a prefetch to the card: each batch is copied
    out of its shared-memory segment straight into the prefetcher's
    pinned staging ring, whatever ``pin_memory`` says, and the copy to
    the card reads that buffer (no second host copy); the values arrive
    intact under a busy consumer stream."""
    seen = []
    lent = pipeline._StagingRing.lent

    def spy(ring, t):
        seen.append(lent(ring, t))
        return seen[-1]

    monkeypatch.setattr(pipeline._StagingRing, "lent", spy)
    x = onp.arange(64 * 3 * 8 * 8, dtype="float32").reshape(64, 3, 8, 8)
    y = onp.arange(64, dtype="int32")
    with tmx.cpu():
        loader = tdata.DataLoader(
            tdata.ArrayDataset(x, y), batch_size=8, num_workers=2,
            thread_pool=False, pin_memory=pin, prefetch_to_device=True,
            device_prefetch_depth=1)
        got = []
        for bx, by in loader:
            assert bx._data.device == cuda_device
            torch.cuda._sleep(2_000_000)
            got.append((bx._data.sum(dtype=torch.float64), by.asnumpy()))
        loader.close()
    assert len(seen) == 2 * len(got) == 16 and all(seen)
    for i, (sx, by) in enumerate(got):
        assert sx.item() == float(x[8 * i:8 * i + 8].astype("float64")
                                  .sum()), i
        onp.testing.assert_array_equal(by, y[8 * i:8 * i + 8])


def test_consumer_loop_is_sync_free(cuda_device):
    src = _batches(6, 1 << 12)
    pf = pipeline.DevicePrefetcher(iter(src), depth=2)
    next(pf)  # the thread is up
    with pipeline.sync_guard() as g:
        for out in pf:
            out.mul_(2)
    assert g.count == 0, g.sites


def test_prefetch_to_device_true_needs_the_card(cuda_device, monkeypatch):
    pf = pipeline.prefetch_to_device(iter(_batches(1, 4)), True)
    assert next(pf).device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        pipeline.prefetch_to_device(iter(_batches(1, 4)), True)
