"""Port parity: the device prefetcher and its placement helpers
(``mxnet_tpu/pipeline.py`` :68-623) — order and values, leaf kinds,
bounded depth, shutdown, error propagation, the stall recovery under the
``pipeline.prefetch_stall`` fault point and a slow producer, the served
cursor with buffered batches (bit for bit against the JAX loader), and the
sync-free step loop.

Here the prefetcher runs its whole machinery against an explicit
``"cpu"`` target; ``prefetch_to_device=True`` means the card and raises
without one. The card path (pinned staging, the side stream, events) is
``tests/test_torch_data_cuda.py``.
"""
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import data as jdata

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import pipeline
from mxnet_tpu_torch.gluon import data as tdata

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _isolated():
    for pkg in (mx, tmx):
        pkg.fault.clear()
        pkg.fault.reset_stats()
        pkg.telemetry.disable()
        pkg.telemetry.reset()
    with tmx.cpu():
        yield
    for pkg in (mx, tmx):
        pkg.fault.clear()
        pkg.fault.reset_stats()
        pkg.telemetry.disable()
        pkg.telemetry.reset()


def _src(n=8):
    return [onp.full((2, 3), i, "float32") for i in range(n)]


def test_prefetcher_preserves_order_and_values():
    out = list(pipeline.DevicePrefetcher(iter(_src()), "cpu", depth=2))
    assert [float(o[0, 0]) for o in out] == list(range(8))
    assert all(isinstance(o, torch.Tensor) for o in out)


def test_prefetcher_preserves_leaf_kinds_and_passthrough():
    nd = tmx.np.array(onp.ones((2,), "float32"))
    t = torch.zeros(3)
    src = [(nd, t, onp.ones(2, "float32"), "meta", 7)]
    (a, b, c, d, e), = list(pipeline.DevicePrefetcher(iter(src), "cpu"))
    assert type(a) is type(nd) and a._data is nd._data  # already placed
    assert b is t
    assert isinstance(c, torch.Tensor)
    assert (d, e) == ("meta", 7)


def test_prefetcher_bounded_depth():
    pulled = []

    def gen():
        for i in range(20):
            pulled.append(i)
            yield onp.array([i], "float32")

    pf = pipeline.DevicePrefetcher(gen(), "cpu", depth=2)
    next(pf)
    time.sleep(0.3)
    # one consumed + at most `depth` queued + one blocked in the offer
    assert len(pulled) <= 1 + 2 + 1
    pf.close()


def test_prefetcher_close_releases_source():
    closed = threading.Event()

    def gen():
        try:
            for i in range(100):
                yield onp.array([i])
        finally:
            closed.set()

    pf = pipeline.DevicePrefetcher(gen(), "cpu", depth=2)
    next(pf)
    pf.close()
    assert closed.wait(2.0)
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_propagates_source_exception():
    def gen():
        yield onp.zeros(1)
        raise ValueError("boom")

    pf = pipeline.DevicePrefetcher(gen(), "cpu")
    next(pf)
    with pytest.raises(ValueError, match="boom"):
        next(pf)


def test_prefetcher_stall_recovery_preserves_order():
    """The fault point wedges the prefetch thread between batches; the
    consumer's deadline hands the source to a replacement thread and
    nothing is lost or reordered (the JAX prefetcher does the same)."""
    for pkg, target in ((mx, None), (tmx, "cpu")):
        pkg.fault.configure("pipeline.prefetch_stall:at=2,times=1")
        pf = pkg.pipeline.DevicePrefetcher(iter(_src(6)), target, depth=2,
                                           stall_timeout=0.4)
        vals = [float(onp.asarray(o)[0, 0]) for o in pf]
        assert vals == list(range(6))
        assert pkg.fault.stats().get("pipeline.stall_recovered") == 1
        pkg.fault.clear()


def test_prefetcher_slow_producer_loses_no_batches():
    def gen():
        for i in range(4):
            if i == 1:
                time.sleep(0.9)  # slower than stall_timeout, not wedged
            yield onp.array([i], "float32")

    pf = pipeline.DevicePrefetcher(gen(), "cpu", depth=2, stall_timeout=0.3)
    assert [int(o[0]) for o in pf] == [0, 1, 2, 3]
    assert tmx.fault.stats().get("pipeline.stall_recovered", 0) >= 1


def test_prefetch_to_device_off_and_card_targets():
    src = iter(_src(2))
    assert pipeline.prefetch_to_device(src, None) is src
    assert pipeline.prefetch_to_device(src, False) is src
    if not torch.cuda.is_available():
        # True means the card: without one it raises, never stays on the
        # host (as does a DataLoader asking for it)
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            pipeline.prefetch_to_device(src, True)
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            list(tdata.DataLoader(tdata.ArrayDataset(onp.zeros((4, 1))),
                                  batch_size=2, prefetch_to_device=True))


def test_maybe_device_put_and_ensure_sharded():
    t = torch.ones(3)
    out, moved = pipeline.maybe_device_put(t, "cpu")
    assert out is t and not moved
    # a host array viewed as a host tensor is no transfer (the card tests
    # count the bytes of a real one)
    out, moved = pipeline.maybe_device_put(onp.ones(3, "float32"), "cpu")
    assert not moved and isinstance(out, torch.Tensor)
    nd = tmx.np.array(onp.ones(2, "float32"))
    assert pipeline.maybe_device_put(nd, "cpu") == (nd, False)
    assert pipeline.maybe_device_put("meta", "cpu") == ("meta", False)
    tmx.telemetry.enable()
    assert pipeline.ensure_sharded(t, "cpu") is t
    snap = tmx.telemetry.snapshot()["counters"]
    assert "pipeline.h2d_bytes_total" not in snap


def test_take_closes_its_source():
    pf = pipeline.DevicePrefetcher(iter(_src(10)), "cpu")
    got = list(pipeline.take(pf, 3))
    assert len(got) == 3 and pf._done


def test_prefetcher_telemetry_counters():
    tmx.telemetry.enable()
    list(pipeline.DevicePrefetcher(iter(_src(5)), "cpu"))
    snap = tmx.telemetry.snapshot()
    assert snap["counters"]["pipeline.batches_total"] == 5
    assert snap["histograms"]["pipeline.input_stall_seconds"]["count"] == 6
    assert snap["gauges"]["pipeline.inflight_depth"] == 0


# -- the DataLoader's prefetch and the served cursor -----------------------------

def test_dataloader_prefetch_equivalence_matches_jax():
    x = onp.arange(80, dtype="float32").reshape(20, 4)
    plain = [b.asnumpy() for b in jdata.DataLoader(jdata.ArrayDataset(x),
                                                   batch_size=4)]
    for workers in (0, 2):
        dl = tdata.DataLoader(tdata.ArrayDataset(x), batch_size=4,
                              num_workers=workers,
                              thread_pool=True if workers else None,
                              prefetch_to_device="cpu")
        got = [b.asnumpy() for b in dl]
        assert len(got) == len(plain)
        for a, b in zip(got, plain):
            onp.testing.assert_array_equal(a, b)
        dl.close()


def test_dataloader_resume_with_buffered_unserved_batches():
    """The prefetcher buffers batches past the loop; the cursor counts
    batches handed out, so the buffered ones replay after a restore, and
    the cursor and batches are the JAX loader's."""
    x = onp.random.RandomState(5).rand(32, 3).astype("float32")
    got = {}
    for name, d, target in (("jax", jdata, True), ("torch", tdata, "cpu")):
        def make():
            return d.DataLoader(d.ArrayDataset(x), batch_size=4,
                                sampler=d.RandomSampler(32, seed=9),
                                prefetch_to_device=target,
                                device_prefetch_depth=3)

        loader = make()
        it = iter(loader)
        seen = [next(it).asnumpy() for _ in range(3)]
        time.sleep(0.2)  # let the prefetcher buffer past the cursor
        state = loader.state_dict()
        assert state["cursor"] == 3
        rest_truth = [b.asnumpy() for b in it]
        loader2 = make()
        loader2.load_state_dict(state)
        rest = [b.asnumpy() for b in loader2]
        assert len(rest) == len(rest_truth) == 5
        for a, b in zip(rest, rest_truth):
            onp.testing.assert_array_equal(a, b)
        got[name] = (state, seen, rest)
    # the port's state also holds the epoch's augmentation seed, which the
    # JAX package's has no counterpart of; the rest is the JAX package's
    assert isinstance(got["torch"][0].pop("aug_seed"), int)
    assert got["torch"][0] == got["jax"][0]
    for a, b in zip(got["torch"][1] + got["torch"][2],
                    got["jax"][1] + got["jax"][2]):
        onp.testing.assert_array_equal(a, b)


def test_trainer_step_loop_over_prefetched_batches_is_sync_free():
    """Three fwd/bwd/step iterations fed by the prefetcher, telemetry on:
    zero host syncs in the loop (the grad norms wait in the deferred
    window); the prefetch thread's work does not count against the
    consumer's guard."""
    tmx.telemetry.enable()
    net = tmx.gluon.nn.Dense(4, in_units=8)
    net.initialize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    loss_fn = tmx.gluon.loss.L2Loss()
    rs = onp.random.RandomState(0)
    batches = [(rs.rand(16, 8).astype("float32"),
                rs.rand(16, 4).astype("float32")) for _ in range(3)]
    loader = tdata.DataLoader(
        tdata.ArrayDataset(onp.concatenate([b[0] for b in batches]),
                           onp.concatenate([b[1] for b in batches])),
        batch_size=16, prefetch_to_device="cpu")
    with pipeline.sync_guard() as g:
        for x, y in loader:
            with tmx.autograd.record():
                loss = loss_fn(net(x), y)
            tmx.autograd.backward(loss)
            trainer.step(16)
    assert g.count == 0, f"hot path synced: {g.sites}"
    trainer.drain_telemetry()
    snap = tmx.telemetry.snapshot()
    assert snap["histograms"]["trainer.grad_norm"]["count"] == 3
    assert snap["counters"]["pipeline.batches_total"] == 3
