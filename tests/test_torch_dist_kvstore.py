"""The port's distributed stores (``mxnet_tpu_torch/kvstore/dist.py``) in
real multi-process worlds, and their watchdog, retry and escalation.

Two launches of ``tools/launch.py -n 2`` over ``torch_dist_worker.py``
(imports no JAX; gloo on the CPU), started together: ``kvstore`` (exact
sums, dist_device_sync with mx.np arrays, 2-bit compression,
``update_on_kvstore``, dist_async's reconciling pull, Horovod's
broadcast, the payload counters and ``Trainer(kvstore="dist_sync")``)
and ``retry`` (rank 0's first collective made to time out, retried with
rejoin to the exact sum; a peer slower than the watchdog, and one slower
than the whole retry budget). The workers assert the exact values themselves
(as ``tests/dist_worker.py`` does for the JAX package); the Trainer's
weights are held here against the JAX package's one-process Trainer on
the whole batch. The watchdog, ``retry_max=0`` and the escalation to
``WorkerLost`` run in this process, as ``tests/test_resilience.py`` runs
them for the reference.
"""
import os
import sys
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon import nn as jnn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

KV_CASES = ["sync_batchnorm", "exact_sum", "device_sync_np", "compression_2bit",
            "update_on_kvstore", "dist_async_reconcile", "horovod",
            "telemetry", "trainer_dist_sync", "trainer_kernel8_route"]


def _jax_trainer_net():
    mx.random.seed(5)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(8, activation="relu", in_units=6),
            jnn.BatchNorm(in_channels=8), jnn.Dense(4, in_units=8))
    net.initialize()
    net(mx.np.zeros((2, 6)))
    return net


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("kv")
    jnet = _jax_trainer_net()
    onp.savez(out / "trainer_init.npz",
              **{k: onp.asarray(v) for k, v in
                 jfunctional.param_arrays(jnet).items()})
    procs = {"kvstore": W.launch(2, "kvstore", out),
             "retry": W.launch(2, "retry", out)}
    return out, {case: W.finish(p, 240) for case, p in procs.items()}


@pytest.mark.parametrize("case", KV_CASES)
def test_dist_store_case(runs, case):
    rc, stdout, stderr = runs[1]["kvstore"]
    assert rc == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    for r in (0, 1):
        assert f"CASE_OK {case} {r}" in stdout, stdout


def test_collective_retry_two_processes(runs):
    rc, stdout, stderr = runs[1]["retry"]
    assert rc == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    assert "CASE_OK retry 0" in stdout and "CASE_OK retry 1" in stdout


@pytest.mark.parametrize("case", ["retry_slow_peer", "retry_given_up"])
def test_collective_retry_keeps_ranks_in_step(runs, case):
    """A peer slower than the watchdog: the retry waits again for the
    attempt already in the group, giving the exact sum with the next
    collective in step; slower than the whole budget: WorkerLost, and the
    group refuses later collectives (torch_dist_worker.case_retry)."""
    rc, stdout, stderr = runs[1]["retry"]
    assert rc == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    for r in (0, 1):
        assert f"CASE_OK {case} {r}" in stdout, stdout


@pytest.mark.parametrize("tag", ["plain", "on_kvstore"])
def test_trainer_dist_sync_matches_one_process_store(runs, tag):
    """Two ranks, each with half of the batch, over dist_sync, against the
    JAX package's Trainer on the whole batch through its one-process
    store: weights and BatchNorm's running statistics (the global batch's
    on both sides) after two SGD-momentum steps, rtol 1e-5 / atol 1e-6
    (sums of 2 halves against 1 sum in another order); the ranks equal
    bit for bit."""
    out, res = runs
    assert res["kvstore"][0] == 0, res["kvstore"][2]
    got = [dict(onp.load(out / f"trainer_w2_r{r}.npz")) for r in (0, 1)]
    jnet = _jax_trainer_net()
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           kvstore="device",
                           update_on_kvstore=(tag == "on_kvstore"))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = W.trainer_data()
    for _ in range(2):
        with mx.autograd.record():
            loss = loss_fn(jnet(mx.np.array(x)), mx.np.array(y))
        loss.backward()
        jtr.step(len(x))
    want = {k: onp.asarray(v) for k, v in
            jfunctional.param_arrays(jnet).items()}
    assert {k.split("/", 1)[1] for k in got[0] if k.startswith(tag + "/")} \
        == set(want)
    for name, w in want.items():
        onp.testing.assert_array_equal(got[0][f"{tag}/{name}"],
                                       got[1][f"{tag}/{name}"])
        onp.testing.assert_allclose(got[0][f"{tag}/{name}"], w, rtol=1e-5,
                                    atol=1e-6, err_msg=name)


def test_sync_batchnorm_takes_the_global_batch(runs):
    """SyncBatchNorm on two ranks of half a batch each: the running
    statistics of the whole batch, as the JAX package's BatchNorm gives on
    one device (its SyncBatchNorm is that BatchNorm); a plain BatchNorm
    keeps each rank's own, also after Trainers over dist_sync (which mark
    only their own parameters) have trained."""
    out, res = runs
    assert res["kvstore"][0] == 0, res["kvstore"][2]
    got = [dict(onp.load(out / f"syncbn_w2_r{r}.npz")) for r in (0, 1)]
    after = [dict(onp.load(out / f"bn_outside_w2_r{r}.npz")) for r in (0, 1)]
    x = W.trainer_data()[0]
    jbn = jnn.BatchNorm(in_channels=6)
    jbn.initialize()
    with mx.autograd.record():
        jbn(mx.np.array(x))
    want = {"mean": onp.asarray(jbn.running_mean.data().asnumpy()),
            "var": onp.asarray(jbn.running_var.data().asnumpy())}
    for k, w in want.items():
        onp.testing.assert_array_equal(got[0][f"sync/{k}"],
                                       got[1][f"sync/{k}"])
        onp.testing.assert_allclose(got[0][f"sync/{k}"], w, rtol=1e-5,
                                    atol=1e-6)
        assert not onp.allclose(got[0][f"local/{k}"], got[1][f"local/{k}"])
        for r in (0, 1):
            onp.testing.assert_array_equal(after[r][f"local/{k}"],
                                           got[r][f"local/{k}"])


def test_kernel8_route_global_statistics(runs):
    """[Conv2D 3x3, BatchNorm, ReLU] through kernel 8's route (its plain
    version on the CPU) on two ranks of half a batch each, over
    dist_sync, against the same route in one process on the whole batch:
    weights and running statistics after two steps, rtol 1e-5 / atol 1e-6
    (the global sums in the forward and in the stats pass, another order);
    the ranks equal bit for bit."""
    out, res = runs
    assert res["kvstore"][0] == 0, res["kvstore"][2]
    got = [dict(onp.load(out / f"fused_w2_r{r}.npz")) for r in (0, 1)]
    x, y = W.fused_data()
    with tmx.cpu():
        want = W.fused_train(W.fused_net(), "device", x, y, len(x))
    assert set(got[0]) == set(want)
    for name, w in want.items():
        onp.testing.assert_array_equal(got[0][name], got[1][name])
        onp.testing.assert_allclose(got[0][name], w, rtol=1e-5, atol=1e-6,
                                    err_msg=name)


# -- one process: degenerate world, watchdog, retry, escalation ---------------

def _solo_kv():
    kv = tmx.kv.DistKVStore("dist_sync")
    assert kv.num_workers == 1 and kv.rank == 0
    return kv


@pytest.fixture(autouse=True)
def _clean_planes():
    tmx.fault.clear()
    tmx.fault.reset_stats()
    yield
    tmx.fault.clear()
    tmx.fault.reset_stats()
    for k in ("kvstore.async_timeout", "kvstore.retry_max",
              "kvstore.retry_backoff"):
        tmx.config.reset(k)


def test_single_process_dist_kvstore_degenerates():
    """dist_sync with no launcher = a world of one: the local behaviour
    (reference: tests/test_dist.py:91)."""
    kv = tmx.kv.create("dist_sync")
    assert kv.num_workers == 1 and kv.rank == 0
    kv.init("a", torch.zeros(3))
    kv.push("a", torch.full((3,), 2.0))
    out = torch.empty(3)
    kv.pull("a", out=out)
    onp.testing.assert_array_equal(out.numpy(), onp.full(3, 2.0, "f"))


def test_dist_async_watchdog_times_out():
    """A hung reconciling collective raises CollectiveTimeout with the
    schedule diagnostic instead of freezing (reference:
    tests/test_dist.py test_dist_async_watchdog_times_out)."""
    kv = tmx.kv.DistAsyncKVStore.__new__(tmx.kv.DistAsyncKVStore)
    kv._type, kv._store, kv._updater, kv._gc = "dist_async", {
        "w": torch.zeros(4)}, None, None
    kv._nprocs, kv._rank = 2, 0

    class Hung:
        """The work of a collective that never completes."""

        def is_completed(self):
            return False

    kv._start = lambda value: (Hung(), value.clone())
    tmx.config.set("kvstore.async_timeout", 0.5)
    tmx.config.set("kvstore.retry_max", 0)
    t0 = time.time()
    with pytest.raises(tmx.kv.CollectiveTimeout, match="pull schedule"):
        kv._reconcile("w")
    assert time.time() - t0 < 5


def test_collective_retry_recovers_one_timeout():
    kv = _solo_kv()
    tmx.config.set("kvstore.async_timeout", 0.4)
    tmx.config.set("kvstore.retry_backoff", 0.05)
    tmx.fault.configure("kvstore.collective_timeout:at=1")
    kv.init("w", torch.zeros(3))
    out = torch.zeros(3)
    kv.pushpull("w", torch.ones(3), out=out)
    onp.testing.assert_array_equal(out.numpy(), onp.ones(3, "f"))
    st = tmx.fault.stats()
    assert st["resilience.collective_retry"] == 1
    assert st["kvstore.collective_timeout_raised"] == 1


def test_retry_max_zero_restores_raw_watchdog():
    kv = _solo_kv()
    tmx.config.set("kvstore.async_timeout", 0.3)
    tmx.config.set("kvstore.retry_max", 0)
    tmx.fault.configure("kvstore.collective_timeout:at=1")
    kv.init("w", torch.zeros(2))
    with pytest.raises(tmx.kv.CollectiveTimeout):
        kv.push("w", torch.ones(2))
    assert "resilience.collective_retry" not in tmx.fault.stats()


def test_exhausted_retries_escalate_worker_lost():
    kv = _solo_kv()
    tmx.config.set("kvstore.async_timeout", 0.3)
    tmx.config.set("kvstore.retry_backoff", 0.02)
    tmx.config.set("kvstore.retry_max", 2)
    tmx.fault.configure("kvstore.collective_timeout:prob=1.0")
    kv.init("w", torch.zeros(2))
    with pytest.raises(tmx.resilience.WorkerLost) as ei:
        kv.push("w", torch.ones(2))
    e = ei.value
    assert (e.op, e.key, e.rank, e.nprocs) == ("allreduce", "w", 0, 1)
    assert e.attempts == 3  # initial + 2 retries
    assert isinstance(e.last, tmx.MXNetError)
    assert tmx.fault.stats()["resilience.collective_retry"] == 2


def test_server_role_fails_fast(monkeypatch):
    """A process launched as a parameter server gets the pointer, not a
    hang (reference: kvstore_server.py)."""
    monkeypatch.setenv("DMLC_ROLE", "server")
    with pytest.raises(tmx.MXNetError, match="parameter-server roles"):
        tmx.kv.init_server_module()
    with pytest.raises(tmx.MXNetError, match="parameter-server roles"):
        tmx.kv.KVStoreServer(tmx.kv.create("dist_sync")).run()
