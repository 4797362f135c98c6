"""Port parity: ``mx.resilience`` TrainState bundles, ``run``, the
Estimator with its ResilienceHandler, and ``mx.io``'s iterators.

The oracle of a resume is bit for bit (``tests/test_resilience.py`` of the
JAX package): a run preempted at step K and restored in a fresh world from
its bundle gives the identical losses for the remaining steps and the
identical final weights, for a small MLP under Adam and a small ResNetV1
(BatchNorm running statistics, NAG, label smoothing). Across packages, the
same weights (carried from the JAX net) and the same seeded loader give
the same loader cursors exactly and losses within 1e-5. A torn bundle, a
newer-format bundle and a partial parameter set are refused.
"""
import os
import pickle
import signal
import struct

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon.contrib import estimator as jest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.gluon.contrib import estimator as test_
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _isolated():
    for pkg in (mx, tmx):
        pkg.fault.clear()
        pkg.fault.reset_stats()
        pkg.resilience.clear_preempt()
    with tmx.cpu():
        yield
    for pkg in (mx, tmx):
        pkg.fault.clear()
        pkg.resilience.clear_preempt()
        pkg.resilience.uninstall_signal_handlers()
        pkg.config.reset()


def _data(n=24, seed=7):
    rng = onp.random.RandomState(seed)
    return rng.randn(n, 4).astype("f"), rng.randn(n, 2).astype("f")


def _toy(pkg, lr=0.05):
    net = pkg.gluon.nn.Sequential()
    net.add(pkg.gluon.nn.Dense(8, activation="relu"), pkg.gluon.nn.Dense(2))
    net.initialize()
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": lr})
    return net, trainer


def _make_run(pkg, bundle, weights=None):
    pkg.random.seed(1234)
    onp.random.seed(1234)
    x, y = _data()
    d = pkg.gluon.data
    loader = d.DataLoader(d.ArrayDataset(x, y), batch_size=4,
                          sampler=d.RandomSampler(24, seed=5))
    net, trainer = _toy(pkg)
    net(pkg.np.array(x[:1]))  # finish the deferred shapes
    if weights is not None:
        for k, p in net.collect_params().items():
            p.set_data(pkg.np.array(weights[k]))
    state = pkg.resilience.TrainState(net=net, trainer=trainer,
                                      loader=loader, path=bundle)
    return net, trainer, loader, state


def _step(pkg, net, trainer, x, y):
    with pkg.autograd.record():
        loss = pkg.gluon.loss.L2Loss()(net(x), y)
    pkg.autograd.backward(loss)
    trainer.step(x.shape[0])
    return float(loss.mean().asnumpy())


def _train(pkg, net, trainer, loader, state, epochs=2, preempt_at=None):
    losses = []
    for _ in range(state.epoch, epochs):
        for bx, by in loader:
            loss = _step(pkg, net, trainer, bx, by)
            state.step += 1
            losses.append((state.step, loss))
            if preempt_at is not None and state.step == preempt_at:
                state.save()
                return losses
        state.epoch += 1
    return losses


def _weights(net):
    return {k: p.data().detach().cpu().numpy().copy()
            for k, p in net.collect_params().items()}


def test_bitwise_resume_mid_epoch(tmp_path):
    """Preempt at step 4 of 12 (mid epoch 0), restore in a fresh world
    after perturbing every stream, finish: losses and weights are
    bit-identical to the uninterrupted run."""
    bundle = str(tmp_path / "run.bundle")
    run = _make_run(tmx, bundle)
    truth = _train(tmx, *run, epochs=2)
    final = _weights(run[0])
    assert len(truth) == 12
    first = _train(tmx, *_make_run(tmx, bundle), epochs=2, preempt_at=4)
    assert first == truth[:4]
    assert os.path.exists(bundle) and os.path.exists(bundle + ".sha256")
    net, trainer, loader, state = _make_run(tmx, bundle)
    torch.rand(3, generator=tmx.random.default_generator("cpu"))
    onp.random.rand(3)
    state.load()
    assert state.step == 4
    resumed = _train(tmx, net, trainer, loader, state, epochs=2)
    assert resumed == truth[4:]
    for k, v in _weights(net).items():
        assert onp.array_equal(v, final[k]), k


def test_cross_package_run_and_cursor(tmp_path):
    """From the JAX net's weights, the same loader: the same cursors
    exactly and losses within 1e-5; the JAX bundle's loader state loads
    into the port's loader."""
    jrun = _make_run(mx, str(tmp_path / "j.bundle"))
    weights = {k: onp.asarray(v) for k, v in
               jfunctional.param_arrays(jrun[0]).items()}
    trun = _make_run(tmx, str(tmp_path / "t.bundle"), weights)
    jl = _train(mx, *jrun, epochs=1, preempt_at=3)
    tl = _train(tmx, *trun, epochs=1, preempt_at=3)
    onp.testing.assert_allclose([l for _, l in tl], [l for _, l in jl],
                                rtol=1e-5, atol=1e-6)
    # the port's loader state also holds the epoch's augmentation seed,
    # which the JAX package's has no counterpart of
    pairs = ((trun[2].state_dict(), jrun[2].state_dict()),
             (trun[3].state_dict()["loader"], jrun[3].state_dict()["loader"]))
    for tloader, jloader in pairs:
        assert isinstance(tloader.pop("aug_seed"), int)
        assert tloader == jloader
    jb = pickle.loads(open(str(tmp_path / "j.bundle"), "rb").read())
    _, _, loader, _ = _make_run(tmx, str(tmp_path / "x"), weights)
    loader.load_state_dict(jb["loader"])
    jl2 = jrun[2]
    jl2.load_state_dict(jb["loader"])
    for a, b in zip(loader, jl2):
        onp.testing.assert_array_equal(a[0].asnumpy(), b[0].asnumpy())


def test_bundle_holds_bf16_bits_and_rng(tmp_path):
    net, trainer = _toy(tmx)
    net(tmx.np.array(onp.ones((1, 4), "f")))
    net.cast("bfloat16")
    state = tmx.resilience.TrainState(net=net, path=str(tmp_path / "b"))
    before = _weights_bits(net)
    tmx.random.seed(3)
    g = tmx.random.default_generator("cpu")
    state.save()
    draw = torch.rand(4, generator=g)
    for p in net.collect_params().values():
        p.data().data.zero_()
    state.load()
    assert _weights_bits(net) == before
    assert torch.equal(torch.rand(4, generator=g), draw)


def _weights_bits(net):
    return {k: p.data().view(torch.int16).numpy().tobytes()
            for k, p in net.collect_params().items()}


def test_trainstate_rejects_torn_newer_and_partial(tmp_path):
    bundle = str(tmp_path / "t.bundle")
    net, trainer, loader, state = _make_run(tmx, bundle)
    state.step = 3
    state.save()
    blob = open(bundle, "rb").read()
    with open(bundle + ".tmp", "wb") as f:  # a torn replacement file
        f.write(blob[:len(blob) // 2])
    os.replace(bundle + ".tmp", bundle)
    with pytest.raises(tmx.MXNetError, match="checksum|corrupt"):
        state.load()
    # the retention history still holds the valid generation
    assert state.load_latest_valid().endswith(".g00000003")
    v = str(tmp_path / "v.bundle")
    tmx.serialization.atomic_write_bytes(
        v, pickle.dumps({"version": 99, "step": 1}))
    tmx.serialization.write_checksum(v)
    with pytest.raises(tmx.MXNetError, match="newer"):
        tmx.resilience.TrainState(path=v).load()
    d = state.state_dict()
    d["params"].popitem()
    p = str(tmp_path / "p.bundle")
    tmx.serialization.atomic_write_bytes(p, pickle.dumps(d))
    tmx.serialization.write_checksum(p)
    with pytest.raises(tmx.MXNetError, match="missing parameter"):
        state.load(p)
    # a step to bundle needs state_dict / load_state_dict; a
    # ShardedTrainStep has them (its bundles: tests/test_torch_parallel_dp)
    with pytest.raises(tmx.MXNetError, match="state_dict"):
        tmx.resilience.TrainState(sharded_step=object())


def test_bundle_gc_keeps_newest_generations(tmp_path):
    tmx.config.set("resilience.keep_bundles", 2)
    state = tmx.resilience.TrainState(path=str(tmp_path / "g"))
    for s in (1, 2, 3):
        state.step = s
        state.save()
    hist = tmx.resilience.TrainState._history(str(tmp_path / "g"))
    assert [h[-2:] for h in hist] == ["02", "03"]
    assert tmx.fault.stats()["resilience.bundle_gc"] == 1


def test_small_resnet_bitwise_resume(tmp_path):
    """A small ResNetV1 (BatchNorm statistics, NAG with momentum states,
    label smoothing) preempted at step 3 of 8 resumes bit for bit."""
    rs = onp.random.RandomState(2)
    x = rs.randint(0, 256, (16, 8, 8, 3)).astype("uint8")
    y = rs.randint(0, 5, 16).astype("int32")
    T = tmx.gluon.data.vision.transforms
    bundle = str(tmp_path / "r.bundle")

    def make():
        tmx.random.seed(11)
        net = tresnet.ResNetV1(tresnet.BasicBlockV1, [1, 1], [4, 4, 8],
                               classes=5, thumbnail=True)
        net.initialize()
        net(tmx.np.zeros((1, 3, 8, 8)))
        trainer = tmx.gluon.Trainer(net.collect_params(), "nag",
                                    {"learning_rate": 0.05,
                                     "momentum": 0.9})
        d = tmx.gluon.data
        ds = d.ArrayDataset(x, y).transform_first(
            T.Compose([T.ToTensor(), T.Normalize(0.5, 0.25)]))
        loader = d.DataLoader(ds, batch_size=4,
                              sampler=d.RandomSampler(16, seed=3))
        return net, trainer, loader, tmx.resilience.TrainState(
            net=net, trainer=trainer, loader=loader, path=bundle)

    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False)

    def smooth(by):  # labels smoothed by 0.1, as chip_smoke's phase 32
        one = torch.nn.functional.one_hot(by._data.long(), 5).float()
        return one * 0.9 + 0.1 / 5

    def train(net, trainer, loader, state, stop=None):
        out = []
        for _ in range(state.epoch, 2):
            for bx, by in loader:
                with tmx.autograd.record():
                    loss = loss_fn(net(bx), smooth(by))
                tmx.autograd.backward(loss)
                trainer.step(bx.shape[0])
                state.step += 1
                out.append(float(loss.mean().asnumpy()))
                if state.step == stop:
                    state.save()
                    return out
            state.epoch += 1
        return out

    run = make()
    truth = train(*run)
    final = _weights(run[0])
    assert len(truth) == 8
    assert train(*make(), stop=3) == truth[:3]
    run = make()
    run[3].load()
    assert train(*run) == truth[3:]
    for k, v in _weights(run[0]).items():
        assert onp.array_equal(v, final[k]), k


# -- preemption and the supervisor ---------------------------------------------

def test_signal_and_injection_preempt():
    hooked = tmx.resilience.install_signal_handlers()
    assert signal.SIGTERM in hooked
    assert not tmx.resilience.preempt_requested()
    signal.raise_signal(signal.SIGTERM)
    assert tmx.resilience.preempt_requested()
    tmx.resilience.uninstall_signal_handlers()
    tmx.resilience.clear_preempt()
    assert tmx.fault.stats().get("resilience.preempt_signal") == 1
    for pkg in (mx, tmx):
        pkg.fault.configure("resilience.preempt:at=3")
        assert [pkg.resilience.preempt_requested(step=s)
                for s in (1, 2, 3)] == [False, False, True]
        pkg.resilience.clear_preempt()
        pkg.fault.clear()


def test_run_budget_matches_jax(tmp_path):
    got = {}
    for pkg in (mx, tmx):
        pkg.fault.reset_stats()
        state = pkg.resilience.TrainState(path=str(tmp_path / f"{pkg.__name__}.b"))
        state.step = 5
        state.save()
        state.step = 99
        calls = []

        def train_fn():
            calls.append(state.step)
            if len(calls) < 3:
                raise pkg.resilience.WorkerLost("shard_open", "w", 0, 1, 3,
                                                RuntimeError("gone"))
            return "done"

        assert pkg.resilience.run(train_fn, state=state,
                                  max_restarts=3) == "done"

        def always_lost():
            raise pkg.resilience.WorkerLost("shard_open", "w", 0, 1, 3,
                                            RuntimeError("gone"))

        with pytest.raises(pkg.resilience.WorkerLost):
            pkg.resilience.run(always_lost, max_restarts=1)

        def preempted():
            raise pkg.resilience.Preempted(path="x", step=1)

        with pytest.raises(SystemExit) as ei:
            pkg.resilience.run(preempted, exit_on_preempt=True)
        assert ei.value.code == pkg.resilience.RESUME_EXIT_CODE == 75
        st = pkg.fault.stats()
        got[pkg.__name__] = (calls, st["resilience.restart"],
                             st["resilience.restart_budget_exhausted"],
                             st["resilience.preempt_exit"])
    assert got["mxnet_tpu_torch"] == got["mxnet_tpu"] == ([99, 5, 5], 3, 1, 1)


def test_estimator_resilience_handler_preempt_then_resume(tmp_path):
    """Through ``Estimator.fit``: the injection preempts at step 3, the
    bundle lands, a fresh estimator restores it and finishes; the losses
    after the preemption are the uninterrupted run's bit for bit, and the
    step counts and events match the JAX estimator's."""
    rng = onp.random.RandomState(0)
    x = rng.randn(32, 4).astype("f")
    y = (rng.randn(32) > 0).astype("f")

    class Losses(test_.BatchEnd):
        priority = 100

        def __init__(self):
            self.values = []

        def batch_end(self, estimator, *args, **kwargs):
            # kept on the device; read after the fit (no sync a batch)
            self.values.append(kwargs["loss"][0].mean())

        def read(self):
            return [float(v.asnumpy()) for v in self.values]

    def make(pkg, est, bundle, weights=None):
        pkg.random.seed(7)
        d = pkg.gluon.data
        loader = d.DataLoader(d.ArrayDataset(x, y), batch_size=8,
                              sampler=d.RandomSampler(32, seed=2))
        net, trainer = _toy(pkg)
        net(pkg.np.array(x[:1]))
        if weights is not None:
            for k, p in net.collect_params().items():
                p.set_data(pkg.np.array(weights[k]))
        e = est.Estimator(net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
                          trainer=trainer)
        return e, loader, est.ResilienceHandler(bundle, loader=loader)

    # the uninterrupted port run
    truth = Losses()
    e, loader, _ = make(tmx, test_, str(tmp_path / "none"))
    weights = _weights(e.net)
    e.fit(loader, epochs=2, event_handlers=[truth])
    got = {}
    for pkg, est in ((mx, jest), (tmx, test_)):
        bundle = str(tmp_path / f"{pkg.__name__}.bundle")
        e, loader, rh = make(pkg, est, bundle, weights)
        pkg.fault.configure("resilience.preempt:at=3")
        with pytest.raises(pkg.resilience.Preempted) as ei:
            e.fit(loader, epochs=2, event_handlers=[rh])
        pkg.fault.clear()
        assert ei.value.step == 3 and ei.value.path == bundle
        e2, loader2, rh2 = make(pkg, est, bundle)
        after = Losses()
        e2.fit(loader2, epochs=2, event_handlers=[rh2, after])
        assert rh2.resumed
        stats = pkg.fault.stats()
        got[pkg.__name__] = (rh2.state.step, rh2.state.epoch,
                             len(after.read()),
                             stats.get("resilience.bundle_save"),
                             stats.get("resilience.bundle_restore"))
        if pkg is tmx:
            assert after.read() == truth.read()[3:]
    assert got["mxnet_tpu_torch"] == got["mxnet_tpu"]


# -- mx.io -------------------------------------------------------------------------

def _io_batches(it):
    out = []
    for b in it:
        out.append(([d.asnumpy() if hasattr(d, "asnumpy")
                     else d.to_dense().numpy() for d in b.data],
                    [l.asnumpy() for l in (b.label or [])], b.pad))
    return out


def _io_equal(t, j):
    assert len(t) == len(j)
    for (td, tl, tp), (jd, jl, jp) in zip(t, j):
        assert tp == jp
        for a, b in zip(td + tl, jd + jl):
            onp.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_jax(handle):
    rs = onp.random.RandomState(1)
    data = {"a": rs.randn(10, 3).astype("f"), "b": rs.randn(10, 2).astype("f")}
    label = rs.randint(0, 3, 10).astype("f")
    got = {}
    for pkg in (mx, tmx):
        onp.random.seed(4)
        it = pkg.io.NDArrayIter(data, label, batch_size=4, shuffle=True,
                                last_batch_handle=handle)
        first = _io_batches(it)
        it.reset()
        got[pkg.__name__] = (first, _io_batches(it), it.provide_data,
                             it.provide_label)
    _io_equal(got["mxnet_tpu_torch"][0], got["mxnet_tpu"][0])
    _io_equal(got["mxnet_tpu_torch"][1], got["mxnet_tpu"][1])
    assert [tuple(d) for d in got["mxnet_tpu_torch"][2]] == \
        [tuple(d) for d in got["mxnet_tpu"][2]]


def test_file_iterators_match_jax(tmp_path):
    data = onp.arange(20, dtype="float32").reshape(10, 2)
    labels = onp.arange(10, dtype="float32").reshape(10, 1)
    dp, lp = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    onp.savetxt(dp, data, delimiter=",")
    onp.savetxt(lp, labels, delimiter=",")
    sv = str(tmp_path / "t.libsvm")
    with open(sv, "w") as f:
        f.write("1 0:1.5 3:2.0\n0 1:0.5\n1 2:3.0 3:1.0\n0 0:2.5\n1 1:1\n")
    rs = onp.random.RandomState(0)
    imgs = rs.randint(0, 255, (6, 4, 4)).astype(onp.uint8)
    labs = rs.randint(0, 10, (6,)).astype(onp.uint8)
    ip, mp = str(tmp_path / "imgs-idx3"), str(tmp_path / "labels-idx1")
    with open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 0x803, 6, 4, 4) + imgs.tobytes())
    with open(mp, "wb") as f:
        f.write(struct.pack(">II", 0x801, 6) + labs.tobytes())
    makers = [
        lambda io: io.CSVIter(data_csv=dp, data_shape=(2,), label_csv=lp,
                              batch_size=4),
        lambda io: io.CSVIter(data_csv=dp, data_shape=(2,), batch_size=4,
                              round_batch=False),
        lambda io: io.LibSVMIter(data_libsvm=sv, data_shape=(4,),
                                 batch_size=2),
        lambda io: io.LibSVMIter(data_libsvm=sv, data_shape=(4,),
                                 batch_size=2, round_batch=False),
        lambda io: io.MNISTIter(image=ip, label=mp, batch_size=3),
        lambda io: io.MNISTIter(image=ip, label=mp, batch_size=2, flat=True,
                                shuffle=True, seed=3),
        lambda io: io.ResizeIter(io.NDArrayIter(data, batch_size=3), 5),
        lambda io: io.PrefetchingIter(io.NDArrayIter(data, labels,
                                                     batch_size=4)),
    ]
    for make in makers:
        _io_equal(_io_batches(make(tmx.io)), _io_batches(make(mx.io)))
    with pytest.raises(tmx.MXNetError, match="ImageIter"):
        tmx.io.ImageRecordIter(path_imgrec="x.rec", data_shape=(3, 4, 4))
