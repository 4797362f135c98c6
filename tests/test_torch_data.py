"""Port parity: gluon.data — datasets, samplers and their cursors, the
DataLoader (inline, thread workers, two spawned process workers over the
shared-memory ring), an injected ``dataloader.worker_crash`` with respawn
and the fallback to threads, and the vision datasets' synthetic fallback.

The same seeded numpy data goes through the JAX package and the port:
indices, cursors and batches are held element for element (the samplers
are numpy-seeded in both, so the permutations are the same). Spawned
workers pay a torch import each, so the process-worker tests use two
workers and a few small batches.
"""
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import data as jdata

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import data as tdata

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _isolated():
    for pkg in (mx, tmx):
        pkg.fault.clear()
        pkg.fault.reset_stats()
        pkg.config.reset()
    with tmx.cpu():
        yield
    for pkg in (mx, tmx):
        pkg.fault.clear()
        pkg.fault.reset_stats()
        pkg.config.reset()


def _np(b):
    if isinstance(b, (tuple, list)):
        return [_np(x) for x in b]
    return b.asnumpy() if hasattr(b, "asnumpy") else onp.asarray(b)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        if isinstance(w, list):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype, (a.dtype, b.dtype)
                onp.testing.assert_array_equal(a, b)
        else:
            assert g.dtype == w.dtype
            onp.testing.assert_array_equal(g, w)


def _xy(n=24, seed=0):
    rs = onp.random.RandomState(seed)
    return rs.randn(n, 3).astype("float32"), rs.randint(0, 5, n).astype(
        "int32")


# -- datasets ------------------------------------------------------------------

def test_dataset_views_match_jax():
    x, y = _xy()
    got = {}
    for name, d in (("jax", jdata), ("torch", tdata)):
        ds = d.ArrayDataset(x, y)
        out = [ds[3], len(ds)]
        out.append([ds.transform_first(lambda a: a * 2)[i] for i in (0, 5)])
        out.append([ds.transform(lambda a, b: (b, a))[i] for i in (1, 2)])
        out.append([ds.transform(lambda a, b: a.sum() + b,
                                 lazy=False)[i] for i in (0, 7)])
        f = ds.filter(lambda s: s[1] > 2)
        out.append([len(f)] + [f[i] for i in range(len(f))])
        out.append([[s[1] for s in ds.shard(5, k)] for k in range(5)])
        out.append([s[1] for s in ds.take(4)])
        out.append([s[1] for s in
                    ds.sample(d.IntervalSampler(len(ds), 5))])
        out.append([d.SimpleDataset(list(range(9)))[i] for i in (0, 8)])
        got[name] = out
    flat = {k: repr(_np(v) if not isinstance(v, list) else
                    [[_np(e) for e in (x if isinstance(x, (list, tuple))
                                       else [x])] for x in v])
            for k, v in got.items()}
    assert flat["torch"] == flat["jax"]


def test_array_dataset_length_mismatch_raises():
    with pytest.raises(tmx.MXNetError, match="same length"):
        tdata.ArrayDataset(onp.zeros(3), onp.zeros(4))


# -- samplers and their cursors ------------------------------------------------

@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match_jax(last_batch):
    got = {}
    for name, d in (("jax", jdata), ("torch", tdata)):
        out = [list(d.SequentialSampler(7, start=3)),
               list(d.IntervalSampler(10, 3)),
               list(d.IntervalSampler(10, 3, rollover=False)),
               list(d.FilterSampler(lambda v: v % 3 == 0, list(range(12))))]
        rs = d.RandomSampler(23, seed=4)
        bs = d.BatchSampler(rs, 5, last_batch)
        out += [list(bs), list(bs), len(bs)]
        onp.random.seed(11)  # seed=None draws its epoch seed from numpy
        out.append(list(d.RandomSampler(9)))
        got[name] = out
    assert got["torch"] == got["jax"]


def test_batch_sampler_cursor_resume_matches_jax():
    """The mid-epoch cursor (with the rollover carry the epoch started
    with) resumes at the exact next batch, and the state dicts of the two
    packages are equal."""
    got = {}
    for name, d in (("jax", jdata), ("torch", tdata)):
        bs = d.BatchSampler(d.RandomSampler(10, seed=5), 4, "rollover")
        list(iter(bs))          # epoch 0 leaves a 2-sample carry
        it = iter(bs)
        first = next(it)
        state = bs.state_dict()
        rest_truth = list(it)
        bs2 = d.BatchSampler(d.RandomSampler(10, seed=5), 4, "rollover")
        bs2.load_state_dict(state)
        assert bs2.resume_cursor() == 1
        rest = list(iter(bs2))
        assert rest == rest_truth
        got[name] = (first, state, rest, list(iter(bs2)))
    assert got["torch"] == got["jax"]


def test_random_sampler_epoch_replay():
    for seed in (11, None):
        rs = tdata.RandomSampler(32, seed=seed)
        epoch1 = list(rs)
        rs2 = tdata.RandomSampler(32, seed=seed)
        rs2.load_state_dict(rs.state_dict())
        assert list(rs2) == epoch1
        if seed is not None:
            assert list(rs2) == list(rs)


# -- the DataLoader ------------------------------------------------------------

def _jax_batches(ds_args, **kw):
    loader = jdata.DataLoader(jdata.ArrayDataset(*ds_args), **kw)
    return [_np(b) for b in loader]


def test_dataloader_inline_and_threads_match_jax():
    x, y = _xy(26)
    want = _jax_batches((x, y), batch_size=4,
                        sampler=jdata.RandomSampler(26, seed=3),
                        last_batch="keep")
    for workers in (0, 3):
        loader = tdata.DataLoader(
            tdata.ArrayDataset(x, y), batch_size=4,
            sampler=tdata.RandomSampler(26, seed=3), last_batch="keep",
            num_workers=workers, thread_pool=True if workers else None)
        got = list(loader)
        assert all(b[0]._data.device.type == "cpu" for b in got)
        _assert_batches_equal(got, want)
        assert loader._served == len(want) == len(loader)


def test_dataloader_scalar_and_nested_samples_match_jax():
    """Python scalars and nested tuples batchify to the JAX package's
    values and dtypes. Stacked int64 numpy samples stay int64, the
    reference's ``mx.np.array`` rule (its accelerator path); the JAX
    loader on its CPU backend stacks them through ``jnp.array``, which
    narrows to int32 in 32-bit mode, so that dtype is held against
    ``mx.np.array`` of the stack."""
    samples = [(float(i) / 3, (i, onp.full((2,), i, "int64")))
               for i in range(10)]
    want = [_np(b) for b in jdata.DataLoader(
        jdata.SimpleDataset(samples), batch_size=4)]
    got = list(tdata.DataLoader(tdata.SimpleDataset(samples), batch_size=4))
    for g, w in zip(got, want):
        onp.testing.assert_array_equal(_np(g[0]), w[0])
        assert _np(g[0]).dtype == w[0].dtype
        ints, arrs = _np(g[1])
        onp.testing.assert_array_equal(ints, w[1][0])
        assert ints.dtype == w[1][0].dtype
        onp.testing.assert_array_equal(arrs, w[1][1])
        assert arrs.dtype == mx.np.array(onp.stack(
            [onp.full((2,), 0, "int64")] * 2)).dtype == onp.int64


def test_dataloader_spawned_workers_match_jax():
    """Two spawned process workers over the shared-memory ring give the
    JAX loader's batches element for element; the ring reuses its
    segments across batches and close() unlinks them."""
    x, y = _xy(40, seed=2)
    want = _jax_batches((x, y), batch_size=4,
                        sampler=jdata.RandomSampler(40, seed=8),
                        last_batch="discard")
    tmx.telemetry.enable()
    tmx.telemetry.reset()
    try:
        loader = tdata.DataLoader(
            tdata.ArrayDataset(x, y), batch_size=4,
            sampler=tdata.RandomSampler(40, seed=8), last_batch="discard",
            num_workers=2, thread_pool=False)
        got = list(loader)
        counters = tmx.telemetry.snapshot()["counters"]
    finally:
        tmx.telemetry.disable()
        tmx.telemetry.reset()
    _assert_batches_equal(got, want)
    assert counters.get("dataloader.batches_total") == len(want)
    assert counters.get("dataloader.shm_reused_total", 0) > 0
    names = [n for _, n in loader._ring._free]
    loader.close()
    from multiprocessing import shared_memory
    for n in names:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=n)


def test_worker_mode_auto_probe_and_knob():
    x, y = _xy(8)
    ds = tdata.ArrayDataset(x, y)
    loader = tdata.DataLoader(ds, batch_size=4, num_workers=2)
    assert loader._resolve_worker_mode() == "threads"  # a cheap sample
    tmx.config.set("dataloader.mp_threshold_ms", 0.0)
    assert tdata.DataLoader(ds, batch_size=4, num_workers=2) \
        ._resolve_worker_mode() == "processes"
    tmx.config.set("dataloader.worker_mode", "threads")
    assert tdata.DataLoader(ds, batch_size=4, num_workers=2) \
        ._resolve_worker_mode() == "threads"
    tmx.config.set("dataloader.worker_mode", "bogus")
    with pytest.raises(ValueError, match="worker_mode"):
        tdata.DataLoader(ds, batch_size=4, num_workers=2) \
            ._resolve_worker_mode()


@pytest.mark.parametrize("max_respawns,event", [
    (1, "dataloader.worker_respawn"), (0, "dataloader.fallback_threaded")])
def test_worker_crash_respawns_or_falls_back(monkeypatch, max_respawns,
                                             event):
    """``dataloader.worker_crash`` (armed in the spawned workers through
    MXNET_FAULT_SPEC) kills a worker hard: the pool is respawned with the
    in-flight batches requeued in order, or past ``max_respawns`` the
    epoch finishes on threads; either way the batches are the JAX
    loader's, in order."""
    x, y = _xy(24, seed=6)
    want = _jax_batches((x, y), batch_size=4,
                        sampler=jdata.RandomSampler(24, seed=1))
    monkeypatch.setenv("MXNET_FAULT_SPEC", "dataloader.worker_crash:at=2")
    tmx.config.set("dataloader.max_respawns", max_respawns)
    tmx.config.set("dataloader.respawn_backoff", 0.0)
    loader = tdata.DataLoader(
        tdata.ArrayDataset(x, y), batch_size=4,
        sampler=tdata.RandomSampler(24, seed=1), num_workers=2,
        thread_pool=False, timeout=60)
    got = list(loader)
    loader.close()
    _assert_batches_equal(got, want)
    assert tmx.fault.stats().get(event) == 1
    assert loader._force_threads == (max_respawns == 0)


def test_dataloader_state_dict_cursor_matches_jax():
    x, y = _xy(20)
    states = {}
    for name, d in (("jax", jdata), ("torch", tdata)):
        loader = d.DataLoader(d.ArrayDataset(x, y), batch_size=4,
                              sampler=d.RandomSampler(20, seed=9))
        it = iter(loader)
        next(it), next(it)
        states[name] = loader.state_dict()
        rest = [_np(b) for b in it]
        loader2 = d.DataLoader(d.ArrayDataset(x, y), batch_size=4,
                               sampler=d.RandomSampler(20, seed=9))
        loader2.load_state_dict(states[name])
        _assert_batches_equal(list(loader2), rest)
    # the port's state also holds the epoch's augmentation seed, which the
    # JAX package's has no counterpart of; the rest is the JAX package's
    aug_seed = states["torch"].pop("aug_seed")
    assert isinstance(aug_seed, int)
    assert states["torch"] == states["jax"]
    assert states["torch"]["cursor"] == 2


def test_dataloader_without_stateful_sampler_raises():
    class Dumb:
        def __iter__(self):
            yield [0, 1]

        def __len__(self):
            return 1

    loader = tdata.DataLoader(tdata.ArrayDataset(onp.zeros((4, 1))),
                              batch_sampler=Dumb())
    with pytest.raises(tmx.MXNetError, match="state_dict"):
        loader.state_dict()


# -- vision datasets -------------------------------------------------------------

@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST", "CIFAR10",
                                 "CIFAR100"])
def test_vision_synthetic_fallback_matches_jax(tmp_path, cls):
    """No files under ``root``: the seeded synthetic fallback, the same
    images and labels in both packages."""
    from mxnet_tpu.gluon.data import vision as jv
    from mxnet_tpu_torch.gluon.data import vision as tv
    for train in (False,):
        j = getattr(jv, cls)(root=str(tmp_path), train=train)
        t = getattr(tv, cls)(root=str(tmp_path), train=train)
        assert len(j) == len(t)
        for i in (0, 17, len(t) - 1):
            (ja, jl), (ta, tl) = j[i], t[i]
            onp.testing.assert_array_equal(ta.asnumpy(), ja.asnumpy())
            assert tl == jl
        assert t[0][0].dtype == onp.uint8


def test_image_folder_and_list_datasets_match_jax(tmp_path):
    from mxnet_tpu.gluon.data import vision as jv
    from mxnet_tpu_torch.gluon.data import vision as tv
    rs = onp.random.RandomState(3)
    lines = []
    for c, cls in enumerate(("cat", "dog")):
        os.makedirs(tmp_path / cls)
        for k in range(3):
            img = rs.randint(0, 256, (5, 6, 3)).astype("uint8")
            onp.save(tmp_path / cls / f"{k}.npy", img)
            lines.append(f"{len(lines)}\t{c}\t{cls}/{k}.npy")
    (tmp_path / "list.lst").write_text("\n".join(lines) + "\n")
    for make in (lambda m: m.ImageFolderDataset(str(tmp_path)),
                 lambda m: m.ImageListDataset(str(tmp_path), "list.lst"),
                 lambda m: m.ImageListDataset(
                     str(tmp_path), [[1.0, 2.0, "dog/1.npy"]])):
        j, t = make(jv), make(tv)
        assert len(j) == len(t)
        for i in range(len(t)):
            onp.testing.assert_array_equal(t[i][0].asnumpy(),
                                           j[i][0].asnumpy())
            onp.testing.assert_array_equal(onp.asarray(t[i][1]),
                                           onp.asarray(j[i][1]))
    assert tv.ImageFolderDataset(str(tmp_path)).synsets == ["cat", "dog"]


def test_augmented_batches_are_the_same_in_every_worker_mode(tmp_path):
    """A batch's random transforms draw from a generator seeded by the
    epoch's augmentation seed (drawn from ``mx.random``) and its sample
    indices: under one ``mx.random.seed``, inline, thread and
    spawned-process loaders give the same augmented batches, and a
    resumed epoch replays them."""
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    imgs = onp.random.RandomState(5).randint(0, 256, (12, 6, 7, 3)) \
        .astype("uint8")
    labels = onp.arange(12, dtype="int32")

    def make(workers=0, threads=None):
        tmx.random.seed(8)
        ds = tdata.ArrayDataset(imgs, labels).transform_first(
            T.Compose([T.RandomFlipLeftRight(), T.RandomBrightness(0.3),
                       T.ToTensor()]))
        return tdata.DataLoader(ds, batch_size=4,
                                sampler=tdata.RandomSampler(12, seed=2),
                                num_workers=workers, thread_pool=threads)

    want = [_np(b) for b in make()]
    flipped = [any(not onp.array_equal(b[0][i], onp.moveaxis(
        imgs[b[1][i]], -1, 0) / onp.float32(255)) for i in range(4))
        for b in want]
    assert any(flipped)  # the transforms did draw
    for workers, threads in ((2, True), (2, False)):
        loader = make(workers, threads)
        _assert_batches_equal(list(loader), want)
        loader.close()
    loader = make()
    it = iter(loader)
    next(it)
    state = loader.state_dict()
    again = make()
    again.load_state_dict(state)
    _assert_batches_equal(list(again), want[1:])


@pytest.mark.parametrize("workers,threads", [(0, None), (2, True), (2, False)])
def test_augmentation_differs_by_epoch_and_by_seed(workers, threads):
    """Each epoch draws a new augmentation seed from ``mx.random``'s CPU
    generator: two epochs of a sequential loader flip different images,
    ``mx.random.seed`` decides the draws, and a state taken in the second
    epoch replays that epoch's flips."""
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    imgs = onp.random.RandomState(3).randint(0, 256, (16, 4, 5, 3)) \
        .astype("uint8")
    ds = tdata.ArrayDataset(imgs, onp.arange(16, dtype="int32")) \
        .transform_first(T.Compose([T.RandomFlipLeftRight(), T.ToTensor()]))

    def epochs(seed, n=2, loader=None):
        tmx.random.seed(seed)
        loader = loader or tdata.DataLoader(
            ds, batch_size=4, num_workers=workers, thread_pool=threads)
        out = [[_np(b)[0] for b in loader] for _ in range(n)]
        return out, loader

    (one, two), loader = epochs(5)
    assert not all(onp.array_equal(a, b) for a, b in zip(one, two))
    (again, _), other = epochs(5)
    _assert_batches_equal(again, one)
    (elsewhere, _), third = epochs(6)
    assert not all(onp.array_equal(a, b) for a, b in zip(elsewhere, one))
    tmx.random.seed(5)
    list(loader)
    it = iter(loader)  # the second epoch since the seed
    next(it)
    state = loader.state_dict()
    resumed = tdata.DataLoader(ds, batch_size=4, num_workers=workers,
                               thread_pool=threads)
    resumed.load_state_dict(state)
    _assert_batches_equal([_np(b)[0] for b in resumed], two[1:])
    for lo in (loader, other, third, resumed):
        lo.close()
