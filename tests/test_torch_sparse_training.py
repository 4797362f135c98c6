"""Port parity: sparse training, JAX package -> PyTorch port.

The cases of ``tests/test_sparse_training.py`` through both packages on
the CPU from seeded NumPy inputs: ``Embedding(sparse_grad=True)``'s
row-sparse gradient (its encoding: k slots, the sorted ids then the
sentinel; indices exactly, values and the densified gradient within
1e-6), two lookups in one graph and ``grad_req="add"`` (the slots
concatenated), the hybridized block's dense gradient; the lazy updates
of SGD with and without momentum, Adam and GroupAdaGrad against the JAX
optimizers over 4 steps (rtol 1e-6; untouched rows bit for bit), the
densified update, the refusals; the store's row-sparse push loop with
``row_sparse_pull``; the Trainer forcing ``update_on_kvstore``, its
``update_on_kvstore=False`` error and the store-free path; the sparse
and dense embedding classifier trained to the same weights, against the
JAX package's; ``clip_global_norm``'s refusal.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import sparse as tsp

torch.set_num_threads(2)

VOCAB, DIM = 50, 4


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _host(x):
    return onp.asarray(getattr(x, "_data", x))


def _same_rsp(got, want, rtol=1e-6):
    assert isinstance(got, tsp.RowSparseNDArray)
    assert isinstance(want, jsp.RowSparseNDArray)
    assert got.shape == want.shape
    gi, wi = _host(got.indices), _host(want.indices)
    assert gi.dtype == wi.dtype == onp.int32
    onp.testing.assert_array_equal(gi, wi)
    onp.testing.assert_allclose(_host(got.data), _host(want.data),
                                rtol=rtol, atol=1e-6)
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=rtol,
                                atol=1e-6)


def _weight(pkg, net):
    return net.collect_params()["weight"]


def _embed(pkg, sparse, w):
    net = pkg.gluon.nn.Embedding(VOCAB, DIM, sparse_grad=sparse)
    net.initialize()
    _weight(pkg, net).set_data(pkg.np.array(w))
    return net


def _w0(seed=7):
    return onp.random.RandomState(seed).randn(VOCAB, DIM).astype("float32")


IDS = [onp.array([[1, 3], [3, 7]], "int32"),
       onp.array([[49, 0], [49, 12]], "int32")]


def _grad_run(pkg, sparse, ids, twice=False, req="write", hybrid=False):
    net = _embed(pkg, sparse, _w0())
    _weight(pkg, net).grad_req = req
    if hybrid:
        net.hybridize()
    for _ in range(2 if req == "add" else 1):
        with pkg.autograd.record():
            out = net(pkg.np.array(ids))
            loss = (out * out).sum()
            if twice:
                loss = loss + (net(pkg.np.array(ids[:, ::-1])) * 3.0).sum()
        loss.backward()
    return _weight(pkg, net).grad()


@pytest.mark.parametrize("mode,ids", [("write", 0), ("write", 1),
                                      ("two_lookups", 0), ("add", 0),
                                      ("add", 1)])
def test_embedding_row_sparse_gradient_matches_jax(ids, mode):
    kw = dict(twice=mode == "two_lookups", req="add" if mode == "add"
              else "write")
    want = _grad_run(mx, True, IDS[ids], **kw)
    got = _grad_run(tmx, True, IDS[ids], **kw)
    _same_rsp(got, want)
    # the dense path's gradient, densified
    dense = _grad_run(tmx, False, IDS[ids], **kw)
    onp.testing.assert_allclose(got.asnumpy(), dense.numpy(), rtol=1e-6,
                                atol=1e-6)


def test_hybridized_embedding_gradient_is_dense():
    want = _grad_run(mx, True, IDS[0], hybrid=True)
    got = _grad_run(tmx, True, IDS[0], hybrid=True)
    assert not isinstance(want, jsp.BaseSparseNDArray)
    assert isinstance(got, torch.Tensor)
    onp.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=1e-6,
                                atol=1e-6)


def test_attached_array_row_sparse_gradient_matches_jax():
    got = {}
    w = _w0(3)[:10]
    for pkg in (mx, tmx):
        x = pkg.np.array(w)
        x.attach_grad(grad_req="add")
        for ids in ([1, 2, 1], [9, 2, 9]):
            with pkg.autograd.record():
                y = pkg.npx.embedding(pkg.np.array(onp.array(ids, "int32")),
                                      x, sparse_grad=True)
                loss = (y * y).sum()
            loss.backward()
        got[pkg.__name__] = x.grad
    _same_rsp(got["mxnet_tpu_torch"], got["mxnet_tpu"])


def _rsp_pair(rng, vocab, width, k):
    """The same dedupe_coo-encoded gradient in both packages."""
    import jax.numpy as jnp
    idx = rng.randint(0, vocab, k)
    vals = rng.randn(k, width).astype("float32")
    ji, jv = jsp.dedupe_coo(jnp.asarray(idx), jnp.asarray(vals), vocab)
    from mxnet_tpu.numpy.multiarray import _wrap
    ti, tv = tsp.dedupe_coo(torch.from_numpy(idx), torch.from_numpy(vals),
                            vocab)
    return (jsp.RowSparseNDArray(_wrap(jv), _wrap(ji), (vocab, width)),
            tsp.RowSparseNDArray(tv, ti, (vocab, width)), set(idx.tolist()))


OPTS = [("sgd", dict(learning_rate=0.1, momentum=0.0, wd=0.01)),
        ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                     clip_gradient=0.5)),
        ("adam", dict(learning_rate=0.05, wd=0.01, rescale_grad=0.5)),
        ("groupadagrad", dict(learning_rate=0.1))]


@pytest.mark.parametrize("name,kw,lazy", [
    (*OPTS[0], True), (*OPTS[1], True), (*OPTS[2], True), (*OPTS[3], True),
    (*OPTS[2], False)],
    ids=["sgd", "sgd_momentum", "adam", "groupadagrad", "adam_densified"])
def test_row_sparse_updates_match_jax(name, kw, lazy):
    vocab, width = 30, 6
    w = onp.random.RandomState(1).randn(vocab, width).astype("float32")
    jo = mx.optimizer.create(name, lazy_update=lazy, **kw)
    to = tmx.optimizer.create(name, lazy_update=lazy, **kw)
    ju, tu = mx.optimizer.get_updater(jo), tmx.optimizer.get_updater(to)
    jw, tw = mx.np.array(w), torch.from_numpy(w.copy())
    rng = onp.random.RandomState(2)
    touched = set()
    for _ in range(4):
        jg, tg, ids = _rsp_pair(rng, vocab, width, 9)
        touched |= ids
        ju(0, jg, jw)
        tu(0, tg, tw)
    onp.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=1e-6,
                                atol=1e-7)
    untouched = sorted(set(range(vocab)) - touched)
    if lazy or name == "groupadagrad":
        # lazy rules read and write the touched rows only
        onp.testing.assert_array_equal(tw.numpy()[untouched], w[untouched])


@pytest.mark.parametrize("make,match", [
    (lambda o: o.create("adamax", lazy_update=True), "Adamax"),
    (lambda o: setattr_and(o.create("rmsprop"), "lazy_update", True),
     "RMSProp has no lazy sparse update"),
])
def test_lazy_refusals_match_jax(make, match):
    for pkg, tensor in ((mx, False), (tmx, True)):
        o = make(pkg.optimizer)
        jg, tg, _ = _rsp_pair(onp.random.RandomState(0), 8, 2, 3)
        w = torch.zeros(8, 2) if tensor else mx.np.zeros((8, 2))
        with pytest.raises(NotImplementedError, match=match):
            pkg.optimizer.get_updater(o)(0, tg if tensor else jg, w)


def setattr_and(obj, name, value):
    setattr(obj, name, value)
    return obj


def test_kvstore_row_sparse_push_loop_matches_jax():
    w = onp.random.RandomState(3).randn(VOCAB, DIM).astype("float32")
    got = {}
    for pkg, sp in ((mx, jsp), (tmx, tsp)):
        kv = pkg.kv.create("local")
        kv.init("emb", pkg.np.array(w))
        kv.set_optimizer(pkg.optimizer.create(
            "sgd", learning_rate=0.5, momentum=0.9, lazy_update=True))
        for step in range(3):
            ids = onp.array([2, 9, 2, 31])
            vals = onp.random.RandomState(step).randn(4, DIM) \
                .astype("float32")
            parts = [sp.row_sparse_array(
                (vals[i:i + 2], ids[i:i + 2]), shape=(VOCAB, DIM))
                for i in (0, 2)]
            kv.push("emb", parts)      # two parts: reduced sparsely
        out = pkg.np.zeros((VOCAB, DIM))
        kv.pull("emb", out=out)
        rows = kv.row_sparse_pull("emb", row_ids=pkg.np.array([31, 2]))
        got[pkg.__name__] = (out.asnumpy(), rows)
    onp.testing.assert_allclose(got["mxnet_tpu_torch"][0],
                                got["mxnet_tpu"][0], rtol=1e-6, atol=1e-7)
    untouched = [i for i in range(VOCAB) if i not in (2, 9, 31)]
    onp.testing.assert_array_equal(got["mxnet_tpu_torch"][0][untouched],
                                   w[untouched])
    _same_rsp(got["mxnet_tpu_torch"][1], got["mxnet_tpu"][1])


def _train(pkg, sparse, name, kw, kvstore="device"):
    """The reference test's embedding classifier: 4 batches of 5 x 3 ids
    covering 0..9."""
    batch = onp.array([[0, 1, 0], [2, 3, 1], [4, 5, 2],
                       [6, 7, 3], [8, 9, 4]], dtype="int32")
    xs = onp.concatenate([batch] * 4, axis=0)
    ys = (xs.sum(-1) % 2).astype("float32")
    net = _embed(pkg, sparse, _w0())
    o = pkg.optimizer.create(name, lazy_update=sparse, wd=0.0, **kw)
    trainer = pkg.gluon.Trainer(net.collect_params(), o, kvstore=kvstore)
    for i in range(0, 20, 5):
        with pkg.autograd.record():
            emb = net(pkg.np.array(xs[i:i + 5]))
            loss = ((emb.sum(axis=(1, 2)) - pkg.np.array(ys[i:i + 5])) ** 2) \
                .mean()
        loss.backward()
        trainer.step(1)
    w = _weight(pkg, net).data()
    return (w.asnumpy() if hasattr(w, "asnumpy") else w.detach().numpy(),
            float(loss.asnumpy()), trainer)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.0)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("adam", dict(learning_rate=0.05))], ids=["sgd", "momentum", "adam"])
def test_sparse_and_dense_training_match_jax(name, kw):
    got_s, loss_s, tr = _train(tmx, True, name, kw)
    got_d, loss_d, _ = _train(tmx, False, name, kw)
    want_s, loss_w, _ = _train(mx, True, name, kw)
    assert tr._update_on_kvstore is True
    onp.testing.assert_allclose(got_s, got_d, rtol=1e-4, atol=1e-5)
    onp.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)
    assert loss_s == pytest.approx(loss_w, rel=1e-6)
    # without a store: one rule call for the row-sparse gradient
    got_n, _, tr_n = _train(tmx, True, name, kw, kvstore=None)
    assert tr_n._update_on_kvstore is False
    onp.testing.assert_allclose(got_n, got_s, rtol=1e-6, atol=1e-7)


def test_trainer_refuses_update_on_kvstore_false():
    for pkg, err in ((mx, JaxError), (tmx, MXNetError)):
        net = _embed(pkg, True, _w0())
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1},
                                    update_on_kvstore=False)
        with pkg.autograd.record():
            loss = net(pkg.np.array(IDS[0])).sum()
        loss.backward()
        with pytest.raises(err, match="update_on_kvstore=False"):
            trainer.step(1)


def test_clip_global_norm_refuses_row_sparse():
    for pkg in (mx, tmx):
        grad = _grad_run(pkg, True, IDS[0])
        with pytest.raises(AttributeError):
            pkg.gluon.utils.clip_global_norm([grad], 1.0)
