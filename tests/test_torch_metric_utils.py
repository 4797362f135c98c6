"""Port parity: ``gluon.metric`` (every metric, eager and deferred) and
``gluon.utils``.

Each metric is fed the same seeded batches (tensors in the port, ``mx.np``
arrays in the JAX package) in two updates; ``get()`` is held at rtol 1e-6
against the reference's (exact for the counting metrics). The deferred
view (``defer(window)``) gives the eager value, and reads nothing on an
update: with a window of 8 no value is fetched until ``get()``, and a
window of 1 fetches the older batch at the second update. TopKAccuracy on
scores tied on the k-th value: eager equals deferred and the reference's
rule under a stable sort, and the JAX package wherever no tie order
changes its answer. ``gluon.utils``:
``split_data`` / ``split_and_load`` slices, ``clip_global_norm``'s norm
and scaled arrays against the reference (rtol 1e-6), its host read under
``pipeline.sync_guard``, the device-only path without ``check_isfinite``,
the non-finite warning, ``check_sha1``, ``download`` of a ``file://`` URL,
``shape_is_known``.
"""
import hashlib

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import metric as jmetric
from mxnet_tpu.gluon import utils as jutils

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import pipeline as tpipeline
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import metric as tmetric
from mxnet_tpu_torch.gluon import utils as tutils

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _batches(kind, seed):
    rs = onp.random.RandomState(seed)
    out = []
    for _ in range(2):
        if kind == "class":
            pred = rs.rand(6, 5).astype("float32")
            label = rs.randint(0, 5, (6,)).astype("float32")
        elif kind == "prob":
            pred = rs.rand(6, 5).astype("float32") + 0.05
            pred /= pred.sum(-1, keepdims=True)
            label = rs.randint(0, 5, (6,)).astype("float32")
        elif kind == "binary":
            pred = rs.rand(8, 2).astype("float32")
            label = rs.randint(0, 2, (8,)).astype("float32")
        elif kind == "score":
            pred = rs.rand(8).astype("float32")
            label = rs.randint(0, 2, (8,)).astype("float32")
        else:  # regression
            pred = rs.randn(6, 3).astype("float32")
            label = rs.randn(6, 3).astype("float32")
        out.append((label, pred))
    return out


CASES = {
    "acc": ("acc", {}, "class"),
    "accuracy_axis": ("accuracy", {"axis": 1}, "class"),
    "top_k_accuracy": ("top_k_accuracy", {"top_k": 3}, "class"),
    "mae": ("mae", {}, "reg"),
    "mse": ("mse", {}, "reg"),
    "rmse": ("rmse", {}, "reg"),
    "ce": ("ce", {}, "prob"),
    "perplexity": ("perplexity", {}, "prob"),
    "f1": ("f1", {}, "binary"),
    "fbeta": ("fbeta", {"beta": 2.0}, "binary"),
    "mcc": ("mcc", {}, "binary"),
    "pearsonr": ("pearsoncorrelation", {}, "reg"),
    "pcc": ("pcc", {}, "class"),
    "binary_accuracy": ("binaryaccuracy", {"threshold": 0.4}, "score"),
    "mpd": ("meanpairwisedistance", {"p": 3}, "reg"),
    "cos_sim": ("meancosinesimilarity", {}, "reg"),
    "loss": ("loss", {}, "reg"),
    "torch": ("torch", {}, "reg"),
}


def _run(pkg, metric, batches, arr):
    for label, pred in batches:
        metric.update([arr(label)], [arr(pred)])
    return metric.get()


def _jarr(a):
    return mx.np.array(a)


def _tarr(a):
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax(case):
    name, kw, kind = CASES[case]
    batches = _batches(kind, len(case))
    jname, jval = _run(mx, jmetric.create(name, **kw), batches, _jarr)
    tm = tmetric.create(name, **kw)
    tname, tval = _run(tmx, tm, batches, _tarr)
    assert tname == jname
    onp.testing.assert_allclose(tval, jval, rtol=1e-6, atol=1e-7)
    # deferred: the same value, by device statistics where there are any
    dm = tmetric.create(name, **kw).defer(8)
    dname, dval = _run(tmx, dm, batches, _tarr)
    assert dname == jname
    onp.testing.assert_allclose(dval, jval, rtol=1e-6, atol=1e-7)
    tm.reset()
    assert tm.num_inst == 0


@pytest.mark.parametrize("name", ["acc", "top_k_accuracy", "mse", "mae",
                                  "rmse", "ce", "perplexity", "loss"])
def test_deferred_metric_reads_nothing_on_update(name):
    kind = {"acc": "class", "top_k_accuracy": "class", "ce": "prob",
            "perplexity": "prob"}.get(name, "reg")
    batches = _batches(kind, 5)
    kw = {"top_k": 2} if name == "top_k_accuracy" else {}
    m = tmetric.create(name, **kw).defer(8)
    assert hasattr(m._base, "_device_stats")
    with tpipeline.sync_guard() as guard:
        for label, pred in batches:
            m.update([_tarr(label)], [_tarr(pred)])
    assert guard.count == 0, guard.sites
    assert len(m._window) == 2 and m._base.num_inst == 0
    m.get()
    assert len(m._window) == 0 and m._base.num_inst > 0
    # a window of 1 fetches the older batch on overflow
    m1 = tmetric.create(name, **kw).defer(1)
    with tpipeline.sync_guard() as guard:
        for label, pred in batches:
            m1.update([_tarr(label)], [_tarr(pred)])
    assert guard.sites == {"deferred_evict": 1}
    assert len(m1._window) == 1 and m1._base.num_inst > 0
    m1.reset()
    assert len(m1._window) == 0


def test_topk_accuracy_ties():
    """Scores with few distinct values (as bf16 scores over many classes
    have): eager and deferred give one value, the reference's
    ``argsort()[:, -k:]`` under a stable sort (a tie on the k-th score
    goes to the higher class index). Against the JAX package on the rows
    whose answer no tie order changes: the label's tied group lies wholly
    inside or wholly outside the top k."""
    rs = onp.random.RandomState(11)
    k = 3
    pred = rs.randint(0, 4, (64, 10)).astype("float32") / 4
    label = rs.randint(0, 10, (64,)).astype("float32")
    stable = onp.argsort(pred, axis=-1, kind="stable")[:, -k:]
    want = float((stable == label[:, None]).any(-1).sum())
    eager = tmetric.TopKAccuracy(k)
    eager.update([_tarr(label)], [_tarr(pred)])
    deferred = tmetric.TopKAccuracy(k).defer(8)
    deferred.update([_tarr(label)], [_tarr(pred)])
    assert eager.sum_metric == want
    assert eager.get() == deferred.get()
    mine = pred[onp.arange(64), label.astype(int)]
    above = (pred > mine[:, None]).sum(-1)
    tied = (pred == mine[:, None]).sum(-1)
    decided = (above + tied <= k) | (above >= k)
    assert 10 < decided.sum() < 64  # ties on the boundary are left out
    assert ((tied > 1) & decided).any()  # ties inside or outside stay in
    jm = jmetric.TopKAccuracy(k)
    jm.update([_jarr(label[decided])], [_jarr(pred[decided])])
    tm = tmetric.TopKAccuracy(k)
    tm.update([_tarr(label[decided])], [_tarr(pred[decided])])
    assert tm.get() == jm.get()


def test_composite_and_custom_match_jax():
    batches = _batches("class", 9)

    def feval(label, pred):
        return float((pred.argmax(-1) == label).sum()), label.shape[0]

    for pkg, metric, arr in ((mx, jmetric, _jarr), (tmx, tmetric, _tarr)):
        comp = metric.create(["acc", "top_k_accuracy"])
        comp.add(metric.np(feval, name="mine"))
        _run(pkg, comp, batches, arr)
        if pkg is mx:
            want = comp.get()
        else:
            got = comp.get()
    assert got[0] == want[0]
    onp.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    with pytest.raises(MXNetError):
        tmetric.create("no_such_metric")


def test_every_reference_metric_exists():
    names = {n for n in dir(jmetric) if isinstance(getattr(jmetric, n), type)
             and issubclass(getattr(jmetric, n), jmetric.EvalMetric)}
    assert names <= set(dir(tmetric)), names - set(dir(tmetric))


# -- gluon.utils ---------------------------------------------------------------

def test_split_data_and_load():
    x = onp.arange(24, dtype="float32").reshape(6, 4)
    for even, n in ((True, 3), (False, 4)):
        want = jutils.split_data(mx.np.array(x), n, even_split=even)
        got = tutils.split_data(_tarr(x), n, even_split=even)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            onp.testing.assert_array_equal(g.numpy(), w.asnumpy())
    with pytest.raises(MXNetError):
        tutils.split_data(_tarr(x), 4)
    parts = tutils.split_and_load(x, [tmx.cpu(0), tmx.cpu(0)])
    assert [p.shape for p in parts] == [(3, 4), (3, 4)]
    assert isinstance(parts[0], tmx.np.ndarray)
    assert parts[0].device == tmx.cpu(0)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax(max_norm):
    rs = onp.random.RandomState(3)
    arrs = [rs.randn(4, 3).astype("float32"), rs.randn(7).astype("float32")]
    jarrs = [mx.np.array(a) for a in arrs]
    want = jutils.clip_global_norm(jarrs, max_norm)
    tarrs = [_tarr(a) for a in arrs]
    with tpipeline.sync_guard() as guard:
        got = tutils.clip_global_norm(tarrs, max_norm)
    assert guard.sites == {"gluon.clip_global_norm": 1}  # one host read
    assert isinstance(got, float)
    onp.testing.assert_allclose(got, want, rtol=1e-6)
    for t, j in zip(tarrs, jarrs):
        onp.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=1e-6,
                                    atol=1e-7)
    # mx.np arrays are rebound; check_isfinite=False reads nothing
    narrs = [tmx.np.array(a) for a in arrs]
    with tpipeline.sync_guard() as guard:
        total = tutils.clip_global_norm(narrs, max_norm,
                                        check_isfinite=False)
    assert guard.count == 0
    assert isinstance(total, torch.Tensor)
    onp.testing.assert_allclose(float(total), want, rtol=1e-6)
    for t, j in zip(narrs, jarrs):
        onp.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6,
                                    atol=1e-7)


def test_clip_global_norm_non_finite_warns_and_keeps():
    a = torch.tensor([1.0, float("inf")])
    with pytest.warns(UserWarning, match="nan or inf"):
        norm = tutils.clip_global_norm([a], 1.0)
    assert norm == float("inf") and a[0] == 1.0


def test_sha1_download_shape(tmp_path):
    src = tmp_path / "blob.bin"
    src.write_bytes(b"mxnet" * 100)
    digest = hashlib.sha1(b"mxnet" * 100).hexdigest()
    assert tutils.check_sha1(str(src), digest)
    assert tutils.check_sha1(str(src), digest) == \
        jutils.check_sha1(str(src), digest)
    dst = tmp_path / "copy.bin"
    assert tutils.download(f"file://{src}", path=str(dst)) == str(dst)
    assert dst.read_bytes() == src.read_bytes()
    with pytest.raises(MXNetError):
        tutils.download("https://example.invalid/x.bin",
                        path=str(tmp_path / "nope.bin"))
    for shape in (None, (2, 0), (2, 3)):
        assert tutils.shape_is_known(shape) == jutils.shape_is_known(shape)
