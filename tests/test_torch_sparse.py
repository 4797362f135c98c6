"""Port parity: sparse arrays, JAX package -> PyTorch port.

The cases of ``tests/test_sparse.py`` run through both packages on the
CPU from the same seeded NumPy inputs: construction (from components and
from dense, on the host), ``tostype`` round trips, ``retain``, ``dot``
with and without ``transpose_a``, ``add`` (row-sparse stays row-sparse,
a dense operand densifies), the densifying binaries, ``zeros`` /
``empty`` / ``array`` and their refusals, ``dedupe_coo`` (indices and
values equal exactly, the sentinel slots included), and the store's
``row_sparse_pull``. Components compare exactly (indices, int32) or
within rtol 1e-6 (float32 values; ``dot`` 1e-5, a sum of products).
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


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _host(x):
    return onp.asarray(getattr(x, "_data", x))


def _parts(x):
    """A sparse array's storage type, shape and components as NumPy."""
    names = ("data", "indices", "indptr") if x.stype == "csr" \
        else ("data", "indices")
    return x.stype, tuple(x.shape), [_host(getattr(x, n)) for n in names]


def _same(got, want, rtol=1e-6):
    """Port against JAX: storage type, shape, index components exactly,
    values within ``rtol``, and the densified arrays."""
    if not hasattr(want, "stype") or want.stype == "default":
        assert getattr(got, "stype", "default") == "default"
        onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                    rtol=rtol, atol=1e-6)
        return
    gs, gshape, gparts = _parts(got)
    ws, wshape, wparts = _parts(want)
    assert (gs, gshape) == (ws, wshape)
    onp.testing.assert_allclose(gparts[0], wparts[0], rtol=rtol, atol=1e-6)
    for g, w in zip(gparts[1:], wparts[1:]):
        assert g.dtype == w.dtype == onp.int32
        onp.testing.assert_array_equal(g, w)
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=rtol,
                                atol=1e-6)


def _dense_rows(rows=8, cols=5, density=0.4, seed=0):
    rng = onp.random.RandomState(seed)
    d = rng.randn(rows, cols).astype("float32")
    d[rng.rand(rows) < (1 - density)] = 0
    return d


def _csr_dense(seed, shape=(6, 7), drop=0.6):
    rng = onp.random.RandomState(seed)
    d = rng.randn(*shape).astype("float32")
    d[rng.rand(*shape) < drop] = 0
    return d


# each case: a function of (package, its sparse module) returning arrays
CASES = {
    "row_sparse_from_dense":
        lambda m, sp: sp.row_sparse_array(_dense_rows()),
    "row_sparse_from_components":
        lambda m, sp: sp.row_sparse_array(
            (onp.ones((2, 3), "float32"), [1, 4]), shape=(6, 3)),
    "tostype_row_sparse":
        lambda m, sp: m.np.array(_dense_rows(seed=1)).tostype("row_sparse"),
    "tostype_csr":
        lambda m, sp: m.np.array(_dense_rows(seed=2)).tostype("csr"),
    "row_sparse_to_default":
        lambda m, sp: sp.row_sparse_array(_dense_rows(seed=3))
        .tostype("default"),
    "csr_to_default":
        lambda m, sp: sp.csr_matrix(_csr_dense(4)).tostype("default"),
    "retain":
        lambda m, sp: sp.retain(sp.row_sparse_array(
            (onp.arange(9, dtype="float32").reshape(3, 3), [0, 2, 5]),
            shape=(6, 3)), [2, 5]),
    "dot":
        lambda m, sp: sp.dot(sp.csr_matrix(_csr_dense(3)), m.np.array(
            onp.random.RandomState(5).randn(7, 4).astype("float32"))),
    "dot_transpose_a":
        lambda m, sp: sp.dot(sp.csr_matrix(_csr_dense(4, (5, 6), 0.5)),
                             m.np.array(onp.random.RandomState(6)
                                        .randn(5, 3).astype("float32")),
                             transpose_a=True),
    "csr_method_dot":
        lambda m, sp: sp.csr_matrix(_csr_dense(7)).dot(m.np.array(
            onp.random.RandomState(8).randn(7, 4).astype("float32"))),
    "zeros_row_sparse": lambda m, sp: sp.zeros("row_sparse", (4, 3)),
    "zeros_csr": lambda m, sp: sp.zeros("csr", (4, 3)),
    "empty_row_sparse": lambda m, sp: sp.empty("row_sparse", (3, 2)),
    "add_row_sparse":
        lambda m, sp: sp.add(
            sp.row_sparse_array((onp.ones((1, 2), "float32"), [1]),
                                shape=(4, 2)),
            sp.row_sparse_array((2 * onp.ones((2, 2), "float32"), [1, 3]),
                                shape=(4, 2))),
    "add_operator":
        lambda m, sp: sp.row_sparse_array(
            (onp.ones((1, 2), "float32"), [2]), shape=(4, 2))
        + sp.row_sparse_array((3 * onp.ones((2, 2), "float32"), [0, 2]),
                              shape=(4, 2)),
    "add_dense_densifies":
        lambda m, sp: sp.add(
            sp.row_sparse_array((onp.ones((1, 2), "float32"), [1]),
                                shape=(4, 2)), m.np.ones((4, 2))),
    "subtract":
        lambda m, sp: sp.subtract(sp.row_sparse_array(_dense_rows(seed=11)),
                                  sp.row_sparse_array(_dense_rows(seed=12))),
    "multiply":
        lambda m, sp: sp.multiply(sp.row_sparse_array(_dense_rows(seed=13)),
                                  m.np.array(_dense_rows(seed=14))),
    "divide":
        lambda m, sp: sp.divide(
            sp.row_sparse_array((onp.ones((1, 3), "float32") * 2, [2]),
                                shape=(4, 3)),
            sp.row_sparse_array((onp.ones((4, 3), "float32") * 4,
                                 onp.arange(4)), shape=(4, 3))),
    "array_copy_float16":
        lambda m, sp: sp.array(sp.row_sparse_array(_dense_rows(seed=15)),
                               dtype="float16"),
    "array_csr_copy_float16":
        lambda m, sp: sp.array(sp.csr_matrix(onp.eye(3, dtype="float32")),
                               dtype="float16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_case_matches_jax(case):
    want = CASES[case](mx, jsp)
    got = CASES[case](tmx, tsp)
    rtol = 1e-5 if "dot" in case else 1e-6
    _same(got, want, rtol=rtol)
    if hasattr(want, "dtype"):
        assert onp.dtype(got.dtype) == onp.dtype(want.dtype)


@pytest.mark.parametrize("k,vocab,width,seed", [(40, 12, 3, 1)])
def test_dedupe_coo_equals_jax_exactly(k, vocab, width, seed):
    rng = onp.random.RandomState(seed)
    idx = rng.randint(0, vocab, k)
    vals = rng.randn(k, width).astype("float32")
    import jax.numpy as jnp
    wi, wv = jsp.dedupe_coo(jnp.asarray(idx), jnp.asarray(vals), vocab)
    gi, gv = tsp.dedupe_coo(torch.from_numpy(idx), torch.from_numpy(vals),
                            vocab)
    assert gi.dtype == torch.int32
    onp.testing.assert_array_equal(gi.numpy(), onp.asarray(wi))
    onp.testing.assert_array_equal(gv.numpy(), onp.asarray(wv))


def test_dedupe_coo_sentinel_slots():
    gi, gv = tsp.dedupe_coo(torch.tensor([3, 1, 3, 7, 1, 3]),
                            torch.arange(6.0).reshape(6, 1), 10)
    assert gi.tolist() == [1, 3, 7, 10, 10, 10]
    assert gv.flatten().tolist() == [5.0, 7.0, 3.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("ids", [[0, 2, 5, 5], [1, 4, 5, 5], [4, 5, 5, 5],
                                 [5, 5, 5, 5], [0, 1, 2, 4]])
def test_set_rows_writes_no_sentinel_slot(ids):
    """The lazy rules' row writer: each real slot's row written, the
    sentinel slots (id 5 of 5 rows) nothing, the last row included."""
    table = torch.arange(10.0).reshape(5, 2)
    rows = -torch.arange(1.0, 9.0).reshape(4, 2)
    want = table.clone()
    for slot, i in enumerate(ids):
        if i < 5:
            want[i] = rows[slot]
    tsp._set_rows(table, torch.tensor(ids, dtype=torch.int32), rows)
    assert torch.equal(table, want)


@pytest.mark.parametrize("call,match", [
    (lambda sp: sp.array(onp.ones((2, 2), "float32")), "tostype"),
    (lambda sp: sp.retain(sp.csr_matrix(onp.eye(2, dtype="float32")), [0]),
     "RowSparseNDArray"),
    (lambda sp: sp.dot(sp.row_sparse_array(onp.eye(2, dtype="float32")),
                       onp.ones((2, 2), "float32")), "CSR"),
    (lambda sp: sp.zeros("bsr", (2, 2)), "stype"),
    (lambda sp: sp.row_sparse_array((onp.ones((1, 2), "float32"), [0])),
     "shape"),
])
def test_refusals_match_jax(call, match):
    with pytest.raises(JaxError, match=match):
        call(jsp)
    with pytest.raises(MXNetError, match=match):
        call(tsp)


def test_kvstore_row_sparse_pull_matches_jax():
    w = onp.arange(12, dtype="float32").reshape(6, 2)
    got = {}
    for pkg in (mx, tmx):
        kv = pkg.kv.create("device")
        kv.init("emb", pkg.np.array(w))
        rsp = kv.row_sparse_pull("emb", row_ids=pkg.np.array([4, 1, 1]))
        out = pkg.np.zeros((6, 2))
        kv.row_sparse_pull("emb", out=out, row_ids=pkg.np.array([5, 0]))
        got[pkg.__name__] = (rsp, out)
    _same(got["mxnet_tpu_torch"][0], got["mxnet_tpu"][0])
    _same(got["mxnet_tpu_torch"][1], got["mxnet_tpu"][1])


def test_parameter_row_sparse_data_matches_jax():
    got = {}
    w = onp.random.RandomState(0).randn(10, 4).astype("float32")
    for pkg in (mx, tmx):
        emb = pkg.gluon.nn.Embedding(10, 4, sparse_grad=True)
        emb.initialize()
        p = emb.collect_params()["weight"]
        p.set_data(pkg.np.array(w))
        got[pkg.__name__] = p.row_sparse_data(
            pkg.np.array([7, 2, 7], dtype="int64"))
    _same(got["mxnet_tpu_torch"], got["mxnet_tpu"])
