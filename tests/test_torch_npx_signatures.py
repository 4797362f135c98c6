"""Port parity: the ``npx`` ops with the reference's signatures, JAX
package -> PyTorch port.

``fully_connected(num_hidden=, no_bias=)``, ``layer_norm(data, gamma,
beta, axis=, eps=)``, ``softmax(length=, use_length=)`` and
``log_softmax`` (masked positions written 0), ``embedding(input_dim=,
output_dim=, dtype=, sparse_grad=)`` and ``pooling``'s "sum" / "lp" pool
types and ``pooling_convention`` values, each called with ``mx.np``
arrays in both packages (on the CPU): the port returns ``ndarray``s of the
reference's shape and dtype, with values within rtol 1e-5 + atol 1e-6
(float32) and gradients likewise. ``sparse_grad=True`` gives the same
rows, and a recorded call the reference's row-sparse weight gradient. ``npx.save`` in either package is read
by ``npx.load`` in the other, values and dtypes exactly.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.test_utils import assert_almost_equal

torch.set_num_threads(2)

RS = onp.random.RandomState(21)
X = RS.randn(3, 5, 6).astype("float32")
W = RS.randn(4, 6).astype("float32")
B = RS.randn(4).astype("float32")
G = RS.rand(6).astype("float32") + 0.5
BETA = RS.randn(6).astype("float32")
IMG = RS.randn(2, 3, 7, 6).astype("float32")
LEN = onp.array([2, 6, 4], dtype="int32")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _match(got, want, name):
    assert isinstance(got, tmx.np.ndarray), f"{name}: {type(got)}"
    w = want.asnumpy()
    tol = (1e-5, 1e-6) if w.dtype.kind == "f" else (0, 0)
    assert_almost_equal(got, w, rtol=tol[0], atol=tol[1],
                        names=(name, "jax"), check_dtype=True)


CASES = {
    "fully_connected": lambda m, a: m.npx.fully_connected(
        a(X), a(W), a(B), num_hidden=4, flatten=False),
    "fully_connected_flatten": lambda m, a: m.npx.fully_connected(
        a(X), a(onp.tile(W, (1, 5))), a(B), num_hidden=4),
    "fully_connected_no_bias": lambda m, a: m.npx.fully_connected(
        a(X), a(W), a(B), num_hidden=4, no_bias=True, flatten=False),
    "layer_norm": lambda m, a: m.npx.layer_norm(a(X), a(G), a(BETA),
                                                eps=1e-5),
    "layer_norm_axis1": lambda m, a: m.npx.layer_norm(
        a(X.transpose(0, 2, 1)), a(G), a(BETA), axis=1, eps=1e-3),
    "softmax": lambda m, a: m.npx.softmax(a(X), axis=-1),
    "softmax_temperature": lambda m, a: m.npx.softmax(a(X), axis=1,
                                                      temperature=2.0),
    "softmax_length": lambda m, a: m.npx.softmax(
        a(X[:, 0]), length=a(LEN), use_length=True),
    "softmax_length_3d": lambda m, a: m.npx.softmax(
        a(X), length=a(onp.array([[1, 2, 3, 4, 5], [6, 5, 4, 3, 2],
                                  [1, 1, 6, 6, 3]], "int32")),
        use_length=True),
    "log_softmax": lambda m, a: m.npx.log_softmax(a(X), axis=-1),
    "log_softmax_length": lambda m, a: m.npx.log_softmax(
        a(X[:, 0]), length=a(LEN), use_length=True),
    "embedding": lambda m, a: m.npx.embedding(
        a(onp.array([[0, 3], [2, 1]], "int32")), a(W), input_dim=4,
        output_dim=6, dtype="float32"),
    "pooling_sum": lambda m, a: m.npx.pooling(a(IMG), kernel=(2, 2),
                                              stride=(2, 2), pool_type="sum"),
    "pooling_sum_pad": lambda m, a: m.npx.pooling(
        a(IMG), kernel=(3, 3), stride=(1, 2), pad=(1, 1), pool_type="sum"),
    "pooling_lp": lambda m, a: m.npx.pooling(a(IMG), kernel=(2, 3),
                                             pool_type="lp", p_value=2),
    "pooling_lp3": lambda m, a: m.npx.pooling(a(IMG), kernel=(2, 2),
                                              pool_type="lp", p_value=3),
    "pooling_global_sum": lambda m, a: m.npx.pooling(
        a(IMG), pool_type="sum", global_pool=True),
    "pooling_global_lp": lambda m, a: m.npx.pooling(
        a(IMG), pool_type="lp", global_pool=True, p_value=2),
    "pooling_full": lambda m, a: m.npx.pooling(
        a(IMG), kernel=(2, 2), stride=(2, 2), pool_type="max",
        pooling_convention="full"),
    "pooling_same": lambda m, a: m.npx.pooling(
        a(IMG), kernel=(3, 3), pad=(1, 1), pool_type="avg",
        pooling_convention="same"),
    "pooling_1d_sum": lambda m, a: m.npx.pooling(
        a(X), kernel=(2,), stride=(2,), pool_type="sum", layout="NCW"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_npx_op_matches_jax(name):
    want = CASES[name](mx, mx.np.array)
    got = CASES[name](tmx, tmx.np.array)
    _match(got, want, name)


GRAD_CASES = ("fully_connected", "layer_norm_axis1", "softmax_length",
              "log_softmax_length", "pooling_sum_pad", "pooling_lp")


@pytest.mark.parametrize("name", GRAD_CASES)
def test_npx_gradient_matches_jax(name):
    """The gradient of every array input of the case, through autograd."""
    grads = []
    for m in (mx, tmx):
        inputs = []

        def arr(v, m=m, inputs=inputs):
            a = m.np.array(v)
            if a.dtype == onp.float32:
                a.attach_grad()
                inputs.append(a)
            return a
        with m.autograd.record():
            out = CASES[name](m, arr)
            y = (out * out).sum()
        y.backward()
        grads.append([a.grad for a in inputs])
    for i, (g, w) in enumerate(zip(*reversed(grads))):
        _match(g, w, f"{name} d{i}")


def test_tensor_calls_return_tensors():
    """The model zoo's own calls pass tensors and get tensors back."""
    out = tmx.npx.fully_connected(torch.from_numpy(X), torch.from_numpy(W),
                                  torch.from_numpy(B), flatten=False)
    assert type(out) is torch.Tensor
    ref = tmx.npx.fully_connected(tmx.np.array(X), tmx.np.array(W),
                                  tmx.np.array(B), flatten=False)
    assert torch.equal(out, ref._data)


def test_embedding_sparse_grad_raises():
    """No longer raises (sparse storage is ported): the rows are the
    reference's, and a recorded call's weight gradient is row-sparse in
    both packages, equal densified."""
    got = {}
    for pkg in (mx, tmx):
        w = pkg.np.array(W)
        w.attach_grad()
        with pkg.autograd.record():
            out = pkg.npx.embedding(pkg.np.array(onp.array([0, 3, 0],
                                                           "int32")), w,
                                    input_dim=4, output_dim=6,
                                    sparse_grad=True)
            loss = (out * out).sum()
        loss.backward()
        got[pkg.__name__] = (out.asnumpy(), w.grad)
    onp.testing.assert_allclose(got["mxnet_tpu_torch"][0],
                                got["mxnet_tpu"][0], rtol=1e-6)
    tg, jg = got["mxnet_tpu_torch"][1], got["mxnet_tpu"][1]
    assert tg.stype == jg.stype == "row_sparse"
    onp.testing.assert_allclose(tg.asnumpy(), jg.asnumpy(), rtol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_in_one_package_loads_in_the_other(writer, tmp_path):
    path = str(tmp_path / "arrays.npz")
    data = {"w": X, "ids": LEN, "mask": X > 0,
            "half": X[0].astype("float16")}
    src, dst = (mx, tmx) if writer == "jax" else (tmx, mx)
    src.npx.save(path, {k: src.np.array(v) for k, v in data.items()})
    loaded = dst.npx.load(path)
    assert sorted(loaded) == sorted(data)
    for k, v in data.items():
        got = loaded[k].asnumpy()
        assert got.dtype == v.dtype, k
        onp.testing.assert_array_equal(got, v)
