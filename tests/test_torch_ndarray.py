"""Port parity: the ``ndarray`` core, JAX package -> PyTorch port.

The cases of ``tests/test_ndarray.py`` (creation, arithmetic, comparison,
in-place rebinding and ``version``, ``__setitem__``, indexing, methods,
``wait_to_read``, contexts, ``copyto``, the namespace, ``einsum`` /
``where``, ``npx.save`` / ``load``, NumPy interop, ``out=`` and the fluent
tail) each written once as a function of the package and run through
both: ``mxnet_tpu`` and ``mxnet_tpu_torch`` (on the CPU, ``with
mx.cpu():``). Results are compared by structure, shape and dtype exactly,
integers and bools exactly, float32 within rtol 1e-5 + atol 1e-6, Python
scalars within 1e-6. Also pinned: aliasing (an earlier result, a view of
the old storage included, never sees a later write), ``attach_grad`` with
``grad_req`` "write" and "add" against the JAX package, and an attached
array across a rebind; the 32-bit dtype rules (Python ints int32, host
float64 -> float32, host int64 kept, explicit 64-bit honoured).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.test_utils import assert_almost_equal

torch.set_num_threads(2)


def _match(got, want, name="result"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), name
        for k in want:
            _match(got[k], want[k], f"{name}[{k}]")
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            _match(g, w, f"{name}[{i}]")
        return
    if hasattr(want, "asnumpy"):
        w = want.asnumpy()
        tol = (1e-5, 1e-6) if w.dtype.kind == "f" else (0, 0)
        assert_almost_equal(got, w, rtol=tol[0], atol=tol[1],
                            names=(name, "jax"), check_dtype=True)
        return
    if isinstance(want, onp.ndarray):
        assert isinstance(got, onp.ndarray), name
        assert got.dtype == want.dtype, name
        onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                    err_msg=name)
        return
    if isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6), name
        return
    assert got == want, f"{name}: {got!r} vs {want!r}"


def _both(fn):
    """``fn(package)`` through the JAX package and the port (on the CPU);
    the port's result must be the reference's."""
    want = fn(mx)
    with tmx.cpu():
        got = fn(tmx)
    _match(got, want)
    return got, want


def test_creation():
    def fn(m):
        np = m.np
        a = np.array([[1, 2], [3, 4]], dtype="float32")
        return [a, a.shape, str(a.dtype), a.size, a.ndim, np.zeros((3, 4)),
                float(np.zeros((3, 4)).sum()), np.ones((2, 3), dtype="int32"),
                np.full((2, 2), 7.0), np.full((2,), 7), np.arange(10),
                np.arange(1, 7, 2), np.arange(0.0, 1.0, 0.25), np.eye(3),
                np.eye(3, 4, 1), np.identity(2), np.linspace(0.0, 1.0, 5),
                np.logspace(0.0, 2.0, 4), np.zeros_like(a),
                np.ones_like(a, dtype="int32"), np.full_like(a, 3.0),
                np.empty((2, 2)).shape, np.array(1.5), np.array(True)]
    _both(fn)


def test_the_32_bit_dtype_rules():
    """Python ints give int32 and floats float32; a host float64 array
    gives float32, a host int64 one stays int64; an explicit 64-bit dtype
    is honoured; reductions of ints stay int32 and their mean is float32;
    an index result is int32."""
    def fn(m):
        np = m.np
        i = np.array([[1, 2], [3, 4]])
        return [i, np.array([1.5, 2.5]), np.array(onp.ones(2)),
                np.array(onp.arange(3, dtype=onp.int64)),
                np.array(onp.ones(2, onp.complex128)),
                np.array([1, 2], dtype="float64"),
                np.zeros(2, dtype="float64"), i.sum(), i.mean(), i.prod(),
                i.max(), np.argmax(i), i.cumsum(), i + 2.5, i / i,
                np.array([True, False]) + 1, np.sqrt(i),
                np.array(onp.arange(3, dtype=onp.int64)).sum(),
                np.array(onp.arange(3, dtype=onp.int64)).mean(),
                np.median(np.array([1, 2, 3, 4])), np.hanning(4),
                np.unique(np.array([3, 1, 3, 2]), return_index=True,
                          return_inverse=True, return_counts=True)]
    _both(fn)


def test_arithmetic():
    def fn(m):
        np = m.np
        a = np.array([1.0, 2.0, 3.0])
        b = np.array([4.0, 5.0, 6.0])
        return [a + b, a - b, a * b, b / a, a ** 2, 2 + a, 2 * a, 2 - a,
                2 / a, 2 ** a, -a, abs(-a), a @ b, a // 2, a % 2,
                a + onp.array([1.0, 1.0, 1.0]), a + [1.0, 2.0, 3.0]]
    _both(fn)


def test_comparison_and_bitwise():
    def fn(m):
        np = m.np
        a = np.array([1.0, 2.0, 3.0])
        b = np.array([3.0, 2.0, 1.0])
        i = np.array([5, 6, 7])
        return [a == b, a != b, a < b, a <= b, a > b, a >= b, a == 2.0,
                i & 3, i | 8, i ^ 1, ~i, i << 1, i >> 1,
                (a == b).asnumpy().tolist()]
    _both(fn)


def test_inplace_rebind_version():
    def fn(m):
        np = m.np
        a = np.array([1.0, 2.0])
        v0 = a.version
        a += 1
        r1 = (a.copy(), a.version - v0)
        a[:] = 5.0
        r2 = (a.copy(), a.version - v0)
        a *= 2
        a -= 1
        a /= 3
        return [r1, r2, a, a.version - v0]
    _both(fn)


def test_setitem():
    def fn(m):
        np = m.np
        a = np.zeros((3, 3))
        a[1, 1] = 5.0
        a[0] = onp.array([1.0, 2.0, 3.0])
        a[:, 2] = 9.0
        a[np.array([2])] = np.array([7.0, 7.0, 7.0])
        b = np.arange(6).reshape(2, 3)
        b[b > 3] = 0
        b[..., 0] = -1
        return [a, float(a[1, 1]), b, a.version, b.version]
    _both(fn)


def test_indexing():
    def fn(m):
        np = m.np
        a = np.arange(24).reshape(2, 3, 4)
        idx = np.array([0, 1], dtype="int32")
        return [a[1, 2, 3].item(), a[0], a[:, 1], a[..., 0], a[a > 10],
                a[idx], a[1, ::-1], a[:, ::-2, 1:3], a[None, 0, :, None],
                a[[1, 0]], a[0, 1:3], len(a), [x.shape for x in a],
                int(a[1, 1, 1]) in a]
    _both(fn)


def test_methods():
    def fn(m):
        np = m.np
        a = np.arange(6, dtype="float32").reshape(2, 3)
        return [a.T, a.reshape(3, 2), a.reshape(-1), a.reshape((3, 2)),
                a.flatten(), a.sum(), a.mean(), a.max(), a.min(),
                a.argmax(), a.argmin(), a.sum(axis=0),
                a.sum(axis=1, keepdims=True), a.mean(axis=1), a.prod(),
                a.std(), a.var(ddof=1), a.expand_dims(0),
                a.expand_dims(0).squeeze(0), a.astype("int32"), a.copy(),
                a.transpose(1, 0), a.swapaxes(0, 1), a.repeat(2, axis=0),
                a.tile((2, 1)), a.broadcast_to((2, 2, 3)), a.split(3, axis=1),
                a.take(np.array([0, 2]), axis=1), a.clip(1.0, 4.0),
                (a / 3).round(2), a.argsort(axis=1), (-a).sort(axis=1),
                a.cumsum(axis=1), a.dot(a.T), a.abs(), a.exp(), a.sqrt(),
                a.square(), a.sigmoid(), a.tanh(), (a - 2).relu(),
                (a > 2).any(), (a > 2).all(axis=1), a.tolist(),
                a.asnumpy(), a.item(4), a.size, a.itemsize]
    _both(fn)


def test_asnumpy_wait():
    def fn(m):
        a = m.np.ones((4, 4))
        b = (a * 2).wait_to_read()
        m.waitall() if hasattr(m, "waitall") else m.npx.waitall()
        host = b.asnumpy()
        host[0, 0] = 7.0  # an owned copy: the array does not change
        return [b, host.flags["C_CONTIGUOUS"], host.flags["WRITEABLE"]]
    _both(fn)


def test_context_placement():
    def fn(m):
        a = m.np.ones((2, 2), ctx=m.cpu())
        b = a.as_in_ctx(m.cpu(0))
        return [a, b, str(a.ctx), a.ctx.device_type, b.ctx == m.cpu(0),
                m.cpu(1) == m.cpu(1), m.gpu(0).device_type]
    _both(fn)


def test_copyto():
    def fn(m):
        a = m.np.ones((2, 2))
        b = m.np.zeros((2, 2), dtype="int32")
        alias = b
        r = a.copyto(b)
        return [b, alias, r is b, b.version]
    _both(fn)


def test_generated_namespace():
    def fn(m):
        np = m.np
        a = np.array([1.0, 4.0, 9.0])
        return [np.sqrt(a), np.exp(np.zeros(3)), np.maximum(a, 5.0),
                np.minimum(5.0, a), np.sin(np.zeros(2)),
                np.split(np.arange(6), 3), np.concatenate([a, a]),
                np.stack([a, a], axis=1), np.linalg.norm(np.ones(4))]
    _both(fn)


def test_einsum_where():
    def fn(m):
        np = m.np
        c = np.einsum("ij,jk->ik", np.ones((2, 3)), np.ones((3, 4)))
        w = np.where(np.array([True, False]), np.ones(2), np.zeros(2))
        return [c, w, np.where(np.array([True, False]), 1.0, 0.0),
                np.where(np.array([[1, 0], [0, 1]]))]
    _both(fn)


def test_random_seeded_streams():
    """Each package's seeded stream repeats under its own seed (the
    streams themselves differ: threefry against Philox / MT)."""
    for m in (mx, tmx):
        with tmx.cpu():
            m.random.seed(42)
            a = m.np.random.uniform(0, 1, size=(100,)).asnumpy()
            m.random.seed(42)
            b = m.np.random.uniform(0, 1, size=(100,)).asnumpy()
            onp.testing.assert_array_equal(a, b)
            c = m.np.random.normal(0, 1, size=(1000,))
            assert abs(float(c.mean())) < 0.2
            d = m.np.random.randint(0, 10, size=(50,))
            assert int(d.max()) < 10 and d.dtype == onp.int32
            assert m.np.random.choice(5, size=(3,)).shape == (3,)


def test_save_load_across_packages(tmp_path):
    def fn(m):
        path = str(tmp_path / f"{m.__name__}.npz")
        m.npx.save(path, {"w": m.np.ones((3, 3)), "b": m.np.zeros(3)})
        return m.npx.load(path)
    _both(fn)


def test_numpy_interop():
    def fn(m):
        np = m.np
        a = np.ones((2, 2))
        t = np.array(onp.arange(4).reshape(2, 2))
        return [onp.asarray(a), t, onp.sum(a), onp.exp(a), onp.add(a, 1.0),
                onp.concatenate([a, a]), onp.asarray(a, dtype="float64")]
    _both(fn)


def test_out_writes_through():
    def fn(m):
        np = m.np
        a, b = np.ones((3,)), np.full((3,), 2.0)
        c = np.zeros((3,))
        alias = c
        r = np.add(a, b, out=c)
        d = np.zeros((3,), dtype="int32")
        np.multiply(a, b, out=d)
        dest = np.zeros((4, 3))
        x = np.arange(6, dtype="float32").reshape(2, 3)
        r2 = np.concatenate([x, x], axis=0, out=dest)
        errs = []
        for bad in (np.zeros((4,)), onp.zeros(3)):
            try:
                np.add(a, b, out=bad)
            except (ValueError, TypeError) as e:
                errs.append(type(e).__name__)
        return [r is c, alias, c.version, d, r2 is dest, dest, errs]
    _both(fn)


def test_out_under_autograd():
    def fn(m):
        np = m.np
        x = np.ones((3,))
        x.attach_grad()
        dest = np.zeros((3,))
        with m.autograd.record():
            y = np.multiply(x, np.full((3,), 4.0), out=dest)
            z = (y * y).sum()
        z.backward()
        return [z, x.grad]
    _both(fn)


def test_fluent_tail():
    """The reference's fluent methods that the port has ops for, and the
    AttributeError contract for names outside the list."""
    def fn(m):
        a = m.np.array([[1.0, 3.0], [2.0, 0.0]])
        out = [a.log_softmax(), a.norm(), a.slice_axis(axis=1, begin=0,
                                                        end=1),
               a.pick(m.np.array([1, 0])), a.flip(axis=1), a.sigmoid(),
               a.sin(), a.log1p(), a.trunc(), a.tile((1, 2)),
               hasattr(a, "not_an_op"), hasattr(a, "dtype_")]
        a.attach_grad()
        with m.autograd.record():
            s = a.sigmoid().sum()
        s.backward()
        return out + [a.grad]
    _both(fn)


# -- pins ------------------------------------------------------------------------

def test_a_view_never_sees_a_later_write():
    """``c = b[0]; b[:] = 5`` leaves ``c`` as it was (torch's indexing
    returns a view; the rebind gives ``b`` new storage instead of writing
    through it), and likewise after ``b += 1``, ``b[1] = ...``,
    ``copyto`` and ``out=``."""
    def fn(m):
        np = m.np
        b = np.arange(6, dtype="float32").reshape(2, 3)
        c, row, t = b[0], b[:, 1], b.T
        b[:] = 5.0
        b += 1
        b[1] = np.zeros(3)
        np.ones((2, 3)).copyto(b)
        np.add(b, b, out=b)
        return [c, row, t, b]
    got, _ = _both(fn)
    assert got[0].asnumpy().tolist() == [0.0, 1.0, 2.0]


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_attach_grad_write_and_add_match_jax(grad_req):
    """Two backwards: "write" keeps the last gradient, "add" sums both (an
    attached array's buffer starts at zero); ``zero_grad`` clears it."""
    def fn(m):
        np = m.np
        x = np.array([[1.0, -2.0], [0.5, 3.0]])
        x.attach_grad(grad_req=grad_req)
        first = None
        for k in (1.0, 3.0):
            with m.autograd.record():
                y = (np.tanh(x) * k + x * x).sum()
            y.backward()
            first = first if first is not None else x.grad.copy()
        out = [first, x.grad.copy(), x._grad_req]
        x.zero_grad()
        return out + [x.grad]
    _both(fn)


def test_attached_array_stays_attached_across_a_rebind():
    """``x[:] = v`` and ``copyto`` rebind an attached array to new storage;
    it stays a leaf, and its gradient is that of the new values."""
    def fn(m):
        np = m.np
        x = np.ones((3,))
        x.attach_grad()
        x[:] = np.array([1.0, 2.0, 3.0])
        with m.autograd.record():
            (x * x).sum().backward()
        g1 = x.grad.copy()
        np.array([4.0, 5.0, 6.0]).copyto(x)
        with m.autograd.record():
            (x * x * x).sum().backward()
        return [g1, x.grad, x]
    _both(fn)


def test_recorded_setitem_carries_the_graph():
    """Under ``record()`` a set into a recorded array is part of the
    graph, as the reference's entry moves to the set's result."""
    def fn(m):
        np = m.np
        x = np.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with m.autograd.record():
            y = x * 2
            y[1] = 0.0
            z = (y * x).sum()
        z.backward()
        return [z, x.grad]
    _both(fn)


def test_autograd_grad_returns_arrays():
    def fn(m):
        np = m.np
        x = np.array([0.5, 1.5])
        x.attach_grad()
        with m.autograd.record():
            y = (x ** 3).sum()
        g = m.autograd.grad(y, [x])
        return [g[0]]
    _both(fn)


def test_bf16_asnumpy_widens_exactly():
    """bf16 arrays read back as float32 holding the same values (the
    reference returns ml_dtypes.bfloat16, which the port does not need)."""
    with tmx.cpu():
        a = tmx.np.array([1.0, 1.00390625, -3.5e-3], dtype="bfloat16")
        host = a.asnumpy()
        assert a.dtype == "bfloat16" and a.dtype == torch.bfloat16
        assert host.dtype == onp.float32
        want = mx.np.array([1.0, 1.00390625, -3.5e-3],
                           dtype="bfloat16").asnumpy().astype(onp.float32)
        onp.testing.assert_array_equal(host, want)


def test_creation_without_a_context_needs_the_card():
    """With no scope and no device the port places on ``cuda:0``: without
    a card that raises (nothing carries on on the host unasked)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        tmx.np.zeros((2,))
    with tmx.cpu():
        assert tmx.np.zeros((2,)).ctx == tmx.cpu()
    assert tmx.current_context() == tmx.gpu(0)


def test_dlpack_shares_memory_and_crosses_packages():
    """``dlpack``: no copy either way, and a capsule of either package is
    read by the other (the CPU)."""
    t = torch.arange(6, dtype=torch.float32)
    a = tmx.dlpack.from_dlpack(t)
    assert a.shape == (6,) and tmx.np.may_share_memory(a, tmx.np.from_dlpack(
        t)) and a._data.data_ptr() == t.data_ptr()
    back = torch.utils.dlpack.from_dlpack(
        tmx.dlpack.ndarray_to_dlpack_for_write(a))
    assert back.data_ptr() == t.data_ptr()
    with tmx.cpu():
        x = tmx.np.array([[1.5, -2.0], [3.0, 4.25]])
    capsule = tmx.dlpack.to_dlpack_for_read(x)
    onp.testing.assert_array_equal(
        torch.utils.dlpack.from_dlpack(capsule).numpy(), x.asnumpy())
    j = mx.dlpack.ndarray_from_dlpack(x)  # the __dlpack__ protocol
    onp.testing.assert_array_equal(j.asnumpy(), x.asnumpy())
    y = mx.np.array([[1.0, 2.0]])
    z = tmx.dlpack.from_dlpack(mx.dlpack.ndarray_to_dlpack_for_read(y))
    assert z.dtype == onp.float32
    onp.testing.assert_array_equal(z.asnumpy(), y.asnumpy())


def test_util_matches_jax():
    def fn(m):
        u = m.util
        with u.np_shape(True) as s, u.np_array(True) as a:
            scopes = (s, a)
        f = u.use_np(lambda: 3)
        u.set_np()
        u.reset_np()
        u.setenv("MXNET_PORT_UTIL_PROBE", "7")
        env = u.getenv("MXNET_PORT_UTIL_PROBE")
        u.setenv("MXNET_PORT_UTIL_PROBE", None)

        @u.set_module("mxnet.numpy")
        def g():
            pass
        return [u.is_np_array(), u.is_np_shape(), scopes, f(), env,
                u.getenv("MXNET_PORT_UTIL_PROBE"), g.__module__,
                u.default_array([1, 2], dtype="float32"), u.get_gpu_count()]
    _both(fn)
