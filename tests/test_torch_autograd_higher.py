"""Port parity: higher-order autograd (``grad(create_graph=True)``), the
custom ``Function`` and ``get_symbol``.

The reference's cases (``tests/test_autograd.py:199-300``) run in both
packages from the same inputs: sin to third order, ``create_graph``
then ``backward``, a mixed partial, a gradient penalty through a Dense
tanh layer and through a hybridized one (on the CPU a hybridized block
runs eagerly, so its second derivative is the eager one; on the card a
replayed CUDA graph is first-order only and raises, pinned in
``tests/test_torch_training_cuda.py``), and the custom ``Function``
failing fast under ``create_graph``. Tolerance rtol 1e-5 (1e-4 for the
penalties), as the reference's tests. Also: a second derivative through a
kernel's ``torch.autograd.Function`` (ln_residual, here through its plain
version) raises ``MXNetError`` instead of returning zeros, a gradient
penalty through the fused and the chunked softmax cross-entropy against
the reference's, and a float64 gradgradcheck of a small chain.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import numpy as jnp_

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _close(got, want, rtol=1e-5, atol=1e-6):
    got = got.asnumpy() if hasattr(got, "asnumpy") else got
    want = want.asnumpy() if hasattr(want, "asnumpy") else want
    onp.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _sin_chain(pkg, np_mod, ag):
    x = np_mod.array(onp.array([0.3, 1.1, -0.7], onp.float32))
    x.attach_grad()
    with ag.record():
        y = np_mod.sin(x)
        g1 = ag.grad(y, x, create_graph=True)
        g2 = ag.grad(g1, x, create_graph=True)
        g3 = ag.grad(g2, x)
    return g1, g2, g3


def test_create_graph_sin_chain():
    xs = onp.array([0.3, 1.1, -0.7], onp.float32)
    tg = _sin_chain(tmx, tmx.np, tag)
    jg = _sin_chain(mx, jnp_, jag)
    for got, want, oracle in zip(tg, jg, (onp.cos(xs), -onp.sin(xs),
                                          -onp.cos(xs))):
        _close(got, want)
        _close(got, oracle)


def _then_backward(np_mod, ag):
    x = np_mod.array([2.0, 3.0])
    x.attach_grad()
    with ag.record():
        y = (x ** 3).sum()
        g = ag.grad(y, x, create_graph=True)
        gs = g.sum()
    gs.backward()
    return x.grad


def test_create_graph_then_backward():
    got = _then_backward(tmx.np, tag)
    _close(got, _then_backward(jnp_, jag))
    _close(got, onp.array([12.0, 18.0]))


def _mixed(np_mod, ag):
    x, y = np_mod.array([2.0]), np_mod.array([3.0])
    x.attach_grad()
    y.attach_grad()
    with ag.record():
        f = x * y * y
        gx = ag.grad(f, x, create_graph=True)
        gxy = ag.grad(gx, y)
    return gxy


def test_create_graph_mixed_partial():
    got = _mixed(tmx.np, tag)
    _close(got, _mixed(jnp_, jag))
    _close(got, onp.array([6.0]))


def _penalty(np_mod, ag, net, x_host):
    x = np_mod.array(x_host)
    x.attach_grad()
    with ag.record():
        out = net(x).sum()
        g = ag.grad(out, x, create_graph=True)
        penalty = (g * g).sum()
    penalty.backward()
    return x.grad


def _dense_pair(units, in_units, seed, hybrid):
    tnet = tnn.Dense(units, activation="tanh", device="cpu")
    tnet.initialize(seed=seed)
    jnet = mx.gluon.nn.Dense(units, activation="tanh")
    jnet.initialize()
    x = onp.random.RandomState(seed).randn(2, in_units).astype("float32")
    tnet(torch.from_numpy(x))
    jnet(mx.np.array(x))
    for (_, tp), (_, jp) in zip(tnet.collect_params().items(),
                                jnet.collect_params().items()):
        jp.set_data(mx.np.array(tp.data().detach().numpy()))
    if hybrid:
        tnet.hybridize()
        jnet.hybridize()
    return tnet, jnet, x


@pytest.mark.parametrize("hybrid", [False, True])
def test_create_graph_gradient_penalty(hybrid):
    """WGAN-GP style: the penalty on the input gradient's norm,
    differentiated again, through a Dense tanh layer (hybridized or not):
    the weights' gradients and the input's second derivative against the
    JAX package."""
    tnet, jnet, x = _dense_pair(4, 3, 7, hybrid)
    tgx = _penalty(tmx.np, tag, tnet, x)
    jgx = _penalty(jnp_, jag, jnet, x)
    _close(tgx, jgx, rtol=1e-4, atol=1e-5)
    for (_, tp), (_, jp) in zip(tnet.collect_params().items(),
                                jnet.collect_params().items()):
        tw = tp.grad().numpy()
        assert onp.isfinite(tw).all() and onp.abs(tw).sum() > 0
        _close(tw, jp.grad().asnumpy(), rtol=1e-4, atol=1e-5)


def test_create_graph_through_hybridized_equals_eager():
    """The reference's oracle: the hybridized block's second derivative
    equals a fresh eager block's with the same parameters."""
    hnet, _, _ = _dense_pair(3, 2, 3, True)
    enet, _, _ = _dense_pair(3, 2, 3, False)
    x = onp.array([[0.1, 0.2], [0.3, -0.4]], "float32")
    _close(_penalty(tmx.np, tag, hnet, x), _penalty(tmx.np, tag, enet, x),
           rtol=1e-4, atol=1e-5)


class _DoubleT(tag.Function):
    def forward(self, x):
        return x * 2

    def backward(self, dy):
        return dy * 2


def test_create_graph_function_fails_fast():
    f = _DoubleT()
    x = tmx.np.array([1.0])
    x.attach_grad()
    with pytest.raises(MXNetError, match="create_graph"):
        with tag.record():
            y = f(x)
            tag.grad(y, x, create_graph=True)


def test_custom_function_first_order_matches_jax():
    class Sig(tag.Function):
        def forward(self, x):
            y = 1 / (1 + tmx.np.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    class JSig(jag.Function):
        def forward(self, x):
            y = 1 / (1 + jnp_.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    xs = onp.array([-1.0, 0.2, 3.0], "float32")
    out = []
    for np_mod, ag, fn in ((tmx.np, tag, Sig()), (jnp_, jag, JSig())):
        x = np_mod.array(xs)
        x.attach_grad()
        with ag.record():
            y = fn(x)
        y.backward()
        out.append((y, x.grad))
    _close(out[0][0], out[1][0])
    _close(out[0][1], out[1][1])


def test_second_derivative_through_a_kernel_function_raises():
    """ln_residual's Function (the kernel on the card, its plain version
    here) has a first-order backward: create_graph through it raises
    instead of giving a zero second derivative; first order works."""
    from mxnet_tpu_torch.ops.ln_residual import ln_residual_dropout
    rs = onp.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, 8).astype("float32")).requires_grad_()
    h = torch.from_numpy(rs.randn(4, 8).astype("float32"))
    g, b = torch.ones(8), torch.zeros(8)
    with tag.record():
        y = (ln_residual_dropout(x, h, g, b) ** 2).sum()
    with pytest.raises(MXNetError, match="LnResidualFunction"):
        tag.grad(y, [x], create_graph=True)
    gx, = tag.grad(y, [x])
    assert torch.isfinite(gx).all()


@pytest.mark.parametrize("chunk", [4, 7])
def test_chunked_lm_xent_second_derivative_matches_jax(chunk):
    """A gradient penalty through ``chunked_lm_xent``: its backward
    recomputes lse where autograd sees it under ``create_graph``, so the
    second derivative in h and w is the reference's (which differentiates
    its ``jax.custom_vjp``'s VJP), at chunks that do and do not divide
    the vocabulary."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import xent as jxent
    from mxnet_tpu_torch.ops import xent as txent
    rs = onp.random.RandomState(7)
    h = rs.randn(5, 6).astype("float32")
    w = (rs.randn(13, 6) * 0.5).astype("float32")
    lab = onp.array([0, 12, 3, 20, 7], "int32")  # 20 clips

    def penalty(hh, ww):
        gh = jax.grad(lambda a: jxent.chunked_lm_xent(
            a, ww, jnp.asarray(lab), chunk).sum())(hh)
        return (gh * gh).sum()

    want_h, want_w = jax.grad(penalty, argnums=(0, 1))(jnp.asarray(h),
                                                       jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    with tag.record():
        loss = txent.chunked_lm_xent(th, tw, torch.from_numpy(lab), chunk)
        gh, = tag.grad(loss.sum(), [th], create_graph=True)
        pen = (gh * gh).sum()
    pen.backward()
    _close(th.grad.numpy(), onp.asarray(want_h), rtol=1e-4, atol=1e-5)
    _close(tw.grad.numpy(), onp.asarray(want_w), rtol=1e-4, atol=1e-5)


def test_sparse_softmax_xent_second_derivative_matches_jax():
    """The gradient penalty of the fused softmax cross-entropy (the
    softmax loss's sparse-label path): its backward rebuilds lse where
    autograd sees it under ``create_graph``, so the second derivative is
    the reference's (its ``jax.custom_vjp`` re-linearized)."""
    rs = onp.random.RandomState(6)
    logits = rs.randn(4, 7).astype("float32")
    labels = onp.array([1, 0, 6, 3], "int32")
    out = []
    for np_mod, ag, loss in (
            (tmx.np, tag, tmx.gluon.loss.SoftmaxCrossEntropyLoss()),
            (jnp_, jag, mx.gluon.loss.SoftmaxCrossEntropyLoss())):
        x = np_mod.array(logits)
        x.attach_grad()
        with ag.record():
            g = ag.grad(loss(x, np_mod.array(labels)).sum(), x,
                        create_graph=True)
            pen = (g * g).sum()
        pen.backward()
        out.append((g, x.grad))
    _close(out[0][0], out[1][0])
    _close(out[0][1], out[1][1])


def test_get_symbol_raises_as_the_reference():
    with pytest.raises(MXNetError):
        tag.get_symbol(tmx.np.array([1.0]))
    with pytest.raises(mx.base.MXNetError):
        jag.get_symbol(mx.np.array([1.0]))


def test_third_order_gradgradcheck_float64():
    x = torch.randn(5, dtype=torch.float64, requires_grad=True)

    def f(v):
        return (torch.tanh(v) * v ** 2).sum()

    def first(v):
        return tag.grad(f(v), [v], create_graph=True)[0]

    assert torch.autograd.gradcheck(first, (x,))
    assert torch.autograd.gradgradcheck(first, (x,))
