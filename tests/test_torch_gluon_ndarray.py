"""Port parity: the slice as a whole, Gluon driven from ``mx.np`` arrays.

A 2-layer, 64-unit GPT (vocab 101, FFN 128, 4 heads, max_length 32,
dropout 0) is initialized by the JAX package and its weights carried into
the port with ``functional.load_params``; the port's model is built inside
``with mx.cpu():`` (the ``Context`` scope places it). The same token
batch, made with ``np.array`` in each package, is trained two AdamW steps
the reference's way in both: ``out = net(x)`` (an ``ndarray``),
``loss.backward()``, ``trainer.step()``, ``loss.asnumpy()``; eager and
hybridized (``net.hybridize()``, ``loss.hybridize()``). Held: the
outputs are ``ndarray``s, the losses of both steps within atol 1e-5 and
every parameter after them within atol 1e-5 of the JAX package's
(float32, another summation order); the port's ndarray-driven steps
equal, bit for bit, its tensor-driven steps from the same weights.

A user block whose forward is written in ``mx.np`` (``@``, ``np.tanh``,
``np.sum``) in both packages, eager and hybridized: output and gradients
within rtol 1e-5 + atol 1e-6. ``Context`` placement: ``with mx.cpu():``,
``initialize(ctx=)``, ``reset_ctx``, ``set_data`` of an ``ndarray``.
"""
import copy

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM as JGPT

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.gluon.parameter import Parameter as TParameter
from mxnet_tpu_torch.test_utils import assert_almost_equal

torch.set_num_threads(2)

CFG = dict(vocab_size=101, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=32, dropout=0.0, embed_dropout=0.0)
BATCH = 2
TOL = dict(rtol=0, atol=1e-5)


def _pair(seed=0):
    mx.random.seed(seed)
    jnet = JGPT(**CFG)
    jnet.initialize()
    jnet(mx.np.array(onp.zeros((1, 2), dtype="int32")))
    with tmx.cpu():
        tnet = tgpt.GPTForCausalLM(**CFG)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    for net in (jnet, tnet):
        # the key projection's bias has a zero gradient in exact arithmetic;
        # Adam would turn either package's rounding noise into +-lr steps
        for name, p in net.collect_params().items():
            if "key_proj.bias" in name:
                p.grad_req = "null"
    return jnet, tnet


def _batch():
    ids = onp.random.RandomState(0).randint(0, 101, (BATCH, 33))
    return ids[:, :-1].astype("int32"), ids[:, 1:].astype("int32")


def _train(m, net, x, y, hybrid, steps=2):
    """Two steps the reference's way, from ``mx.np`` arrays; returns the
    losses and the outputs' types."""
    loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss()
    if hybrid:
        net.hybridize()
        loss_fn.hybridize()
    trainer = m.gluon.Trainer(net.collect_params(), "adamw",
                              {"learning_rate": 1e-3, "wd": 0.01})
    xs, ys = m.np.array(x), m.np.array(y)
    losses, kinds = [], set()
    for _ in range(steps):
        with m.autograd.record():
            out = net(xs)
            loss = loss_fn(out, ys)
        kinds.update((type(out).__name__, type(loss).__name__))
        loss.backward()
        trainer.step(BATCH)
        losses.append(loss.asnumpy())
    return losses, kinds


@pytest.mark.parametrize("hybrid", [False, True])
def test_gpt_trained_from_np_arrays_matches_jax(hybrid):
    jnet, tnet = _pair(0)
    x, y = _batch()
    want, _ = _train(mx, jnet, x, y, hybrid)
    with tmx.cpu():
        got, kinds = _train(tmx, tnet, x, y, hybrid)
    assert kinds == {"ndarray"}
    for g, w in zip(got, want):
        assert g.shape == (BATCH,) and g.dtype == onp.float32
        onp.testing.assert_allclose(g, w, **TOL)
    assert got[-1].mean() < got[0].mean()
    ref = jfunctional.param_arrays(jnet)
    for name, w in tfunctional.param_arrays(tnet).items():
        onp.testing.assert_allclose(w, onp.asarray(ref[name]), **TOL,
                                    err_msg=name)


@pytest.mark.parametrize("hybrid", [False, True])
def test_np_driven_steps_equal_tensor_driven_steps(hybrid):
    """The wrapper adds no arithmetic: the ndarray-driven steps and the
    tensor-driven steps from the same weights agree bit for bit."""
    _, tnet = _pair(1)
    twin = copy.deepcopy(tnet)
    x, y = _batch()
    with tmx.cpu():
        got, _ = _train(tmx, tnet, x, y, hybrid)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    if hybrid:
        twin.hybridize()
        loss_fn.hybridize()
    trainer = tmx.gluon.Trainer(twin.collect_params(), "adamw",
                                {"learning_rate": 1e-3, "wd": 0.01})
    tx, ty = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    for g in got:
        with tmx.autograd.record():
            loss = loss_fn(twin(tx), ty)
        tmx.autograd.backward(loss)
        trainer.step(BATCH)
        onp.testing.assert_array_equal(g, loss.detach().numpy())
    for (n, p), q in zip(tnet.collect_params().items(),
                         twin.collect_params().values()):
        assert torch.equal(p.data(), q.data()), n


def test_np_inputs_give_np_outputs_and_tensors_give_tensors():
    _, tnet = _pair(2)
    x, _ = _batch()
    with tmx.cpu():
        out = tnet(tmx.np.array(x))
        assert isinstance(out, tmx.np.ndarray)
        assert out.shape == (BATCH, 32, 101) and out.dtype == onp.float32
        raw = tnet(torch.from_numpy(x))
        assert type(raw) is torch.Tensor
        assert torch.equal(raw, out._data)
        assert out.ctx == tmx.cpu()


# -- a user block written in mx.np -----------------------------------------------

W = onp.random.RandomState(3).randn(4, 3).astype("float32")
X = onp.random.RandomState(4).randn(5, 4).astype("float32")


class _JBlock(mx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.w = mx.gluon.Parameter("w", shape=(4, 3))

    def forward(self, x):
        h = mx.np.tanh(x @ self.w.data())
        return mx.np.sum(h * h + 0.5 * h, axis=1)


class _TBlock(tmx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.w = TParameter((4, 3), device=None).data()

    def forward(self, x):
        h = tmx.np.tanh(x @ self.w)
        return tmx.np.sum(h * h + 0.5 * h, axis=1)


def _user_block_run(m, block, hybrid):
    block.initialize()
    if m is mx:
        block.w.set_data(mx.np.array(W))
    else:
        block.w._mx_param.set_data(tmx.np.array(W))
    if hybrid:
        block.hybridize()
    x = m.np.array(X)
    x.attach_grad()
    with m.autograd.record():
        y = block(x)
    y.backward()
    wgrad = block.w.grad() if m is mx else block.w._mx_param.grad()
    return y, x.grad, wgrad


@pytest.mark.parametrize("hybrid", [False, True])
def test_user_block_with_an_np_forward_matches_jax(hybrid):
    want = _user_block_run(mx, _JBlock(), hybrid)
    with tmx.cpu():
        block = _TBlock()
        got = _user_block_run(tmx, block, hybrid)
        assert isinstance(got[0], tmx.np.ndarray)
        if hybrid:
            assert block._cached_graph is not None
            assert block._cached_graph.captures == 1
    for g, w, what in zip(got, want, ("out", "dx", "dw")):
        assert_almost_equal(g, w.asnumpy(), rtol=1e-5, atol=1e-6,
                            names=(what, "jax"), check_dtype=True)


# -- contexts ---------------------------------------------------------------------

def test_context_scope_places_blocks_and_arrays():
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(3, in_units=4)
        assert net.weight.device == torch.device("cpu")
        a = tmx.np.ones((2, 4))
        assert a.ctx == tmx.cpu() == tmx.current_context()
        assert tmx.test_utils.default_context() == tmx.cpu()
    net.initialize(ctx=tmx.cpu())
    assert net.weight.device == torch.device("cpu")
    net.reset_ctx(tmx.cpu(0))
    net.weight._mx_param.set_data(tmx.np.ones((3, 4), ctx=tmx.cpu()))
    assert float(net.weight.detach().sum()) == 12.0
    assert tmx.resolve_device(tmx.cpu()) == torch.device("cpu")
    assert tmx.resolve_device("cpu") == torch.device("cpu")
    assert tmx.Context("cpu") == tmx.device("cpu", 0) == tmx.cpu()
    assert repr(tmx.gpu(1)) == "gpu(1)" and tmx.gpu(1).device_typeid == 2
    out = net(a)
    assert isinstance(out, tmx.np.ndarray) and out.shape == (2, 3)
    with tmx.cpu():
        with tmx.gpu(0):
            assert tmx.current_context() == tmx.gpu(0)
        assert tmx.current_context() == tmx.cpu()
