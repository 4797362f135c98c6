"""Port parity: ``HybridBlock.hybridize()``, its cache of signatures, and
``functional.split_params`` / ``functional_call``.

On the card a hybridized block's calls are CUDA graphs
(``tests/test_torch_cuda_kernels.py`` holds those); on the CPU the same
``_CachedGraph`` keeps the same cache, key and invalidation logic and runs
the forward eagerly, which is what is held here:

- the reference's own tests as oracles: ``tests/test_gluon.py:49, 64,
  133, 296`` and ``tests/test_cached_graph_threading.py`` (the bound, the
  digested static leaves, threads with and without cache flushes);
- a hybridized tiny GPT (2 layers, 64 units) and a small BERT (dropout 0)
  against the JAX package's hybridized blocks on the same weights: outputs
  and losses atol 1e-5, every gradient atol 1e-5 + rtol 1e-4 (float32,
  another summation order), and the port's eager call bit for bit;
- re-keying on shape, dtype, train mode, the AMP policy and keyword
  calls; the deferred first call; ``hybridize(False)``; ``cast`` and
  ``reset_ctx`` after a capture; ``remat=`` / ``backend=`` raising; one
  graph per outermost call;
- ``split_params`` / ``functional_call`` against the JAX package's,
  including the mutated aux state of a small ResNet (atol 1e-4, the
  resnet tests' forward tolerance).
"""
import copy
import sys
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM as JGPT
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

torch.set_num_threads(2)

OUT = dict(atol=1e-5, rtol=0)
GRAD = dict(atol=1e-5, rtol=1e-4)


def _dense_net(seed=7):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(16, activation="tanh", in_units=8, device="cpu"),
            tnn.Dense(4, in_units=16, device="cpu"))
    net.initialize(seed=seed)
    return net


def _graph(block):
    return block._cached_graph


# -- the reference's tests as oracles -----------------------------------------

def test_hybridize_equivalence():
    """``tests/test_gluon.py::test_hybridize_equivalence``."""
    net = _dense_net()
    x = torch.rand(3, 8)
    eager = net(x)
    net.hybridize()
    hybrid = net(x)
    torch.testing.assert_close(hybrid, eager, atol=1e-6, rtol=1e-5)
    hybrid2 = net(x)  # the cached signature
    torch.testing.assert_close(hybrid2, hybrid, atol=0, rtol=0)
    assert _graph(net).captures == 1 and len(_graph(net)._signatures) == 1


def test_hybridize_grad():
    """``tests/test_gluon.py::test_hybridize_grad``."""
    net = tnn.Dense(1, in_units=3, device="cpu")
    net.initialize()
    x = torch.tensor([[1.0, 2.0, 3.0]])
    with tmx.autograd.record():
        y = net(x).sum()
    tmx.autograd.backward(y)
    g_eager = net.weight.grad.clone()
    net.hybridize()
    net.zero_grad()
    with tmx.autograd.record():
        y = net(x).sum()
    tmx.autograd.backward(y)
    torch.testing.assert_close(net.weight.grad, g_eager, atol=0, rtol=1e-5)
    torch.testing.assert_close(net.weight.grad, x, atol=0, rtol=1e-5)
    assert list(_graph(net)._signatures)[0][3] is True  # recording


def test_batchnorm_hybrid_aux_update():
    """``tests/test_gluon.py::test_batchnorm_hybrid_aux_update``."""
    bn = tnn.BatchNorm(in_channels=3, device="cpu")
    bn.initialize()
    bn.hybridize()
    x = torch.rand(4, 3, 2, 2) + 1.0
    bn(x)
    rm_before = bn.running_mean.detach().clone()
    with tmx.autograd.record():
        bn(x)
    assert not torch.allclose(bn.running_mean, rm_before)


class _KwNet(tmx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.dense = tnn.Dense(4, in_units=6, device="cpu")

    def forward(self, x, scale=None, flag=True):
        out = self.dense(x)
        if scale is not None:
            out = out * scale
        return out if flag else -out


def test_hybridize_kwargs_compile():
    """``tests/test_gluon.py::test_hybridize_kwargs_compile``: keyword
    calls go through the cache, each static keyword its own signature."""
    net = _KwNet()
    net.initialize()
    x = torch.randn(2, 6)
    s = torch.tensor(2.0)
    eager = net(x, scale=s, flag=True)
    net.hybridize()
    out = net(x, scale=s, flag=True)
    assert net._cached_graph, "kwargs call did not reach the cache"
    torch.testing.assert_close(out, eager, atol=0, rtol=1e-6)
    out2 = net(x, scale=s, flag=False)
    torch.testing.assert_close(out2, -eager, atol=0, rtol=1e-6)
    out3 = net(x)
    torch.testing.assert_close(out3, net.dense(x), atol=0, rtol=1e-6)
    assert len(_graph(net)._signatures) == 3


class _ScaledDense(tmx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Dense(4, device="cpu")

    def forward(self, x, scale=1.0):
        return self.fc(x) * scale


@pytest.fixture
def max_signatures():
    yield lambda n: tmx.config.set("cached_graph.max_signatures", n)
    tmx.config.reset("cached_graph.max_signatures")


def test_signature_cache_bounded(max_signatures):
    """``tests/test_cached_graph_threading.py::test_signature_cache_
    bounded``: 20 python scalars, at most 4 signatures kept."""
    max_signatures(4)
    net = _ScaledDense()
    net.initialize()
    net.hybridize()
    x = torch.ones((2, 3))
    for i in range(20):
        y = net(x, scale=float(i))
        torch.testing.assert_close(y, net.fc(x) * float(i), atol=0,
                                   rtol=1e-5)
    cg = _graph(net)
    assert len(cg._signatures) <= 4
    assert all(e.out_spec is not None for e in cg._signatures.values())
    # the least recently used went first: the last four scalars remain
    assert [k[1][-1] for k in cg._signatures] == \
        [repr(float(i)) for i in range(16, 20)]


class _ListScaled(tmx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Dense(2, device="cpu")

    def forward(self, x, tag=""):
        return self.fc(x) * (2.0 if tag.startswith("a") else 1.0)


def test_long_static_repr_hashed():
    """``tests/test_cached_graph_threading.py::test_long_static_repr_
    hashed``."""
    net = _ListScaled()
    net.initialize()
    net.hybridize()
    x = torch.ones((2, 3))
    long_static = "a" * 300
    net(x, tag=long_static)
    y = net(x, tag=long_static)
    assert torch.isfinite(y).all()
    cg = _graph(net)
    hashed = [tok for key in cg._signatures for tok in key[1]
              if tok.startswith("H")]
    assert hashed, "digest path never exercised"
    for key in cg._signatures:
        for tok in key[1]:
            assert len(tok) <= 129


def _threaded(net, inputs, want, n_threads=12):
    """More threads than this host's workers, the interpreter switching
    threads every microsecond: every result right, every thread done."""
    errors = []

    def worker(tid):
        try:
            for _ in range(4):
                for k, v in inputs.items():
                    torch.testing.assert_close(net(v), want[k], atol=1e-6,
                                               rtol=1e-5)
        except Exception as e:  # noqa: BLE001
            errors.append((tid, e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


@pytest.mark.parametrize("cap", [512, 2])
def test_concurrent_calls(cap, max_signatures):
    """``tests/test_cached_graph_threading.py::test_concurrent_inference_
    many_shapes`` and ``::test_concurrent_with_cache_flushes`` (cap 2 of 8
    shapes forces evictions mid-flight): every result right."""
    max_signatures(cap)
    net = tnn.Dense(8, activation="relu", device="cpu")
    net.initialize()
    net.hybridize()
    inputs = {k: torch.from_numpy(onp.random.RandomState(k).rand(k, 5)
                                  .astype("float32")) for k in range(1, 9)}
    net(inputs[1])  # deferred shapes finish before the threads start
    ref = tnn.Dense(8, activation="relu", device="cpu")
    ref.initialize()
    ref(inputs[1])
    tfunctional.load_params(ref, tfunctional.param_arrays(net))
    want = {k: ref(v) for k, v in inputs.items()}
    _threaded(net, inputs, want)
    assert len(_graph(net)._signatures) <= cap


# -- the small GPT and BERT against the JAX package's hybridized blocks -------

GPT_CFG = dict(vocab_size=101, units=64, hidden_size=128, num_layers=2,
               num_heads=4, max_length=32, dropout=0.0, embed_dropout=0.0)


def _gpt_pair(seed=0):
    mx.random.seed(seed)
    jnet = JGPT(**GPT_CFG)
    jnet.initialize()
    jnet(mx.np.array(onp.zeros((1, 2), dtype="int32")))
    tnet = tgpt.GPTForCausalLM(device="cpu", **GPT_CFG)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    return jnet, tnet


def _assert_grads(tparams, jparams):
    assert list(tparams) == list(jparams)
    for name, p in tparams.items():
        if p.grad_req == "null":
            continue
        torch.testing.assert_close(
            p.grad().numpy(), jparams[name].grad().asnumpy(), **GRAD,
            msg=name)


def test_hybridized_gpt_matches_jax_hybridized():
    jnet, tnet = _gpt_pair(0)
    eager = copy.deepcopy(tnet)
    rs = onp.random.RandomState(0)
    ids = rs.randint(0, 101, (2, 33))
    x, y = ids[:, :-1].astype("int32"), ids[:, 1:].astype("int32")
    jnet.hybridize()
    tnet.hybridize()
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    jloss_fn.hybridize()
    tloss_fn.hybridize()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    torch.testing.assert_close(tnet(tx).numpy(),
                               jnet(mx.np.array(x)).asnumpy(), **OUT)
    for _ in range(2):  # the second call takes the cached signature
        with mx.autograd.record():
            jloss = jloss_fn(jnet(mx.np.array(x)), mx.np.array(y))
        jloss.backward()
        with tmx.autograd.record():
            tloss = tloss_fn(tnet(tx), ty)
        tmx.autograd.backward(tloss)
        torch.testing.assert_close(tloss.detach().numpy(), jloss.asnumpy(),
                                   **OUT)
        _assert_grads(tnet.collect_params(), jnet.collect_params())
    assert _graph(tnet).captures == 2  # the predict call, the recorded one
    assert _graph(tloss_fn).captures == 1
    with tmx.autograd.record():
        eloss = tloss_fn(eager(tx), ty)
    tmx.autograd.backward(eloss)
    assert torch.equal(eloss, tloss)
    for (n, p), q in zip(tnet.collect_params().items(),
                         eager.collect_params().values()):
        assert torch.equal(p.grad(), q.grad()), n


BERT_CFG = dict(vocab_size=1000, units=128, hidden_size=512, num_layers=2,
                num_heads=4, max_length=64, dropout=0.0, embed_dropout=0.0)


def test_hybridized_bert_matches_jax_hybridized():
    rs = onp.random.RandomState(3)
    ids = rs.randint(0, 1000, (2, 32)).astype("int32")
    types = (onp.arange(32)[None, :] >= onp.array([[12], [9]])) \
        .astype("int32")
    valid = onp.array([32, 21], dtype="int32")
    labels = rs.randint(0, 1000, (2, 32)).astype("int32")
    weight = (rs.rand(2, 32) < 0.3).astype("float32")
    nsp = onp.array([0, 1], dtype="int32")
    mx.random.seed(3)
    jnet = jbert.BERTForPretraining(**BERT_CFG)
    jnet.initialize()
    jnet(mx.np.array(ids), mx.np.array(types), mx.np.array(valid))
    tnet = tbert.BERTForPretraining(device="cpu", **BERT_CFG)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    jnet.hybridize()
    tnet.hybridize()
    jl = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tl = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    jargs = [mx.np.array(a) for a in (ids, types, valid)]
    targs = [torch.from_numpy(a) for a in (ids, types, valid)]
    for _ in range(2):
        with mx.autograd.record():
            jmlm, jnsp = jnet(*jargs)
            jloss = jl(jmlm, mx.np.array(labels), mx.np.array(weight)) \
                + jl(jnsp, mx.np.array(nsp))
        jloss.backward()
        with tmx.autograd.record():
            tmlm, tnsp = tnet(*targs)
            tloss = tl(tmlm, torch.from_numpy(labels),
                       torch.from_numpy(weight)) \
                + tl(tnsp, torch.from_numpy(nsp))
        tmx.autograd.backward(tloss)
        torch.testing.assert_close(tmlm.detach().numpy(), jmlm.asnumpy(),
                                   **OUT)
        torch.testing.assert_close(tnsp.detach().numpy(), jnsp.asnumpy(),
                                   **OUT)
        torch.testing.assert_close(tloss.detach().numpy(), jloss.asnumpy(),
                                   **OUT)
        _assert_grads(tnet.collect_params(), jnet.collect_params())
    assert _graph(tnet).captures == 1


# -- the key ------------------------------------------------------------------

def test_rekeying():
    """A new signature for a new shape, dtype, keyword call, train mode,
    recording and AMP policy; a repeat of each reuses its entry."""
    net = _dense_net()
    net.hybridize()
    x = torch.rand(3, 8)
    calls = [lambda: net(x), lambda: net(torch.rand(5, 8)),
             lambda: net(x.double())]
    net(x)
    for call in calls * 2:
        call()
    g = _graph(net)
    assert g.captures == 3 and len(g._signatures) == 3
    with tmx.autograd.train_mode():
        net(x)
        net(x)
    assert g.captures == 4
    assert [k[4] for k in g._signatures] == [False] * 3 + [True]
    with tmx.autograd.record():
        net(x)
    assert g.captures == 5 and list(g._signatures)[-1][3:5] == (True, True)
    tmx.amp.init("bfloat16")
    try:
        out = net(x)
        net(x)
    finally:
        tmx.amp._deactivate()
    assert out.dtype == torch.bfloat16
    assert g.captures == 6
    keys = list(g._signatures)
    assert keys[-1][5] == (True, "torch.bfloat16")
    assert net(x).dtype == torch.float32 and g.captures == 6
    kw = _KwNet()
    kw.initialize()
    kw.hybridize()
    kw(x[:, :6], scale=torch.tensor(3.0))
    kw(x[:, :6], torch.tensor(3.0))  # positional: another tree
    assert _graph(kw).captures == 2


def test_route_knobs_are_part_of_the_key():
    net = _dense_net()
    net.hybridize()
    x = torch.rand(3, 8)
    net(x)
    tmx.config.set("fused_conv_bn", "off")
    try:
        net(x)
    finally:
        tmx.config.reset("fused_conv_bn")
    assert _graph(net).captures == 2


def test_deferred_first_call_runs_eagerly():
    net = tnn.HybridSequential()
    net.add(tnn.Dense(8, device="cpu"), tnn.Dense(2, device="cpu"))
    net.initialize()
    net.hybridize()
    x = torch.rand(2, 5)
    first = net(x)
    assert not _graph(net)._signatures
    assert net[0].weight.shape == (8, 5)
    torch.testing.assert_close(net(x), first, atol=0, rtol=0)
    assert _graph(net).captures == 1


UNINIT = {
    "dense": (lambda pkg, **kw: pkg.Dense(2, in_units=3, **kw),
              lambda: onp.ones((1, 3), "float32")),
    "embedding": (lambda pkg, **kw: pkg.Embedding(5, 3, **kw),
                  lambda: onp.ones((1, 3), "int32")),
    "layernorm": (lambda pkg, **kw: pkg.LayerNorm(in_channels=3, **kw),
                  lambda: onp.ones((1, 3), "float32")),
    "batchnorm": (lambda pkg, **kw: pkg.BatchNorm(in_channels=3, **kw),
                  lambda: onp.ones((2, 3), "float32")),
}


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("layer", sorted(UNINIT))
def test_uninitialized_parameters_raise_like_jax(layer, hybrid):
    """Fault 19 (ROADMAP.md Queue 3): a layer whose parameters were never
    initialized raised in the reference (``Parameter.data()``) and
    computed with uninitialized memory in the port. Both raise now, eager
    and hybridized; after ``initialize()`` both run."""
    make, data = UNINIT[layer]
    jnet = make(mx.gluon.nn)
    tnet = make(tnn, device="cpu")
    if hybrid:
        jnet.hybridize()
        tnet.hybridize()
    with pytest.raises(mx.base.MXNetError, match="not initialized"):
        jnet(mx.np.array(data()))
    with pytest.raises(MXNetError, match="not initialized"):
        tnet(torch.from_numpy(data()))
    tnet.initialize()
    assert torch.isfinite(tnet(torch.from_numpy(data()))).all()


def test_hybridize_false_and_recursion():
    net = _dense_net()
    net.hybridize()
    assert all(b._active for b in (net, net[0], net[1]))
    x = torch.rand(3, 8)
    net(x)
    net.hybridize(False, clear=False)
    assert not any(b._active for b in (net, net[0], net[1]))
    net(x)
    net(torch.rand(4, 8))
    assert _graph(net).captures == 1  # plain calls leave the cache alone
    net.hybridize(True, clear=False)
    net(x)
    assert _graph(net).captures == 1
    net.hybridize()  # clear=True drops the cache
    assert net._cached_graph is None


def test_one_graph_per_outermost_call():
    net = _dense_net()
    net.hybridize()
    net(torch.rand(3, 8))
    assert net._cached_graph and net[0]._cached_graph is None
    net[0](torch.rand(3, 8))  # called alone, the child caches its own
    assert net[0]._cached_graph


def test_cast_and_reset_ctx_after_capture():
    """A parameter's new storage drops the entry, which is made again; an
    in-place write keeps it and the next call sees the new values."""
    net = _dense_net()
    net.hybridize()
    x = torch.rand(3, 8)
    net(x)
    g = _graph(net)
    net.cast("bfloat16")
    out = net(x.to(torch.bfloat16))
    assert g.captures == 2
    net.cast("float32")
    torch.testing.assert_close(net(x), net.forward(x), atol=0, rtol=0)
    assert g.captures == 3  # the fp32 entry was stale
    net.reset_ctx("cpu")
    net(x)
    assert g.captures == 4
    with torch.no_grad():
        net[0].weight.mul_(2.0)
    net[1].bias.data  # noqa: B018
    net[1].bias._mx_param.set_data(torch.ones(4))
    torch.testing.assert_close(net(x), net.forward(x), atol=0, rtol=0)
    assert g.captures == 4
    assert out.dtype == torch.bfloat16


def test_share_parameters_clears_the_cache():
    a, b = _dense_net(1), _dense_net(2)
    b.hybridize()
    x = torch.rand(3, 8)
    b(x)
    b.share_parameters(a.collect_params())
    assert b._cached_graph is None
    torch.testing.assert_close(b(x), a(x), atol=0, rtol=0)


def test_remat_and_backend_raise(monkeypatch):
    # remat is ported: every policy checkpoints the forward once and gives
    # the un-remat outputs and gradients bit for bit (the recompute is the
    # same arithmetic); a bad policy raises at hybridize time, as in the
    # reference
    import torch.utils.checkpoint as ckpt
    calls = []
    real = ckpt.checkpoint

    def counted(*a, **k):
        calls.append(k.get("context_fn") is not None)
        return real(*a, **k)

    monkeypatch.setattr(ckpt, "checkpoint", counted)
    x = torch.rand(3, 8)
    ref = _dense_net()
    with tmx.autograd.record():
        want = ref(x)
    want.sum().backward()
    for remat in (True, "dots", "dots_with_no_batch_dims",
                  lambda ctx, op, *a, **k: False):
        net = _dense_net()
        net.hybridize(remat=remat)
        assert net._flags["remat"] is remat and not net[0]._flags
        with tmx.autograd.record():
            got = net(x)
        got.sum().backward()
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        for p, q in zip(net.collect_params().values(),
                        ref.collect_params().values()):
            torch.testing.assert_close(p.grad(), q.grad(), atol=0, rtol=0)
        # one checkpoint of the whole block (it has no layer<N> family);
        # True recomputes everything, the others select what to keep
        assert calls == [remat is not True], (remat, calls)
        calls.clear()
    with pytest.raises(MXNetError, match="unknown remat policy"):
        _dense_net().hybridize(remat="not_a_policy")
    net = _dense_net()
    with pytest.raises(MXNetError, match="backend.*ROADMAP"):
        net.hybridize(backend="MKLDNN")
    with pytest.raises(MXNetError, match="backend"):
        net.optimize_for(torch.rand(3, 8), backend="MKLDNN")
    net.hybridize(remat=False, static_alloc=True, static_shape=True)
    assert net._active and net[0]._active
    x = torch.rand(3, 8)
    torch.testing.assert_close(net.optimize_for(x), net.forward(x), atol=0,
                               rtol=0)
    assert net._active and _graph(net).captures == 1


def test_deepcopy_drops_the_cache():
    net = _dense_net()
    net.hybridize()
    x = torch.rand(3, 8)
    net(x)
    other = copy.deepcopy(net)
    assert other._active and other._cached_graph is None
    torch.testing.assert_close(other(x), net(x), atol=0, rtol=0)
    assert other[0].weight is not net[0].weight


# -- split_params / functional_call -------------------------------------------

def _resnet_pair():
    x = onp.random.RandomState(0).uniform(size=(4, 3, 16, 16)) \
        .astype("float32")
    mx.random.seed(0)
    jnet = jres.ResNetV1(jres.BasicBlockV1, [1, 1, 1, 1],
                         [16, 32, 64, 128, 256], classes=10, thumbnail=True)
    jnet.initialize()
    jnet(mx.np.array(x))
    tnet = tres.ResNetV1(tres.BasicBlockV1, [1, 1, 1, 1],
                         [16, 32, 64, 128, 256], classes=10, thumbnail=True,
                         device="cpu")
    tnet.initialize()
    tnet(torch.from_numpy(x))
    tfunctional.load_params(tnet, {n: onp.asarray(v) for n, v in
                                   jfunctional.param_arrays(jnet).items()})
    return jnet, tnet, x


def test_split_params_and_functional_call_match_jax():
    """A small ResNetV1 in training mode through both packages'
    ``functional_call``: outputs and the mutated running statistics
    (atol 1e-4); the block's own parameters and the given tensors stay as
    they were."""
    jnet, tnet, x = _resnet_pair()
    jtr, jaux = jfunctional.split_params(jnet)
    ttr, taux = tfunctional.split_params(tnet)
    assert sorted(jtr) == sorted(ttr) and sorted(jaux) == sorted(taux)
    assert all("running" in n for n in taux)
    before = tfunctional.param_arrays(tnet)
    jout, jmut = jfunctional.functional_call(jnet, {**jtr, **jaux},
                                             mx.np.array(x), train=True)
    tout, tmut = tfunctional.functional_call(tnet, {**ttr, **taux},
                                             torch.from_numpy(x),
                                             train=True)
    torch.testing.assert_close(tout.detach().numpy(), onp.asarray(jout),
                               atol=1e-4, rtol=1e-4)
    assert sorted(tmut) == sorted(jmut) and tmut
    for n in tmut:
        torch.testing.assert_close(tmut[n].numpy(), onp.asarray(jmut[n]),
                                   atol=1e-4, rtol=1e-4, msg=n)
    after = tfunctional.param_arrays(tnet)
    for n in before:
        onp.testing.assert_array_equal(after[n], before[n], err_msg=n)
    # inference: nothing mutated, the eager forward's output
    tout, tmut = tfunctional.functional_call(tnet, {**ttr, **taux},
                                             torch.from_numpy(x))
    assert tmut == {}
    torch.testing.assert_close(tout, tnet(torch.from_numpy(x)), atol=0,
                               rtol=0)


def test_functional_call_on_gpt_matches_jax_and_differentiates():
    jnet, tnet = _gpt_pair(1)
    ids = onp.random.RandomState(1).randint(0, 101, (2, 16)) \
        .astype("int32")
    jtr, _ = jfunctional.split_params(jnet)
    ttr, _ = tfunctional.split_params(tnet)
    jout, _ = jfunctional.functional_call(jnet, jtr, mx.np.array(ids))
    new = {n: (t * 1.5).detach() for n, t in ttr.items()}
    tout, tmut = tfunctional.functional_call(tnet, dict(ttr),
                                             torch.from_numpy(ids))
    torch.testing.assert_close(tout.detach().numpy(), onp.asarray(jout),
                               **OUT)
    assert tmut == {}
    # other values in, gradients out with respect to them
    name = "backbone.decoder.layer0.ffn.ffn_1.weight"
    new[name].requires_grad_(True)
    out, _ = tfunctional.functional_call(tnet, new, torch.from_numpy(ids))
    (g,) = torch.autograd.grad(out.sum(), [new[name]])
    ref = copy.deepcopy(tnet)
    tfunctional.load_params(ref, {n: t.numpy() for n, t in new.items()
                                  if not t.requires_grad} |
                            {name: new[name].detach().numpy()})
    with tmx.autograd.record():
        refout = ref(torch.from_numpy(ids))
    tmx.autograd.backward(refout.sum())
    torch.testing.assert_close(out, refout, atol=0, rtol=0)
    torch.testing.assert_close(g, ref.collect_params()[name].grad(), atol=0,
                               rtol=0)
    # the block's own weights are untouched
    torch.testing.assert_close(tnet.collect_params()[name].data(),
                               ttr[name], atol=0, rtol=0)


def test_functional_call_generator_and_hybridized_blocks():
    """``generator`` is the dropout default for the call (reproducible,
    the device's default generator left alone); a hybridized block runs
    its plain forward inside ``functional_call``."""
    net = tnn.HybridSequential()
    net.add(tnn.Dense(32, in_units=8, device="cpu"), tnn.Dropout(0.5))
    net.initialize(seed=0)
    net.hybridize()
    x = torch.rand(4, 8)
    params, _ = tfunctional.split_params(net)
    default = tmx.random.default_generator("cpu")
    state = default.get_state()
    outs = [tfunctional.functional_call(
        net, params, x, train=True,
        generator=tmx.random.generator(5, "cpu"))[0] for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert (outs[0] == 0).any()
    assert torch.equal(default.get_state(), state)
    assert net._cached_graph is None
