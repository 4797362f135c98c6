"""Port parity: training a tiny GPT, JAX package -> PyTorch port.

A tiny ``mxnet_tpu`` GPT (vocab 101, units 64, FFN 128, 2 layers, 4
heads, max_length 32, dropout 0) is initialized by the JAX package and its
weights carried into the port with ``functional.load_params``. The same
numpy batch (2 x 32 tokens from a seed) goes through both packages'
``autograd.record()`` -> ``backward`` -> ``gluon.Trainer.step``. Also held
against the JAX package: the optimizers' update rules (with wd,
clip_gradient, rescale_grad and lr_mult), an lr scheduler,
``sparse_softmax_xent`` (with clipped out-of-range labels) and the
``grad_req`` write/add rules. Tolerances (float32, another summation
order): losses atol 1e-5; gradients atol 1e-5 + rtol 1e-4; weights after
three steps atol 1e-5; single update rules atol 1e-6.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM as JGPT
from mxnet_tpu.ops.xent import sparse_softmax_xent as jxent

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.ops import flash_attention as tflash
from mxnet_tpu_torch.ops.xent import sparse_softmax_xent as txent

torch.set_num_threads(2)

CFG = dict(vocab_size=101, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=32, dropout=0.0, embed_dropout=0.0)
BATCH = 2


def _batch(seed=0):
    ids = onp.random.RandomState(seed).randint(0, 101, (BATCH, 33))
    return ids[:, :-1].astype("int32"), ids[:, 1:].astype("int32")


def _pair(seed=0):
    """(JAX GPT, port GPT on the CPU with the same weights)."""
    mx.random.seed(seed)
    jnet = JGPT(**CFG)
    jnet.initialize()
    jnet(mx.np.array(onp.zeros((1, 2), dtype="int32")))  # materialize
    tnet = tgpt.GPTForCausalLM(device="cpu", **CFG)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    return jnet, tnet


def _jax_step(jnet, loss_fn, x, y):
    with mx.autograd.record():
        loss = loss_fn(jnet(mx.np.array(x)), mx.np.array(y))
    loss.backward()
    return loss.asnumpy()


def _port_step(tnet, loss_fn, x, y):
    with tmx.autograd.record():
        loss = loss_fn(tnet(torch.from_numpy(x)), torch.from_numpy(y))
    tmx.autograd.backward(loss)
    return loss.detach().numpy()


def _null_key_bias(params):
    """The key projection's bias has a zero gradient in exact arithmetic
    (softmax is shift invariant): Adam turns the summation noise of either
    package into +-lr steps, so the comparisons leave it out."""
    for name, p in params.items():
        if "key_proj.bias" in name:
            p.grad_req = "null"


# -- one backward ------------------------------------------------------------

def test_loss_and_every_gradient_match_jax():
    jnet, tnet = _pair(0)
    x, y = _batch(0)
    ref = _jax_step(jnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), x, y)
    out = _port_step(tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), x, y)
    assert out.shape == (BATCH,)
    onp.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    assert list(tparams) == list(jparams)
    for name, p in tparams.items():
        g = p.grad().numpy()
        assert onp.isfinite(g).all(), name
        onp.testing.assert_allclose(g, jparams[name].grad().asnumpy(),
                                    atol=1e-5, rtol=1e-4, err_msg=name)


# -- Trainer steps -----------------------------------------------------------

TRAIN_CASES = {
    "adam": {"learning_rate": 1e-3, "wd": 0.01, "clip_gradient": 0.05},
    "adamw": {"learning_rate": 1e-3, "wd": 0.01},
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
}


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_trainer_steps_match_jax(name):
    """Three record/backward/step cycles with grad_req "write" (a stale
    gradient would be accumulated into the next step) and an lr_mult: the
    losses of every step and the weights after the last agree."""
    jnet, tnet = _pair(1)
    x, y = _batch(1)
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    for params in (jparams, tparams):
        _null_key_bias(params)
        params["backbone.final_ln.gamma"].lr_mult = 0.5
        params["backbone.decoder.layer1.ffn.ffn_1.weight"].wd_mult = 2.0
    jtr = mx.gluon.Trainer(jparams, name, dict(TRAIN_CASES[name]))
    ttr = tmx.gluon.Trainer(tparams, name, dict(TRAIN_CASES[name]))
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(3):
        ref = _jax_step(jnet, jloss_fn, x, y)
        jtr.step(BATCH)
        out = _port_step(tnet, tloss_fn, x, y)
        ttr.step(BATCH)
        onp.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
        losses.append(out.mean())
    assert losses[-1] < losses[0]
    ref_w = jfunctional.param_arrays(jnet)
    for wname, w in tfunctional.param_arrays(tnet).items():
        onp.testing.assert_allclose(w, onp.asarray(ref_w[wname]), atol=1e-5,
                                    rtol=0, err_msg=wname)


def test_optimizer_state_carries_across_by_name():
    """One JAX step, then weights, Adam moments and update counts carried
    into the port by name: the next two steps agree."""
    jnet, tnet = _pair(2)
    x, y = _batch(2)
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    for params in (jparams, tparams):
        _null_key_bias(params)
    hyper = {"learning_rate": 1e-3, "wd": 0.01}
    jtr = mx.gluon.Trainer(jparams, "adam", dict(hyper))
    ttr = tmx.gluon.Trainer(tparams, "adam", dict(hyper))
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    _jax_step(jnet, jloss_fn, x, y)
    jtr.step(BATCH)
    names = list(jparams)
    states = {names[i]: tuple(a.asnumpy() for a in s)
              for i, s in jtr._updaters[0].states.items()}
    counts = {names[i]: c for i, c in
              jtr._optimizer._index_update_count.items()}
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    ttr.load_states_by_name(states, counts)
    for _ in range(2):
        ref = _jax_step(jnet, jloss_fn, x, y)
        jtr.step(BATCH)
        out = _port_step(tnet, tloss_fn, x, y)
        ttr.step(BATCH)
        onp.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    ref_w = jfunctional.param_arrays(jnet)
    for wname, w in tfunctional.param_arrays(tnet).items():
        onp.testing.assert_allclose(w, onp.asarray(ref_w[wname]), atol=1e-5,
                                    rtol=0, err_msg=wname)


def test_trainer_save_load_states_round_trip(tmp_path):
    _, tnet = _pair(3)
    x, y = _batch(3)
    tr = tmx.gluon.Trainer(tnet.collect_params(), "adamw",
                           {"learning_rate": 1e-3})
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    _port_step(tnet, loss_fn, x, y)
    tr.step(BATCH)
    tr.save_states(str(tmp_path / "states"))
    other = tmx.gluon.Trainer(tnet.collect_params(), "adamw",
                              {"learning_rate": 5.0})
    other.load_states(str(tmp_path / "states"))
    assert other.learning_rate == pytest.approx(1e-3)
    assert other.optimizer._index_update_count == \
        tr.optimizer._index_update_count
    for i, (m, v) in tr._updater.states.items():
        om, ov = other._updater.states[i]
        # loaded once as tensors like the weights, not left as numpy
        assert all(isinstance(t, torch.Tensor) and t.dtype == m.dtype
                   and t.device == m.device for t in (om, ov))
        assert om.data_ptr() != m.data_ptr()
        torch.testing.assert_close(om, m, atol=0, rtol=0)
        torch.testing.assert_close(ov, v, atol=0, rtol=0)
    # the loaded trainer steps on, updating its tensors in place
    om = other._updater.states[0][0]
    _port_step(tnet, loss_fn, x, y)
    other.step(BATCH)
    assert other._updater.states[0][0] is om
    assert set(other.optimizer._index_update_count.values()) == {2}


@pytest.mark.parametrize("kwargs", [{"kvstore": "dist_sync"},
                                    {"kvstore": "dist_async"},
                                    {"kvstore": "horovod"},
                                    {"kvstore": 3}])
def test_trainer_outside_slice_raises(kwargs):
    _, tnet = _pair(0)
    with pytest.raises(MXNetError):
        tmx.gluon.Trainer(tnet.collect_params(), "sgd", **kwargs)


def test_trainer_accepts_single_card_kvstores():
    _, tnet = _pair(0)
    for kv in (None, "device", "local", "nccl"):
        tr = tmx.gluon.Trainer(tnet.collect_params(), "sgd",
                               {"learning_rate": 0.5}, kvstore=kv)
        assert tr.learning_rate == 0.5
        tr.set_learning_rate(0.25)
        assert tr.learning_rate == 0.25


# -- update rules and schedulers ----------------------------------------------

RULES = {
    "sgd": {"learning_rate": 0.1, "wd": 0.01},
    "sgd_momentum": {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
                     "clip_gradient": 0.3, "rescale_grad": 0.5},
    "adam": {"learning_rate": 0.01, "wd": 0.01, "clip_gradient": 0.5,
             "rescale_grad": 0.25},
    "adamw": {"learning_rate": 0.01, "wd": 0.1, "rescale_grad": 2.0},
    # a clip_gradient of 0 or below means no clipping, as in the reference
    "sgd_momentum_clip0": {"learning_rate": 0.1, "momentum": 0.9,
                           "clip_gradient": 0.0},
    "sgd_momentum_clipneg": {"learning_rate": 0.1, "momentum": 0.9,
                             "clip_gradient": -1.0},
    "adam_clip0": {"learning_rate": 0.1, "clip_gradient": 0.0},
    "adam_clipneg": {"learning_rate": 0.1, "clip_gradient": -1.0},
    "adamw_clip0": {"learning_rate": 0.1, "clip_gradient": 0.0},
    "adamw_clipneg": {"learning_rate": 0.1, "clip_gradient": -1.0},
}


@pytest.mark.parametrize("case", sorted(RULES))
def test_update_rules_match_jax(case):
    """Three updates of two weights (one with lr_mult 0.5 and wd_mult 3) by
    the optimizers directly."""
    name = case.split("_")[0]
    rs = onp.random.RandomState(len(case))
    ws = [rs.randn(5, 3).astype("float32") for _ in range(2)]
    gs = [[rs.randn(5, 3).astype("float32") for _ in range(2)]
          for _ in range(3)]
    jo = jopt.create(name, **RULES[case])
    to = topt.create(name, **RULES[case])
    for o in (jo, to):
        o.set_lr_mult({1: 0.5})
        o.set_wd_mult({1: 3.0})
    jw = [mx.np.array(w) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    js = [jo.create_state(i, w) for i, w in enumerate(jw)]
    ts = [to.create_state(i, w) for i, w in enumerate(tw)]
    for step in gs:
        for i in range(2):
            jo.update(i, jw[i], mx.np.array(step[i]), js[i])
            to.update(i, tw[i], torch.from_numpy(step[i]), ts[i])
    for j, t in zip(jw, tw):
        onp.testing.assert_allclose(t.numpy(), j.asnumpy(), atol=1e-6,
                                    rtol=0)


@pytest.mark.parametrize("clip", [None, 0.0, -1.0, float("nan"), 1.0])
@pytest.mark.parametrize("name,kw", [("sgd", {"momentum": 0.9}),
                                     ("adam", {}), ("adamw", {})])
def test_clip_gradient_at_or_below_zero_does_not_clip_like_jax(name, kw,
                                                               clip):
    """One update of w = [0.5, -0.25, 1.0] by g = [0.3, -2.0, 0.01] at lr
    0.1: the reference clips only where ``clip == clip and clip > 0``, so
    0, -1 and NaN leave g as it is (clip 1.0 clips the -2.0)."""
    w = onp.array([0.5, -0.25, 1.0], "float32")
    g = onp.array([0.3, -2.0, 0.01], "float32")
    jo = jopt.create(name, learning_rate=0.1, clip_gradient=clip, **kw)
    to = topt.create(name, learning_rate=0.1, clip_gradient=clip, **kw)
    jw, tw = mx.np.array(w), torch.from_numpy(w.copy())
    jo.update(0, jw, mx.np.array(g), jo.create_state(0, jw))
    to.update(0, tw, torch.from_numpy(g.copy()), to.create_state(0, tw))
    onp.testing.assert_allclose(tw.numpy(), jw.asnumpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["int64", "float32"])
def test_embedding_out_of_range_ids_match_jax(dtype):
    """``npx.embedding`` on weight ``arange(12).reshape(3, 4)`` with ids
    -4, -3, -1, 0, 2 and 3: ids in [-V, 0) wrap, the others out of range
    give NaN rows, as the reference's ``jnp.take``; values exactly, NaN
    positions equal, and the weight gradient (which reaches only valid
    rows) exactly."""
    w = onp.arange(12, dtype="float32").reshape(3, 4)
    ids = onp.array([[-4, -3, -1], [0, 2, 3]], dtype)
    ct = onp.random.RandomState(14).randn(2, 3, 4).astype("float32")
    jw = mx.np.array(w)
    jw.attach_grad()
    with mx.autograd.record():
        jout = mx.npx.embedding(mx.np.array(ids), jw)
    jout.backward(mx.np.array(ct))
    tw = torch.from_numpy(w.copy()).requires_grad_()
    tout = tmx.npx.embedding(torch.from_numpy(ids), tw)
    tout.backward(torch.from_numpy(ct))
    want, got = jout.asnumpy(), tout.detach().numpy()
    assert onp.array_equal(onp.isnan(got), onp.isnan(want))
    assert onp.isnan(want).any() and not onp.isnan(want).all()
    onp.testing.assert_array_equal(got, want)
    onp.testing.assert_array_equal(tw.grad.numpy(), jw.grad.asnumpy())


def test_create_unknown_optimizer_raises():
    with pytest.raises(MXNetError):
        topt.create("no_such_optimizer")
    # multi_precision is ported (tests/test_torch_amp.py holds its updates)
    assert topt.create("adam", multi_precision=True).multi_precision


@pytest.mark.parametrize("sched", ["factor", "multifactor", "poly",
                                   "cosine"])
def test_lr_scheduler_matches_jax(sched):
    def make(mod):
        return {
            "factor": lambda: mod.FactorScheduler(step=2, factor=0.5,
                                                  base_lr=0.1),
            "multifactor": lambda: mod.MultiFactorScheduler(
                step=[2, 5], factor=0.1, base_lr=0.1),
            "poly": lambda: mod.PolyScheduler(
                max_update=8, base_lr=0.1, pwr=2, warmup_steps=2),
            "cosine": lambda: mod.CosineScheduler(
                max_update=8, base_lr=0.1, final_lr=0.01, warmup_steps=3,
                warmup_mode="constant"),
        }[sched]()
    jo = jopt.SGD(learning_rate=0.1, lr_scheduler=make(jsched))
    to = topt.SGD(learning_rate=0.1, lr_scheduler=make(tsched))
    jw, tw = mx.np.array(onp.ones(3, "float32")), torch.ones(3)
    for _ in range(10):
        jo.update(0, jw, mx.np.array(onp.ones(3, "float32")), None)
        to.update(0, tw, torch.ones(3), None)
        assert to.learning_rate == pytest.approx(jo.learning_rate)
    onp.testing.assert_allclose(tw.numpy(), jw.asnumpy(), atol=1e-6)


# -- cross-entropy -----------------------------------------------------------

@pytest.mark.parametrize("axis", [-1, 1])
def test_sparse_softmax_xent_matches_jax(axis):
    rs = onp.random.RandomState(4)
    logits = (3 * rs.randn(3, 11, 5)).astype("float32")
    if axis == -1:
        logits = logits.transpose(0, 2, 1).copy()  # (3, 5, 11)
    labels = rs.randint(0, 11, (3, 5)).astype("int32")
    labels[0, :3] = [-2, 11, 40]  # clip to the nearest class
    g = rs.rand(3, 5).astype("float32")
    ref, vjp = jax.vjp(lambda x: jxent(x, jnp.asarray(labels), axis),
                       jnp.asarray(logits))
    ref_dx = vjp(jnp.asarray(g))[0]
    x = torch.tensor(logits, requires_grad=True)
    loss = txent(x, torch.from_numpy(labels), axis)
    assert loss.dtype == torch.float32 and loss.shape == (3, 5)
    loss.backward(torch.from_numpy(g))
    onp.testing.assert_allclose(loss.detach().numpy(), onp.asarray(ref),
                                atol=1e-5, rtol=0)
    onp.testing.assert_allclose(x.grad.numpy(), onp.asarray(ref_dx),
                                atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["sparse", "dense", "from_logits"])
def test_softmax_ce_loss_matches_jax(kind):
    rs = onp.random.RandomState(6)
    pred = rs.randn(4, 7).astype("float32")
    label = rs.randint(0, 7, (4,)).astype("int32")
    weight = rs.rand(4).astype("float32")
    kw = {}
    if kind == "dense":
        label = onp.eye(7, dtype="float32")[label]
        kw["sparse_label"] = False
    elif kind == "from_logits":
        pred = onp.log(onp.exp(pred) / onp.exp(pred).sum(-1, keepdims=True))
        kw["from_logits"] = True
    ref = mx.gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        mx.np.array(pred), mx.np.array(label),
        mx.np.array(weight)).asnumpy()
    out = tmx.gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        torch.from_numpy(pred), torch.from_numpy(label),
        torch.from_numpy(weight))
    onp.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


# -- grad_req, autograd scopes and dropout -----------------------------------

@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_and_add_match_jax(req):
    """Two backwards without a step: "write" keeps the last gradient, "add"
    their sum (as the JAX package); zero_grad clears "add"."""
    jnet, tnet = _pair(5)
    x, y = _batch(5)
    jnet.setattr("grad_req", req)
    tnet.setattr("grad_req", req)
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    first = None
    for _ in range(2):
        _jax_step(jnet, jloss_fn, x, y)
        _port_step(tnet, tloss_fn, x, y)
        if first is None:
            first = {n: p.grad().clone()
                     for n, p in tnet.collect_params().items()}
    jparams = jnet.collect_params()
    for name, p in tnet.collect_params().items():
        factor = 2.0 if req == "add" else 1.0
        torch.testing.assert_close(p.grad(), factor * first[name],
                                   atol=1e-6, rtol=1e-5, msg=name)
        onp.testing.assert_allclose(p.grad().numpy(),
                                    jparams[name].grad().asnumpy(),
                                    atol=1e-5, rtol=1e-4, err_msg=name)
    tnet.zero_grad()
    assert all(torch.count_nonzero(p.grad()) == 0
               for p in tnet.collect_params().values())


def test_grad_req_null_freezes_a_parameter():
    _, tnet = _pair(6)
    x, y = _batch(6)
    params = tnet.collect_params()
    frozen = params["backbone.final_ln.beta"]
    frozen.grad_req = "null"
    assert not frozen.data().requires_grad
    before = frozen.data().clone()
    tr = tmx.gluon.Trainer(params, "sgd", {"learning_rate": 0.5})
    _port_step(tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), x, y)
    tr.step(BATCH)
    assert frozen.data().grad is None and torch.equal(frozen.data(), before)
    with pytest.raises(MXNetError):
        frozen.grad()
    with pytest.raises(MXNetError):
        frozen.grad_req = "sometimes"


def test_autograd_scopes_and_flags():
    A = tmx.autograd
    assert not A.is_recording() and not A.is_training()
    with A.record():
        assert A.is_recording() and A.is_training()
        assert torch.is_grad_enabled()
        with A.pause():
            assert not A.is_recording() and not A.is_training()
            assert not torch.is_grad_enabled()
        with A.predict_mode():
            assert A.is_recording() and not A.is_training()
    with A.record(train_mode=False):
        assert A.is_recording() and not A.is_training()
    with A.train_mode():
        assert A.is_training() and not A.is_recording()
    assert not A.is_recording() and not A.is_training()


def test_autograd_backward_and_grad_semantics():
    A = tmx.autograd
    _, tnet = _pair(7)
    x, y = _batch(7)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    out = tnet(torch.from_numpy(x))  # outside record: nothing recorded
    assert not out.requires_grad
    with pytest.raises(MXNetError):
        A.backward(loss_fn(out, torch.from_numpy(y)))
    w = tnet.collect_params()["backbone.final_ln.gamma"].data()
    frozen = torch.zeros(3, requires_grad=True)
    with A.record():
        loss = loss_fn(tnet(torch.from_numpy(x)), torch.from_numpy(y))
    gw, gz = A.grad(loss, [w, frozen], retain_graph=True)
    assert w.grad is None and torch.count_nonzero(gz) == 0
    with pytest.raises(MXNetError):
        A.grad(loss, [w], create_graph=True)
    # a (batch,) head is seeded with ones: the gradient of the sum
    A.backward(loss, retain_graph=True)
    torch.testing.assert_close(w.grad, gw)
    A.backward(loss.sum(), head_grads=torch.tensor(2.0))
    torch.testing.assert_close(w.grad, 2 * gw)


def test_dropout_follows_is_training():
    drop = tnn.Dropout(0.5)
    drop.generator = torch.Generator().manual_seed(0)
    x = torch.ones(64, 64)
    assert torch.equal(drop(x), x)
    with tmx.autograd.record(train_mode=False):
        assert torch.equal(drop(x), x)
    with tmx.autograd.record():
        y = drop(x)
        with tmx.autograd.predict_mode():
            assert torch.equal(drop(x), x)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert 0.4 < (y == 0).float().mean().item() < 0.6
    with tmx.autograd.train_mode():
        assert not torch.equal(drop(x), x)
    # no block generator: the default generator of the tensor's device,
    # live under record() and reproducible after random.seed
    drop.generator = None
    draws = []
    for _ in range(2):
        tmx.random.seed(4)
        with tmx.autograd.record():
            draws.append((drop(x), drop(x)))
    assert torch.equal(draws[0][0], draws[1][0])
    assert torch.equal(draws[0][1], draws[1][1])
    assert not torch.equal(draws[0][0], draws[0][1])
    assert set(torch.unique(draws[0][0]).tolist()) == {0.0, 2.0}


def _dense_draws(pkg, nn, seed_first, **kw):
    """Weights of a fresh Dense(3, in_units=2) initialized after
    ``random.seed(seed_first)``, then of a second fresh one."""
    pkg.random.seed(seed_first)
    out = []
    for _ in range(2):
        layer = nn.Dense(3, in_units=2, **kw)
        layer.initialize()
        w = layer.collect_params()["weight"].data()
        out.append(w.asnumpy() if hasattr(w, "asnumpy")
                   else w.detach().numpy())
    return out


def test_initialize_draws_from_the_default_generator_like_jax():
    """ROADMAP fault 6: initialize() seeded a fresh generator from 0, so it
    ignored random.seed and every block got the same draws."""
    from mxnet_tpu.gluon import nn as jnn
    for pkg, nn, kw in ((mx, jnn, {}), (tmx, tnn, {"device": "cpu"})):
        a1, a2 = _dense_draws(pkg, nn, 1, **kw)
        b1, _ = _dense_draws(pkg, nn, 2, **kw)
        c1, c2 = _dense_draws(pkg, nn, 1, **kw)
        assert not onp.array_equal(a1, b1), pkg.__name__
        assert not onp.array_equal(a1, a2), pkg.__name__
        # reproducible after the same seed
        assert onp.array_equal(a1, c1) and onp.array_equal(a2, c2)
    # an explicit seed still overrides the default generator
    w = [tnn.Dense(3, in_units=2, device="cpu").initialize(seed=5)
         .weight.detach().numpy() for _ in range(2)]
    onp.testing.assert_array_equal(w[0], w[1])


def test_dropout_zeroes_what_it_drops_like_jax():
    """ROADMAP fault 7: x * mask / (1 - rate) gave NaN at a dropped
    non-finite element, where the reference's where(keep, x/(1-p), 0)
    gives 0."""
    from mxnet_tpu.gluon import nn as jnn
    mx.random.seed(0)
    with mx.autograd.record():
        jall = jnn.Dropout(1.0)(mx.np.ones((2,))).asnumpy()
        jinf = jnn.Dropout(0.5)(mx.np.array(onp.full(64, onp.inf, "float32"))
                                ).asnumpy()
    with tmx.autograd.record():
        tall = tnn.Dropout(1.0)(torch.ones(2)).detach().numpy()
        tinf = tnn.Dropout(0.5)(torch.full((64,), float("inf"))).detach()
    onp.testing.assert_array_equal(tall, jall)
    onp.testing.assert_array_equal(tall, [0.0, 0.0])
    for got in (jinf, tinf.numpy()):
        assert set(onp.unique(got).tolist()) == {0.0, onp.inf}
        assert not onp.isnan(got).any()


@pytest.mark.parametrize("select", [".*weight", ".*layer0.*",
                                    "backbone.decoder", ".*(gamma|beta)$"])
def test_collect_params_select_matches_jax(select):
    """ROADMAP fault 8: collect_params() took no ``select``."""
    jnet, tnet = _pair()
    want = list(jnet.collect_params(select))
    got = list(tnet.collect_params(select))
    assert got and sorted(got) == sorted(want)
    assert set(got) < set(tnet.collect_params())


def test_gpt_dropout_is_live_only_under_record():
    """A GPT built with dropout is deterministic outside record() and
    equals the dropout-free model there; under record() with explicit
    generators its outputs change."""
    cfg = dict(CFG, dropout=0.1, embed_dropout=0.1)
    jnet_free, _ = _pair(8)
    tnet = tgpt.GPTForCausalLM(device="cpu", **cfg)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(
                                       jnet_free).items()})
    x = torch.from_numpy(_batch(8)[0])
    ref = jnet_free(mx.np.array(x.numpy())).asnumpy()
    onp.testing.assert_allclose(tnet(x).numpy(), ref, atol=1e-5, rtol=0)
    for i, m in enumerate(tnet.modules()):
        if hasattr(m, "generator"):
            m.generator = torch.Generator().manual_seed(i)
    with tmx.autograd.record():
        live = tnet(x)
    assert live.requires_grad
    assert not onp.allclose(live.detach().numpy(), ref, atol=1e-3)


def test_serving_leaves_every_grad_none():
    """The serve engine runs no autograd graph: after a served run every
    parameter's .grad is still None."""
    _, tnet = _pair(9)
    eng = tmx.serve.load(tnet, max_slots=2, buckets="4,8", device="cpu")
    reqs = [eng.submit([1, 2, 3], max_new_tokens=3),
            eng.submit([4, 5], max_new_tokens=2)]
    eng.run()
    assert all(r.finished for r in reqs)
    assert all(p.data().grad is None
               for p in tnet.collect_params().values())


def test_training_step_runs_attention_through_the_kernel_wrappers():
    """On the CPU the wrappers take the plain versions and count nothing;
    the autograd Function is on the path (the forward's output has its
    backward node)."""
    _, tnet = _pair(10)
    x, _ = _batch(10)
    counts = (tflash.flash_attention_fwd.launches,
              tflash.flash_attention_bwd_dkv.launches,
              tflash.flash_attention_bwd_dq.launches)
    seen = []
    orig = tflash.FlashAttentionFunction.backward

    def spy(ctx, do):
        seen.append(do.shape)
        return orig(ctx, do)
    tflash.FlashAttentionFunction.backward = staticmethod(spy)
    try:
        with tmx.autograd.record():
            out = tnet(torch.from_numpy(x))
        tmx.autograd.backward(out.sum())
    finally:
        tflash.FlashAttentionFunction.backward = staticmethod(orig)
    assert len(seen) == CFG["num_layers"]
    assert (tflash.flash_attention_fwd.launches,
            tflash.flash_attention_bwd_dkv.launches,
            tflash.flash_attention_bwd_dq.launches) == counts
